// Frontier-gated blocked SpMV for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/pagerank_spmv/pagerank_spmv.py  frontier_spmv_padded
//   (kernel body `_kernel`, wrapper `frontier_spmv`).
// Plain versions: repro_torch/kernels/pagerank_spmv/ref.py
// (`frontier_spmv_ref_padded`, and `frontier_spmv_split_ref`, which sums
// in this kernel's chunk and partial order).
//
// What it computes.  Edges are packed into entries of BE lanes; window w
// of VB consecutive dst vertices owns the entries
// [entry_start[w], entry_start[w+1]).  For every active window,
//     out[w*VB + r] = sum over the lanes l of w's entries with
//                     dst_rel[l] == r  of  rsc[src[l]] * valid[l]
// and out is exactly 0 in every inactive window.  rsc is f32 or bf16
// (widened with __bfloat162float); sums are f32.  A lane whose valid is 0
// (padding, a deleted edge) is skipped: its src and dst_rel are not read.
//
// Design.  The TPU kernel compacts the active entries with scalar
// prefetch and carries a window's sum across ordered grid steps.  On the
// card blocks run in any order, a window owns from 1 to tens of thousands
// of entries (the capacity tail belongs to the last window), and most of
// the time goes to reading `valid` and the live lanes' src and dst_rel:
//   * windows are cut into chunks of at most K entries (the chunk plan,
//     repro_torch/kernels/segment_ops/plan.py, built on the device from
//     entry_start and K with no host read, and cached per packed
//     structure).  Chunk 0 of a window writes all VB rows of the window:
//     its sums, zeros for rows it never met, and zeros for an inactive
//     window, so nothing needs a memset.  Chunk j >= 1 of a split window
//     writes a partial VB-row to scratch and a flag that says whether it
//     met a live lane; chunks j >= 1 of inactive windows and surplus plan
//     slots do nothing.  A second launch adds each active split window's
//     flagged partials to its rows in chunk order;
//   * both launches run one resident wave of blocks that walk the plan's
//     slots with a stride of the grid.  A block stages the window, part,
//     entry range and activity of its next 256 slots in shared memory with
//     one load a thread, so the many slots that hold no work (inactive
//     windows) cost no chain of dependent loads;
//   * a chunk's lanes are one contiguous range.  Warp i of a block takes
//     tiles of kTile lanes i, i + kWarps, ... of it; a tile is kSteps steps
//     of 32 lanes, one lane a thread, loaded with coalesced 4-byte loads:
//     first `valid`, then src and dst_rel of the live lanes only (a tile of
//     padding reads nothing more), then the rsc gathers.  The three
//     streamed arrays are read once a call, with evict-first loads
//     (`__ldcs`), so that they push fewer of the gathered rsc lines out of
//     L2;
//   * a step is added into the warp's own VB-float row of shared memory
//     without atomics: runs of equal dst_rel in adjacent lanes are summed
//     by a segmented scan over the warp (shuffles, a fixed tree), and the
//     run's last lane adds the sum to its row.  When the rows of those
//     lanes rise in lane order (lanes are dst-sorted at pack time) they
//     are all different and add at once; otherwise (a lane claimed through
//     the overlay, a hole from a deletion inside a run) they add one at a
//     time in lane order.  At the end of the chunk the block adds the
//     warps' rows in warp order.
//
// Resources (kWarps = 8, kSteps = 8, K = 16 in the wrapper): 256 threads a
// block, 8 * VB * 4 B of dynamic shared memory (8,192 B at VB = 256) +
// 5,120 B of staged plan slots; VB <= 1,024.  On an H100 80GB HBM3
// (chip_smoke.py phase 3, `frontier_spmv_info`): 64 registers a thread,
// 4 blocks a SM, so a grid of 528 blocks at the serve engine's shapes
// (14,693 plan slots, 13,085 real chunks); the second pass 32 registers,
// 19,488 B of static shared memory, 528 blocks for 6,118 split slots.
// Measured there and not kept: a deeper pipeline (the next tile's
// `valid`, src and dst_rel in flight during the scan), L2 prefetches of a
// chunk's lines, 16-step tiles, 4-warp blocks, K = 8, 12, 24, 32 or 64,
// an L2 evict-last hint on the gathers and gathers that skip L1 were no
// faster at 100 % active (PERF.md §6).
//
// Bound.  A gather plus a segmented sum, no matrix product: bytes bound.
// Least time = bytes / 3.35 TB/s with bytes = 4 per lane of an active
// entry (valid) + 8 per live lane of an active entry (src, dst_rel) +
// 4 per entry (window) + NW (active_window) + one rsc element per distinct
// source gathered + 4*NW*VB written.  The rsc gathers go through L2
// (8 MB in f32 at 2^21 vertices) at one 32-byte sector a live lane.
//
// Determinism.  No atomics: every output value is summed by one thread
// block in one order (the steps of each warp in lane order, the warps'
// rows in warp order, then a split window's partials in chunk order)
// that does not depend on scheduling, so the result is the same bit for
// bit from run to run, f32 and bf16 alike.  It agrees with the plain
// versions to f32 summation-order error.
//
// It launches on the caller's stream, allocates nothing and does not
// synchronise; the C entry points return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // warps a block of the chunk pass
constexpr int kThreads = 32 * kWarps;
constexpr int kSteps = 8;                 // 32-lane steps a tile
constexpr int kTile = 32 * kSteps;        // lanes a warp loads at once
constexpr int kMaxVb = 1024;              // rows a window may hold
constexpr int kFlags = 16;                // partial flags a thread reads
constexpr int kReduceBlocksPerSm = 4;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float load_rank(const float* __restrict__ p,
                                           int32_t i) {
  return __ldg(p + i);
}

__device__ __forceinline__ float load_rank(
    const __nv_bfloat16* __restrict__ p, int32_t i) {
  return __bfloat162float(p[i]);
}

// The plan slots a block takes next, one a thread: slot c0 + i * stride.
struct Staged {
  int window[kThreads];  // nw: surplus (every later slot is surplus too)
  int part[kThreads];    // -1: chunk 0; else the partial slot
  int begin[kThreads];
  int end[kThreads];
  int active[kThreads];
};

// Adds one step of 32 lanes (lane `lane` of the warp holds one) into the
// warp's row `acc`: x = rsc[src] * valid, 0 for a dead lane.
__device__ __forceinline__ void add_step(float* acc, bool live, int rel,
                                         float x, int lane) {
  const int key = live ? rel : -1 - lane;  // a dead lane is a run alone
  const int up = __shfl_up_sync(kAll, key, 1);
  const unsigned heads = __ballot_sync(kAll, lane == 0 || up != key);
  const int first = 31 - __clz(heads & (kAll >> (31 - lane)));
  float sum = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(kAll, sum, off);
    if (lane - off >= first) sum += y;
  }
  // the last lane of each live run adds the run's sum to its row
  const bool last = lane == 31 || ((heads >> (lane + 1)) & 1u);
  const bool writer = live && last;
  const unsigned writers = __ballot_sync(kAll, writer);
  const unsigned below = writers & ((1u << lane) - 1u);
  const int prev = __shfl_sync(kAll, key, below ? 31 - __clz(below) : lane);
  if (__all_sync(kAll, !writer || !below || prev < key)) {
    if (writer) acc[key] += sum;  // rows rise in lane order: all distinct
  } else {
    for (unsigned left = writers; left; left &= left - 1) {
      if (lane == __ffs(left) - 1) acc[key] += sum;
      __syncwarp();
    }
  }
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
spmv_chunks(const int32_t* __restrict__ src,
            const int32_t* __restrict__ dst_rel,
            const float* __restrict__ valid,
            const int32_t* __restrict__ chunk_window,
            const int32_t* __restrict__ chunk_begin,
            const int32_t* __restrict__ chunk_end,
            const int32_t* __restrict__ chunk_part,
            const uint8_t* __restrict__ active_window,
            const T* __restrict__ rsc, float* __restrict__ out,
            float* __restrict__ partial, uint8_t* __restrict__ part_live,
            int n_chunks, int nw, int be, int vb) {
  extern __shared__ float rows[];  // kWarps rows of VB floats
  __shared__ Staged st;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* acc = rows + warp * vb;
  const long long stride = gridDim.x;
  for (long long c0 = blockIdx.x; c0 < n_chunks; c0 += stride * kThreads) {
    {
      const long long c = c0 + threadIdx.x * stride;
      int w = nw, part = -1, b = 0, e = 0, act = 0;
      if (c < n_chunks) {
        w = chunk_window[c];
        if (w < nw) {
          part = chunk_part[c];
          b = chunk_begin[c];
          e = chunk_end[c];
          act = active_window[w];
        }
      }
      st.window[threadIdx.x] = w;
      st.part[threadIdx.x] = part;
      st.begin[threadIdx.x] = b;
      st.end[threadIdx.x] = e;
      st.active[threadIdx.x] = act;
    }
    __syncthreads();
    for (int i = 0; i < kThreads; ++i) {
      const int w = st.window[i];
      if (w >= nw) break;  // surplus slots are the plan's suffix
      const int part = st.part[i];
      if (!st.active[i]) {
        if (part < 0) {
          for (int r = threadIdx.x; r < vb; r += kThreads) {
            out[static_cast<size_t>(w) * vb + r] = 0.f;
          }
        }
        continue;
      }
      for (int r = lane; r < vb; r += 32) acc[r] = 0.f;
      __syncwarp();
      const long long hi = static_cast<long long>(st.end[i]) * be;
      long long t = static_cast<long long>(st.begin[i]) * be + warp * kTile;
      bool met = false;
      for (; t < hi; t += kWarps * kTile) {
        float v[kSteps];
        bool any = false;
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
          const long long l = t + 32 * j + lane;
          v[j] = l < hi ? __ldcs(valid + l) : 0.f;
          any |= v[j] != 0.f;
        }
        if (!__any_sync(kAll, any)) continue;  // padding: src is not read
        met = true;
        int s[kSteps], rel[kSteps];
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
          const long long l = t + 32 * j + lane;
          s[j] = 0;
          rel[j] = 0;
          if (v[j] != 0.f) {
            s[j] = __ldcs(src + l);
            rel[j] = __ldcs(dst_rel + l);
          }
        }
        float x[kSteps];
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
          x[j] = v[j] != 0.f ? load_rank(rsc, s[j]) * v[j] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
          if (__any_sync(kAll, v[j] != 0.f)) {
            add_step(acc, v[j] != 0.f, rel[j], x[j], lane);
          }
        }
      }
      const bool live = __syncthreads_or(met);
      if (part < 0 || live) {
        float* dst = part < 0 ? out + static_cast<size_t>(w) * vb
                              : partial + static_cast<size_t>(part) * vb;
        for (int r = threadIdx.x; r < vb; r += kThreads) {
          float sum = rows[r];
#pragma unroll
          for (int k = 1; k < kWarps; ++k) sum += rows[k * vb + r];
          dst[r] = sum;
        }
      }
      if (part >= 0 && threadIdx.x == 0) part_live[part] = live;
      __syncthreads();  // the rows are read before the next chunk zeroes
    }
    __syncthreads();  // the staged slots are read before the next staging
  }
}

// Second pass: the rows of each active split window += its partials that
// met a live lane, in chunk order.  One block a split window at a time;
// the flags are read kFlags a thread and compacted by a block scan.
__global__ void __launch_bounds__(kThreads)
spmv_partials(const int32_t* __restrict__ split_window,
              const int32_t* __restrict__ split_part,
              const int32_t* __restrict__ split_count,
              const uint8_t* __restrict__ active_window,
              const uint8_t* __restrict__ part_live,
              const float* __restrict__ partial, float* __restrict__ out,
              int n_splits, int nw, int vb) {
  __shared__ int live_idx[kThreads * kFlags];
  __shared__ int warp_total[kWarps];
  __shared__ int s_window[kThreads], s_part[kThreads], s_count[kThreads];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long stride = gridDim.x;
  for (long long s0 = blockIdx.x; s0 < n_splits; s0 += stride * kThreads) {
    {
      const long long s = s0 + threadIdx.x * stride;
      int w = nw, p0 = 0, count = 0;
      if (s < n_splits) {
        w = split_window[s];
        if (w < nw) {
          if (active_window[w]) {
            p0 = split_part[s];
            count = split_count[s];
          } else {
            w = -1;  // inactive: nothing to add
          }
        }
      }
      s_window[threadIdx.x] = w;
      s_part[threadIdx.x] = p0;
      s_count[threadIdx.x] = count;
    }
    __syncthreads();
    for (int i = 0; i < kThreads; ++i) {
      const int w = s_window[i];
      if (w >= nw) break;  // surplus slots are the plan's suffix
      if (w < 0) continue;
      const int p0 = s_part[i], count = s_count[i];
      for (int base = 0; base < count; base += kThreads * kFlags) {
        const int first = base + threadIdx.x * kFlags;
        unsigned bits = 0;
#pragma unroll
        for (int f = 0; f < kFlags; ++f) {
          if (first + f < count && part_live[p0 + first + f]) bits |= 1u << f;
        }
        const int mine = __popc(bits);
        int incl = mine;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int y = __shfl_up_sync(kAll, incl, off);
          if (lane >= off) incl += y;
        }
        if (lane == 31) warp_total[warp] = incl;
        __syncthreads();
        int at = incl - mine, total = 0;
        for (int k = 0; k < kWarps; ++k) {
          if (k < warp) at += warp_total[k];
          total += warp_total[k];
        }
        for (; bits; bits &= bits - 1) {
          live_idx[at++] = p0 + first + __ffs(bits) - 1;
        }
        __syncthreads();
        for (int r = threadIdx.x; r < vb; r += kThreads) {
          float* o = out + static_cast<size_t>(w) * vb + r;
          float sum = *o;
#pragma unroll 8
          for (int k = 0; k < total; ++k) {
            sum += partial[static_cast<size_t>(live_idx[k]) * vb + r];
          }
          *o = sum;
        }
        __syncthreads();  // live_idx and warp_total are reused
      }
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t resident_blocks(int vb, int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, spmv_chunks<T>, kThreads,
      static_cast<size_t>(kWarps) * vb * sizeof(float));
}

// The chunk pass's resident blocks a SM on a device for one VB and rsc
// type, asked of the runtime once and then kept (the serve loop calls the
// kernel at one VB)
struct Residency {
  int vb = 0, blocks = 0;
};
Residency g_resident[64][2];

template <typename T>
cudaError_t cached_resident_blocks(int device, int vb, int* blocks) {
  if (device < 0 || device >= 64) return resident_blocks<T>(vb, blocks);
  Residency& r = g_resident[device][sizeof(T) == 2];
  if (r.vb != vb) {
    const cudaError_t err = resident_blocks<T>(vb, &r.blocks);
    if (err != cudaSuccess) return err;
    r.vb = vb;
  }
  *blocks = r.blocks;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(int device, int sms, cudaStream_t s, const void* src,
                   const void* dst_rel, const void* valid,
                   const void* chunk_window, const void* chunk_begin,
                   const void* chunk_end, const void* chunk_part,
                   const void* split_window, const void* split_part,
                   const void* split_count, const uint8_t* active,
                   const void* rsc, void* out, void* partial,
                   void* part_live, int n_chunks, int n_splits, int nw,
                   int be, int vb) {
  int per_sm = 0;
  cudaError_t err = cached_resident_blocks<T>(device, vb, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = n_chunks < per_sm * sms ? n_chunks : per_sm * sms;
  uint8_t* flags = static_cast<uint8_t*>(part_live);
  spmv_chunks<T><<<grid, kThreads,
                   static_cast<size_t>(kWarps) * vb * sizeof(float), s>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst_rel),
      static_cast<const float*>(valid),
      static_cast<const int32_t*>(chunk_window),
      static_cast<const int32_t*>(chunk_begin),
      static_cast<const int32_t*>(chunk_end),
      static_cast<const int32_t*>(chunk_part), active,
      static_cast<const T*>(rsc), static_cast<float*>(out),
      static_cast<float*>(partial), flags, n_chunks, nw, be, vb);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 0) return err;
  const int cap = kReduceBlocksPerSm * sms;
  spmv_partials<<<n_splits < cap ? n_splits : cap, kThreads, 0, s>>>(
      static_cast<const int32_t*>(split_window),
      static_cast<const int32_t*>(split_part),
      static_cast<const int32_t*>(split_count), active, flags,
      static_cast<const float*>(partial), static_cast<float*>(out),
      n_splits, nw, vb);
  return cudaGetLastError();
}

// SMs of each device, read once (0: not read yet)
int g_sms[64] = {};

int sm_count(int device) {
  if (device < 0 || device >= 64) return 0;
  if (g_sms[device] == 0 &&
      cudaDeviceGetAttribute(&g_sms[device], cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess) {
    g_sms[device] = 0;
  }
  return g_sms[device];
}

}  // namespace

extern "C" int frontier_spmv_launch(
    int device, const void* src, const void* dst_rel, const void* valid,
    const void* chunk_window, const void* chunk_begin, const void* chunk_end,
    const void* chunk_part, const void* split_window, const void* split_part,
    const void* split_count, const void* active_window, const void* rsc,
    int rsc_is_bf16, void* out, void* partial, void* part_live,
    int n_chunks, int n_splits, int nw, int be, int vb, void* stream) {
  // this library links its own CUDA runtime, whose current device is not
  // the caller's: select the tensors' device explicitly
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_chunks == 0) return static_cast<int>(cudaSuccess);
  if (vb < 1 || vb > kMaxVb) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count(device);
  if (sms < 1) return static_cast<int>(cudaErrorInvalidDevice);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* active = static_cast<const uint8_t*>(active_window);
  err = rsc_is_bf16
            ? launch<__nv_bfloat16>(device, sms, s, src, dst_rel, valid,
                                    chunk_window, chunk_begin, chunk_end,
                                    chunk_part, split_window, split_part,
                                    split_count, active, rsc, out, partial,
                                    part_live, n_chunks, n_splits, nw, be,
                                    vb)
            : launch<float>(device, sms, s, src, dst_rel, valid, chunk_window,
                            chunk_begin, chunk_end, chunk_part, split_window,
                            split_part, split_count, active, rsc, out,
                            partial, part_live, n_chunks, n_splits, nw, be,
                            vb);
  return static_cast<int>(err);
}

// info[0..7] for f32 rsc at this VB: dynamic shared memory a block of the
// chunk pass (bytes), its static shared memory, resident blocks a SM,
// registers a thread, the SMs, registers a thread of the second pass, the
// largest VB the kernel takes, and the second pass's blocks a SM.
extern "C" int frontier_spmv_info(int device, int vb, int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes chunks, parts;
  err = cudaFuncGetAttributes(&chunks, spmv_chunks<float>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&parts, spmv_partials);
  int blocks = 0;
  if (err == cudaSuccess) err = resident_blocks<float>(vb, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = kWarps * vb * static_cast<int>(sizeof(float));
  info[1] = static_cast<int>(chunks.sharedSizeBytes);
  info[2] = blocks;
  info[3] = chunks.numRegs;
  info[4] = sm_count(device);
  info[5] = parts.numRegs;
  info[6] = kMaxVb;
  info[7] = kReduceBlocksPerSm;
  return static_cast<int>(cudaSuccess);
}
