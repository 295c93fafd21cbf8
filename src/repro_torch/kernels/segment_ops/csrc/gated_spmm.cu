// Gated blocked segment-SpMM for Hopper (sm_90a): GNN feature aggregation.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/segment_ops/segment_matmul.py  gated_spmm
//   (kernel body `_kernel`).
// Plain version: repro_torch/kernels/segment_ops/ref.py.
//
// What it computes.  Edges are packed into entries of BE lanes; window w
// of VB consecutive dst vertices owns the entries
// [entry_start[w], entry_start[w+1]).  For every active window,
//     out[w*VB + r, c] = sum over the live lanes l of w's entries with
//                        dst_rel[l] == r  of  X[src[l], c]
// and every row of an inactive window is exactly 0.  A lane is live when
// valid[l] != 0; `valid` is 1 or 0 (PackedGraph), so a live lane adds
// X[src] as the plain version's valid * X[src] does, and a dead lane
// (padding, a deleted edge) is skipped where the plain version adds
// 0 * X[src]: the two differ only for non-finite X.  X is f32
// [>= num_vertices, D] and out f32 [num_vertices, D], both row-major.
//
// Design.  The TPU kernel carries a window's sum across ordered grid
// steps.  On the card blocks run in any order, a window owns from 0 to
// over a thousand entries (an R-MAT hub window), and the cost is the X
// rows gathered, one per live lane:
//   * windows are cut into chunks of at most K entries (the chunk plan,
//     repro_torch/kernels/segment_ops/plan.py, built on the device from
//     entry_start and K with no host read).  One block per (chunk,
//     column block); surplus plan slots leave at once.  Chunk 0 of a
//     window writes its rows of `out`; chunk j >= 1 of a split window
//     writes a partial VB x D tile to the scratch buffer, and a second
//     launch adds a split window's partials to its rows in chunk order;
//   * warp i of a block owns kCols consecutive columns and walks the
//     chunk's live lanes in order.  Lanes of one dst are adjacent after
//     packing, so a run of equal dst_rel is summed in registers and, when
//     dst_rel changes, stored to its row of the target (out or partial):
//     a plain store the first time the chunk meets the row, an add to
//     the stored value after that (a lane claimed later through the
//     overlay can revisit a row).  A 32-word bitmap a warp, one word a
//     thread, says which rows were met; rows never met are written as 0
//     at the end.  No shared accumulator, no atomics, no block barrier:
//     each value of the target is written by one thread in lane order,
//     so every sum has one fixed order and the result is the same bit for
//     bit from run to run;
//   * gathers: a warp finds the next live lane with a ballot over 32
//     lanes' valid (src, dst_rel and valid loaded one lane a thread, the
//     next 32 prefetched) and copies its kCols columns of the X row
//     (8 B a thread when D is even and X 8-byte aligned, else 4 B) into
//     its own slot of a ring of kRing lanes in shared memory with
//     cp.async (LDGSTS: no registers held); thread `slot` keeps the
//     slot's dst_rel in a register.  Lanes go kBatch to a step, one
//     commit group a step, and a step is consumed after
//     cp.async.wait_group leaves kRing/kBatch - 1 steps in flight, so a
//     row is read as kCols*4 contiguous bytes, (kRing - kBatch) lanes of
//     a warp are in flight, and each step's rows and values are read
//     together;
//   * the second pass takes one block per (split window, 16 rows) and
//     adds the window's partial tiles in chunk order, 8 loads ahead.
//
// Resources (D even, kCols = 320, 2 warps a block, kRing = 16, kBatch =
// 4): no static shared memory, 40,960 B of dynamic shared memory a block
// (2 x 16 x 1,280 B), 12 lanes x 1,280 B = 15,360 B of X in flight a
// warp.  On an H100 80GB HBM3 (chip_smoke.py phase 1 prints ptxas's
// `-Xptxas -v`, phase 6 gated_spmm_info): 87 registers a thread for
// 8-byte copies (56 for 4-byte), no spills, 5 blocks a SM, so up to
// 5 x 2 x 15,360 = 153,600 B of X in flight a SM.
//
// Bound.  No matrix product (each X value read is added once): bytes
// bound.  Least time = bytes / 3.35 TB/s with bytes = 8 per live lane of
// an active entry (src, dst_rel) + 4 per lane of an active entry (valid)
// + 4*D per distinct source row those lanes read + 4*D*num_vertices
// written.  The kernel reads an X row once per live lane, not once per
// distinct source (about 7x the bound's bytes at 100 % active on an R-MAT
// graph of average degree 16), as cuSPARSE's SpMM does; sharing a source
// row across destinations is later work.
//
// It launches on the caller's stream, allocates nothing and does not
// synchronise; the C entry points return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNv = 5;     // vectors of X a thread copies a lane
constexpr int kWarps = 2;  // warps a block, each its own columns
constexpr int kRing = 16;  // lane slots a warp
constexpr int kBatch = 4;  // lanes a step: one commit group
constexpr int kSteps = kRing / kBatch;  // kSteps - 1 steps in flight
constexpr int kReduceRows = 16;   // rows a block of the second pass takes
constexpr unsigned kAll = 0xffffffffu;
static_assert((kRing & (kRing - 1)) == 0 && kRing <= 32 &&
                  kRing % kBatch == 0 && kSteps >= 2,
              "kRing is a power of two, at most 32, and two steps or more");

template <int Vec>
struct VecT;
template <>
struct VecT<1> {
  using T = float;
};
template <>
struct VecT<2> {
  using T = float2;
};

__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float2 vadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
template <typename T>
__device__ __forceinline__ T vzero() {
  if constexpr (sizeof(T) == 4) {
    return 0.f;
  } else {
    return make_float2(0.f, 0.f);
  }
}

template <int Bytes>
__device__ __forceinline__ void cp_async(void* slot, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(slot));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(Bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kSteps - 1) : "memory");
}

// 32 lanes as the threads of a warp hold them, one lane a thread
struct Group {
  int src, rel;
  float gate;
};

__device__ __forceinline__ Group load_group(const int32_t* __restrict__ src,
                                            const int32_t* __restrict__ rel,
                                            const float* __restrict__ valid,
                                            long long l, long long end) {
  if (l >= end) return Group{0, 0, 0.f};
  return Group{__ldg(src + l), __ldg(rel + l), __ldg(valid + l)};
}

template <int Vec>
__host__ __device__ constexpr int ring_bytes() {  // a warp's lane slots
  return kRing * kNv * 32 * Vec * 4;
}

template <int Vec>
__global__ void __launch_bounds__(32 * kWarps)
gated_spmm_chunks(const int32_t* __restrict__ src,
                  const int32_t* __restrict__ dst_rel,
                  const float* __restrict__ valid,
                  const int32_t* __restrict__ chunk_window,
                  const int32_t* __restrict__ chunk_begin,
                  const int32_t* __restrict__ chunk_end,
                  const int32_t* __restrict__ chunk_part,
                  const uint8_t* __restrict__ active_window,
                  const float* __restrict__ x, float* __restrict__ out,
                  float* __restrict__ partial, int nw, int be, int vb,
                  int num_vertices, int d) {
  using T = typename VecT<Vec>::T;
  constexpr int kCols = kNv * 32 * Vec;  // columns a warp owns
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x;
  const int w = chunk_window[c];
  if (w >= nw) return;  // surplus slot
  const int col0 = (blockIdx.y * kWarps + warp) * kCols;
  if (col0 >= d) return;  // the whole warp is past D
  const int dv = d / Vec;            // row length in vectors
  const int v0 = col0 / Vec + lane;  // vector j of this thread: v0 + 32*j
  const int part = chunk_part[c];
  const int row0 = w * vb;
  const int rows = min(vb, num_vertices - row0);
  T* dst = reinterpret_cast<T*>(
      part < 0 ? out + static_cast<size_t>(row0) * d
               : partial + static_cast<size_t>(part) * vb * d);
  auto store_zeros = [&](int r) {
    T* o = dst + static_cast<size_t>(r) * dv;
#pragma unroll
    for (int j = 0; j < kNv; ++j) {
      if (v0 + 32 * j < dv) o[v0 + 32 * j] = vzero<T>();
    }
  };
  if (!active_window[w]) {
    if (part < 0) {
      for (int r = 0; r < rows; ++r) store_zeros(r);
    }
    return;
  }

  T* ring = reinterpret_cast<T*>(smem + warp * ring_bytes<Vec>());
  int slot_row = 0;  // the row of the lane in slot `lane`
  const T* xv = reinterpret_cast<const T*>(x);
  const long long end = static_cast<long long>(chunk_end[c]) * be;
  long long base = static_cast<long long>(chunk_begin[c]) * be;
  Group now = load_group(src, dst_rel, valid, base + lane, end);
  Group ahead = load_group(src, dst_rel, valid, base + 32 + lane, end);
  unsigned todo = __ballot_sync(kAll, now.gate != 0.f);
  int issued = 0;

  // copies the next kBatch live lanes' columns into slots issued % kRing
  // on; one commit group a call, short or empty once the chunk has no
  // live lane left
  auto issue = [&]() {
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      while (todo == 0 && base < end) {
        base += 32;
        now = ahead;
        ahead = load_group(src, dst_rel, valid, base + 32 + lane, end);
        todo = __ballot_sync(kAll, now.gate != 0.f);
      }
      if (todo) {
        const int k = __ffs(todo) - 1;
        todo &= todo - 1;
        const int s = __shfl_sync(kAll, now.src, k);
        const int slot = issued & (kRing - 1);
        const int rel = __shfl_sync(kAll, now.rel, k);
        if (slot == lane) slot_row = rel;
        const T* xr = xv + static_cast<size_t>(s) * dv;
        T* sl = ring + slot * kNv * 32 + lane;
#pragma unroll
        for (int j = 0; j < kNv; ++j) {
          if (v0 + 32 * j < dv) {
            cp_async<sizeof(T)>(sl + 32 * j, xr + v0 + 32 * j);
          }
        }
        ++issued;
      }
    }
    cp_async_commit();
  };

  unsigned met = 0;  // bit r%32 of thread r/32's word: row r was stored
  int cur = -1;      // the row of the run being summed
  T run[kNv];
#pragma unroll
  for (int j = 0; j < kNv; ++j) run[j] = vzero<T>();
  auto flush = [&]() {
    if (cur < 0) return;
    const bool seen = __shfl_sync(kAll, met, cur >> 5) >> (cur & 31) & 1u;
    if (lane == (cur >> 5)) met |= 1u << (cur & 31);
    T* o = dst + static_cast<size_t>(cur) * dv;
#pragma unroll
    for (int j = 0; j < kNv; ++j) {
      if (v0 + 32 * j < dv) {
        o[v0 + 32 * j] = seen ? vadd(o[v0 + 32 * j], run[j]) : run[j];
      }
      run[j] = vzero<T>();
    }
  };

  for (int i = 0; i < kSteps - 1; ++i) issue();
  for (int n = 0; n < issued; n += kBatch) {
    issue();          // kBatch lanes into the slots the last step left
    cp_async_wait();  // lanes n .. n+kBatch-1 have landed
    const int m = min(kBatch, issued - n);  // < kBatch only at the end
    int row[kBatch];
    T v[kBatch][kNv];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int slot = (n + b) & (kRing - 1);
      row[b] = __shfl_sync(kAll, slot_row, slot);
      const T* sl = ring + slot * kNv * 32 + lane;
#pragma unroll
      for (int j = 0; j < kNv; ++j) v[b][j] = sl[32 * j];
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (b < m) {
        if (row[b] != cur) {
          flush();
          cur = row[b];
        }
#pragma unroll
        for (int j = 0; j < kNv; ++j) run[j] = vadd(run[j], v[b][j]);
      }
    }
  }
  flush();
  // rows the chunk never met are 0
  for (int r0 = 0; r0 < rows; r0 += 32) {
    unsigned left = ~__shfl_sync(kAll, met, r0 >> 5);
    if (rows - r0 < 32) left &= (1u << (rows - r0)) - 1u;
    while (left) {
      const int b = __ffs(left) - 1;
      left &= left - 1;
      store_zeros(r0 + b);
    }
  }
}

// Second pass: out rows of split window s += its partials, in chunk order.
// Block (s, row block): kReduceRows rows, 64 threads across the columns.
__global__ void __launch_bounds__(64 * 4)
gated_spmm_reduce(const int32_t* __restrict__ split_window,
                  const int32_t* __restrict__ split_part,
                  const int32_t* __restrict__ split_count,
                  const uint8_t* __restrict__ active_window,
                  const float* __restrict__ partial, float* __restrict__ out,
                  int nw, int vb, int num_vertices, int d) {
  const int s = blockIdx.x;
  const int w = split_window[s];
  if (w >= nw || !active_window[w]) return;
  const int rows = min(vb, num_vertices - w * vb);
  const size_t stride = static_cast<size_t>(vb) * d;  // one partial tile
  const int count = split_count[s];
  for (int r = blockIdx.y * kReduceRows + threadIdx.y;
       r < min(rows, (blockIdx.y + 1) * kReduceRows); r += 4) {
    const float* p = partial +
                     (static_cast<size_t>(split_part[s]) * vb + r) * d;
    float* o = out + static_cast<size_t>(w * vb + r) * d;
    for (int col = threadIdx.x; col < d; col += 64) {
      float sum = o[col];
#pragma unroll 8
      for (int j = 0; j < count; ++j) sum += p[j * stride + col];
      o[col] = sum;
    }
  }
}

template <int Vec>
cudaError_t prepare() {
  return cudaFuncSetAttribute(gated_spmm_chunks<Vec>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kWarps * ring_bytes<Vec>());
}

template <int Vec>
cudaError_t launch_chunks(dim3 grid, cudaStream_t s, const void* src,
                          const void* dst_rel, const void* valid,
                          const void* chunk_window, const void* chunk_begin,
                          const void* chunk_end, const void* chunk_part,
                          const uint8_t* active, const void* x, void* out,
                          void* partial, int nw, int be, int vb,
                          int num_vertices, int d) {
  cudaError_t err = prepare<Vec>();
  if (err != cudaSuccess) return err;
  gated_spmm_chunks<Vec><<<grid, 32 * kWarps, kWarps * ring_bytes<Vec>(),
                           s>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst_rel),
      static_cast<const float*>(valid),
      static_cast<const int32_t*>(chunk_window),
      static_cast<const int32_t*>(chunk_begin),
      static_cast<const int32_t*>(chunk_end),
      static_cast<const int32_t*>(chunk_part), active,
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<float*>(partial), nw, be, vb, num_vertices, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gated_spmm_launch(
    int device, const void* src, const void* dst_rel, const void* valid,
    const void* chunk_window, const void* chunk_begin, const void* chunk_end,
    const void* chunk_part, const void* split_window, const void* split_part,
    const void* split_count, const void* active_window, const void* x,
    void* out, void* partial, int n_chunks, int n_splits, int nw, int be,
    int vb, int num_vertices, int d, void* stream) {
  // this library links its own CUDA runtime, whose current device is not
  // the caller's: select the tensors' device explicitly
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_chunks == 0 || d == 0) return static_cast<int>(cudaSuccess);
  if (vb > 32 * 32) return static_cast<int>(cudaErrorInvalidValue);
  // 8-byte copies need every row 8-byte aligned: D even, X aligned (out
  // and the scratch come from the caching allocator, 512-byte aligned)
  const bool pairs = d % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0;
  const int cols = kWarps * kNv * 32 * (pairs ? 2 : 1);  // a block's
  const dim3 grid(n_chunks, (d + cols - 1) / cols);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* active = static_cast<const uint8_t*>(active_window);
  err = pairs ? launch_chunks<2>(grid, s, src, dst_rel, valid, chunk_window,
                                 chunk_begin, chunk_end, chunk_part, active,
                                 x, out, partial, nw, be, vb, num_vertices,
                                 d)
              : launch_chunks<1>(grid, s, src, dst_rel, valid, chunk_window,
                                 chunk_begin, chunk_end, chunk_part, active,
                                 x, out, partial, nw, be, vb, num_vertices,
                                 d);
  if (err != cudaSuccess || n_splits == 0) return static_cast<int>(err);
  const dim3 reduce_grid(n_splits, (vb + kReduceRows - 1) / kReduceRows);
  gated_spmm_reduce<<<reduce_grid, dim3(64, 4), 0, s>>>(
      static_cast<const int32_t*>(split_window),
      static_cast<const int32_t*>(split_part),
      static_cast<const int32_t*>(split_count), active,
      static_cast<const float*>(partial), static_cast<float*>(out), nw, vb,
      num_vertices, d);
  return static_cast<int>(cudaGetLastError());
}

// info[0..4] for 8-byte copies: shared memory a block (bytes), resident
// blocks a SM, registers a thread, lanes in flight a warp, X bytes in
// flight a SM at most.
extern "C" int gated_spmm_info(int device, int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = prepare<2>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, gated_spmm_chunks<2>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, gated_spmm_chunks<2>, 32 * kWarps, kWarps * ring_bytes<2>());
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = kWarps * ring_bytes<2>();
  info[1] = blocks;
  info[2] = attr.numRegs;
  info[3] = (kSteps - 1) * kBatch;
  info[4] = blocks * kWarps * (kSteps - 1) * kBatch * kNv * 32 * 8;
  return static_cast<int>(cudaSuccess);
}
