// Walk-repair kernel for Hopper (sm_90a): re-walks stale PPR walks and
// makes each hop's threefry draws itself.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/walk_repair/walk_repair.py  resample_rows
//   (kernel body `_kernel`), together with the per-hop uniforms its caller
//   precomputed (src/repro/ppr/repair.py `_resample_kernel_impl`).
// Plain version: repro_torch/kernels/walk_repair/ref.py
//   `resample_rows_keyed_ref`.
//
// What it computes.  Each of C compacted stale walks has a stored row
// rows[c, 0..L-1] (int32 vertices, -1 once terminated), a first stale hop
// t0[c] and a walk id ids[c] (int64, taken mod 2^32).  Hop t of walk i
// draws from the index's base key K exactly as ppr/walks.py defines it:
//     hop key  h   = fold_in(fold_in(K, i), t)     fold_in(k, d) =
//                                                  threefry2x32(k, (0, d))
//     continue u_c = unit(y0 ^ y1 of threefry2x32(h, (0, 0)))
//     choice   u_j = unit(y0 ^ y1 of threefry2x32(h, (0, 1)))
//     unit(b)      = bits (b >> 9) | 0x3F800000 as f32, minus 1.0f
// and the walk keeps slots [0..t0] and re-rolls every later hop on the
// new CSR:
//     alive &= u_c < alpha
//     j      = min(int(u_j * f32(deg[cur] + 1)), deg[cur])
//     next   = cur if j == deg[cur] (the implicit self-loop)
//              else indices[clip(indptr[cur] + j, 0, E_cap - 1)]
//     out[t] = rows[t] if t <= t0 else (next if alive else -1)
//     cur    = out[t] if out[t] >= 0 else cur
// starting from alive = rows[0] >= 0, cur = max(rows[0], 0).
//
// Threefry-2x32 (Salmon et al., SC 2011; jax.random's default PRNG): 20
// rounds of add, rotate, xor with rotations (13,15,26,6)/(17,29,16,24)
// and a key injection every 4 rounds, all in uint32_t arithmetic (a
// rotate is one __funnelshift_l).  Integer arithmetic is exact, so the
// bits are those of repro_torch/kernels/walk_repair/threefry.py.
//
// Design.  The TPU kernel packs 128 walks into the lanes of one grid
// program with the uniforms precomputed and the CSR in VMEM.  Here:
//   * only the draws the recurrence reads are made.  A walk key is one
//     threefry; a hop is one fold_in and its continue draw while the walk
//     is alive, and the choice draw only past t0.  Once `alive` is false
//     every later slot is -1 and the walk stops drawing and gathering.  At
//     alpha = 0.85 and L = 16 a stale walk (stale walks are the long ones)
//     evaluates ~10 of its 15 hops: ~25 threefry calls, where drawing
//     every hop's pair up front takes 46, and none of the 455 MB of such
//     draws (C = 3.79 M) is written or read;
//   * a warp owns 32 consecutive walks, a walk a lane.  It stages their
//     rows (contiguous in `rows`) into shared memory with coalesced loads,
//     runs the hops there, and writes the rows back with coalesced
//     stores: at every hop the old kernel's 32 lanes touched 32 sectors
//     for rows[t] and 32 for out[t];
//   * a lane advances its walk by one threefry call a pass of its loop:
//     the walk key, a hop key, a continue draw or a choice draw, picked
//     by the walk's state.  All lanes run the same hash on their own
//     inputs, so the warp stays converged however far apart its walks
//     are; a lane whose walk has ended waits for the warp's longest;
//   * 32 registers and one row of L|1 words a thread (9,728 B a block of
//     128 at L = 16), so 16 blocks (64 warps) a SM are resident and the
//     block scheduler evens out the walks' lengths across warps.  Pools
//     of 2 to 8 walks a lane, handed to lanes whose walk had ended, kept
//     the lanes busy but cut the resident warps, and were slower on an
//     H100 (PERF.md §6);
//   * a hop past t0 loads deg[cur] and indptr[cur] with its hop key, so
//     they arrive during the continue draw; indices[] waits on them;
//   * a row lives at an odd stride in shared memory, so the 32 lanes of a
//     step read and write 32 different banks.
//
// Bitwise contract.  No atomics and no float sums.  The float operations
// are the uniform's exact subtraction of 1.0f and the choice's
// __int2float_rn / __fmul_rn / __float2int_rz, the IEEE operations torch
// and XLA use (no --use_fast_math, no contraction can apply).  So the
// output equals the plain version bit for bit.
//
// Bound.  ~80 integer operations a threefry call (74 of the hash, the
// draw's xor, shift, or and subtract): operations bound at the card's
// INT32 rate unless the gathers bind.  chip_smoke.py walk_repair_bound
// counts the calls this run's walks need and the bytes (kept prefix, t0,
// ids, deg/indptr/indices once per distinct entry, output) and takes
// the larger time.  At the smoke's 3.79 M stale walks (chip_smoke.py
// phase 5; NVIDIA H100 80GB HBM3, 700 W): 94.0 M calls, a bound of
// 0.45 ms (bytes: 0.13 ms); the kernel takes 1.15 ms a call, 0.92 ms of
// it on the card (PERF.md §6).
//
// It launches on the caller's stream, allocates nothing and does not
// synchronise; the C entry points return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;                  // warps a block, a walk a lane
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxLen = 100;               // slots a walk may hold
constexpr uint32_t kParity = 0x1BD11BDAu;

// the threefry call a walk makes at its next step
constexpr int kWalkKey = 0;
constexpr int kHopKey = 1;
constexpr int kContinue = 2;
constexpr int kChoice = 3;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds, of the counter (x0, x1) under key (k0, k1)
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0;
  x1 += k1;
#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r); \
  x1 ^= x0;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
#undef TF_ROUND
}

// the 23 high bits as the mantissa of a float in [1, 2), minus 1 (exact)
__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

// odd, so that lane l's slot t (word l * stride + t) is on a bank of its
// own for every t
__host__ __device__ __forceinline__ int row_stride(int max_len) {
  return max_len | 1;
}

__host__ __device__ __forceinline__ size_t smem_bytes(int max_len) {
  return static_cast<size_t>(kThreads) * row_stride(max_len) *
         sizeof(int32_t);
}

// Copy a warp's `words` row words between global memory (contiguous,
// row length max_len) and shared memory (row stride `stride`): lane l
// moves words l, l + 32, ..., so every request is 32 consecutive words.
// A const `g` is read into `s`; otherwise `s` is written out to `g`.
template <typename G>
__device__ __forceinline__ void copy_rows(G* g, int32_t* s, int words,
                                          int max_len, int stride,
                                          int lane) {
  int r = lane / max_len, c = lane % max_len;
  const int dr = 32 / max_len, dc = 32 % max_len;
  for (int k = lane; k < words; k += 32) {
    if constexpr (std::is_const<G>::value) {
      s[r * stride + c] = __ldcs(g + k);
    } else {
      __stcs(g + k, s[r * stride + c]);
    }
    r += dr;
    c += dc;
    if (c >= max_len) {
      c -= max_len;
      ++r;
    }
  }
}

// Walk one stale walk whose row (in shared memory) is `row`: keep slots
// [0..keep], re-roll the later ones, drawing only what the recurrence
// reads.  Each pass of the loop makes one threefry call, so the lanes of a
// warp run the same hash together whatever their walks' states.
__device__ __forceinline__ void resample_walk(
    int32_t* row, int keep, uint32_t id, const int32_t* __restrict__ indptr,
    const int32_t* __restrict__ indices, const int32_t* __restrict__ deg,
    int max_len, int num_edges, uint32_t key0, uint32_t key1, float alpha) {
  if (keep >= max_len - 1) return;                 // every slot is kept
  int32_t cur = row[0];
  if (cur < 0) {
    // not alive from the start: past t0 every slot is -1
    for (int s = keep + 1 > 1 ? keep + 1 : 1; s < max_len; ++s) row[s] = -1;
    return;
  }
  int step = kWalkKey, t = 1;
  uint32_t wk0 = 0u, wk1 = 0u, hk0 = 0u, hk1 = 0u;
  int32_t d = 0, p = 0;                            // deg[cur], indptr[cur]
  for (;;) {
    uint32_t k0 = hk0, k1 = hk1, c1 = step == kChoice ? 1u : 0u;
    if (step == kWalkKey) {
      k0 = key0;
      k1 = key1;
      c1 = id;
    } else if (step == kHopKey) {
      k0 = wk0;
      k1 = wk1;
      c1 = static_cast<uint32_t>(t);
    }
    uint32_t x0 = 0u, x1 = c1;
    threefry2x32(k0, k1, x0, x1);
    if (step == kWalkKey) {
      wk0 = x0;
      wk1 = x1;
      step = kHopKey;
      continue;
    }
    if (step == kHopKey) {
      hk0 = x0;
      hk1 = x1;
      step = kContinue;
      if (t > keep) {
        // the choice's first gathers, in flight during the continue draw
        d = __ldg(deg + cur);
        p = __ldg(indptr + cur);
      }
      continue;
    }
    const float u = unit_float(x0 ^ x1);
    if (step == kContinue) {
      const bool alive = u < alpha;
      if (t <= keep) {
        const int32_t v = row[t];                  // a kept slot
        if (v >= 0) cur = v;
        if (!alive) {
          for (int s = keep + 1; s < max_len; ++s) row[s] = -1;
          return;
        }
        if (++t == max_len) return;
        step = kHopKey;
      } else if (alive) {
        step = kChoice;
      } else {
        for (int s = t; s < max_len; ++s) row[s] = -1;
        return;
      }
    } else {                                       // kChoice: t > keep
      int32_t j = __float2int_rz(__fmul_rn(u, __int2float_rn(d + 1)));
      j = j < d ? j : d;
      int32_t v = cur;
      if (j < d) {
        int32_t idx = p + j;
        idx = idx < 0 ? 0 : (idx > num_edges - 1 ? num_edges - 1 : idx);
        v = __ldg(indices + idx);
      }
      row[t] = v;
      if (v >= 0) cur = v;
      if (++t == max_len) return;
      step = kHopKey;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
walk_repair_kernel(const int32_t* __restrict__ indptr,
                   const int32_t* __restrict__ indices,
                   const int32_t* __restrict__ deg,
                   const int32_t* __restrict__ rows,
                   const int32_t* __restrict__ t0,
                   const long long* __restrict__ ids,
                   int32_t* __restrict__ out, int num_walks, int max_len,
                   int num_edges, uint32_t key0, uint32_t key1,
                   float alpha) {
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int stride = row_stride(max_len);
  int32_t* srow = smem + warp * 32 * stride;
  const long long base =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * 32;
  if (base >= num_walks) return;                      // warp-uniform
  const int count =
      static_cast<int>(min(32LL, static_cast<long long>(num_walks) - base));

  copy_rows(rows + base * max_len, srow, count * max_len, max_len, stride,
            lane);
  __syncwarp();
  if (lane < count) {
    // the walk's id, mod 2^32
    const uint32_t id = static_cast<uint32_t>(__ldcs(ids + base + lane));
    resample_walk(srow + lane * stride, __ldcs(t0 + base + lane), id, indptr,
                  indices, deg, max_len, num_edges, key0, key1, alpha);
  }
  __syncwarp();
  copy_rows(out + base * max_len, srow, count * max_len, max_len, stride,
            lane);
}

cudaError_t set_smem(int max_len) {
  const size_t bytes = smem_bytes(max_len);
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(walk_repair_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" int walk_repair_launch(int device, const void* indptr,
                                  const void* indices, const void* deg,
                                  const void* rows, const void* t0,
                                  const void* ids, void* out, int num_walks,
                                  int max_len, int num_edges,
                                  unsigned int key0, unsigned int key1,
                                  float alpha, void* stream) {
  // this library links its own CUDA runtime, whose current device is not
  // the caller's: select the tensors' device explicitly
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (max_len > kMaxLen) return static_cast<int>(cudaErrorInvalidValue);
  if (num_walks > 0 && max_len > 1) {
    err = set_smem(max_len);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = (num_walks + kThreads - 1) / kThreads;
    walk_repair_kernel<<<blocks, kThreads, smem_bytes(max_len),
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(indptr),
        static_cast<const int32_t*>(indices),
        static_cast<const int32_t*>(deg), static_cast<const int32_t*>(rows),
        static_cast<const int32_t*>(t0),
        static_cast<const long long*>(ids), static_cast<int32_t*>(out),
        num_walks, max_len, num_edges, key0, key1, alpha);
  }
  return static_cast<int>(cudaGetLastError());
}

// info[0..5] at this walk length: dynamic shared memory a block (bytes),
// resident blocks a SM, registers a thread, the SMs, walks a block, and
// the longest walk the kernel takes.
extern "C" int walk_repair_info(int device, int max_len, int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (max_len < 2 || max_len > kMaxLen)
    return static_cast<int>(cudaErrorInvalidValue);
  err = set_smem(max_len);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, walk_repair_kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, walk_repair_kernel, kThreads, smem_bytes(max_len));
  int sms = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = static_cast<int>(smem_bytes(max_len));
  info[1] = blocks;
  info[2] = attr.numRegs;
  info[3] = sms;
  info[4] = kThreads;
  info[5] = kMaxLen;
  return static_cast<int>(cudaSuccess);
}
