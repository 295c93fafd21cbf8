// Fixed-order f64 pull sum for Hopper (sm_90a): the contributions of the
// f64 PageRank loop, c[v] = sum over live in-edges (u, v) of R[u] / d_u.
//
// The port's own kernel: it replaces no Pallas kernel.  It replaces the
// f64 `index_add_` of repro_torch/core/pagerank.py `_contrib`, whose CUDA
// form adds with atomics in an order that changes from run to run, so
// the served ranks did too.
// Plain version: repro_torch/kernels/pull_contrib/ref.py
//   `pull_contrib_ref`.
//
// What it computes.  The solve sorts the edge slots once by dst (stable,
// live slots first: `pull_order`), giving each vertex v the segment
// [ptr[v], ptr[v+1]) of sorted slots and their sources src[k].  Each call
//     out[v] = ((0.0 + w_0) + w_1) + ...,   w_k = ranks[s] * inv[s],
//     s = src[k]
// over v's segment in slot order: each product one IEEE f64 multiply,
// the sum the segment's terms added one at a time from +0.0.  That is
// what the CPU `index_add_` of the old `_contrib` computes (it walks the
// slots in order), so the card's sum equals the CPU's bit for bit and is
// the same from run to run.
//
// Design.  A warp owns a vertex.  Its lanes load 4 rounds of 32 slots at
// a time (src coalesced, ranks and inv gathered) and form the products;
// the warp then adds them in slot order, the 32 terms of a round passed
// to every lane with __shfl_sync, while the next 4 rounds' loads are in
// flight.  The one chain of dependent adds a segment needs is the floor:
// the hub's in-degree sets the time of a call.  No atomics.  Measured on an
// H100 (PERF.md §6): 4-warp blocks beat 8; 2 or 8 rounds at a time, or all
// 32 terms of a round shuffled before the adds (97-111 registers), were
// slower.
//
// Bitwise contract.  __dmul_rn and __dadd_rn, so no multiply-add is
// contracted into an FMA; no --use_fast_math.
//
// Bound.  A gather and a sum: bytes bound on paper (ptr, the live slots'
// src, ranks and inv once per distinct source, the output; 2 f64
// operations a live slot), latency bound by the longest segment's chain
// in practice (chip_smoke.py pull_contrib_bound).  At R-MAT 2^21 (phase
// 3b; NVIDIA H100 80GB HBM3, 700 W): 1.09 ms a call against a 0.05 ms
// bound, of which the hub's chain of 62,458 adds alone takes 0.89 ms;
// `index_add_` of the same products takes 29.5 ms.
//
// It launches on the caller's stream, allocates nothing and does not
// synchronise; the C entry points return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                 // vertices a block
constexpr int kThreads = 32 * kWarps;
constexpr int kRounds = 4;                // 32-slot rounds loaded at once
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ double term(const int32_t* __restrict__ src,
                                       const double* __restrict__ ranks,
                                       const double* __restrict__ inv,
                                       int k, int end) {
  if (k >= end) return 0.0;
  const int32_t s = __ldcs(src + k);
  return __dmul_rn(__ldg(ranks + s), __ldg(inv + s));
}

// acc + w[0] + ... + w[n-1] of lane i's w[i], in lane order
__device__ __forceinline__ double fold(double acc, double w, int n) {
  if (n == 32) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      acc = __dadd_rn(acc, __shfl_sync(kAll, w, i));
  } else {
    for (int i = 0; i < n; ++i)
      acc = __dadd_rn(acc, __shfl_sync(kAll, w, i));
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
pull_contrib_kernel(const int32_t* __restrict__ ptr,
                    const int32_t* __restrict__ src,
                    const double* __restrict__ ranks,
                    const double* __restrict__ inv,
                    double* __restrict__ out, int num_vertices) {
  const int lane = threadIdx.x & 31;
  const int v = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (v >= num_vertices) return;                     // warp-uniform
  const int begin = __ldg(ptr + v), end = __ldg(ptr + v + 1);
  double w[kRounds];
#pragma unroll
  for (int q = 0; q < kRounds; ++q)
    w[q] = term(src, ranks, inv, begin + 32 * q + lane, end);
  double acc = 0.0;
  for (int base = begin; base < end; base += 32 * kRounds) {
    // the next rounds' terms, in flight while these are added
    double wn[kRounds];
#pragma unroll
    for (int q = 0; q < kRounds; ++q)
      wn[q] = term(src, ranks, inv, base + 32 * (kRounds + q) + lane, end);
#pragma unroll
    for (int q = 0; q < kRounds; ++q) {
      const int n = end - (base + 32 * q);
      if (n <= 0) break;
      acc = fold(acc, w[q], n < 32 ? n : 32);
    }
#pragma unroll
    for (int q = 0; q < kRounds; ++q) w[q] = wn[q];
  }
  if (lane == 0) out[v] = acc;
}

}  // namespace

extern "C" int pull_contrib_launch(int device, const void* ptr,
                                   const void* src, const void* ranks,
                                   const void* inv, void* out,
                                   int num_vertices, void* stream) {
  // this library links its own CUDA runtime, whose current device is not
  // the caller's: select the tensors' device explicitly
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_vertices > 0) {
    const int blocks = (num_vertices + kWarps - 1) / kWarps;
    pull_contrib_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(ptr), static_cast<const int32_t*>(src),
        static_cast<const double*>(ranks), static_cast<const double*>(inv),
        static_cast<double*>(out), num_vertices);
  }
  return static_cast<int>(cudaGetLastError());
}

// info[0..3]: registers a thread, resident blocks a SM, the SMs, and
// threads a block.
extern "C" int pull_contrib_info(int device, int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, pull_contrib_kernel);
  int blocks = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, pull_contrib_kernel, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = blocks;
  info[2] = sms;
  info[3] = kThreads;
  return static_cast<int>(cudaSuccess);
}
