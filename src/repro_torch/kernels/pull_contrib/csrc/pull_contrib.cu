// Fixed-order pull sums for Hopper (sm_90a).
//
// `pull_contrib`: f64 sums over sorted edge slots, the contributions of
// the f64 PageRank loop, c[v] = sum over live in-edges (u, v) of R[u] / d_u,
// or with a per-slot weight w of (R[u] * w) / W_u (weighted PageRank), and
// the other f64 segment sums of the port (PPR visit counts, weighted
// degrees).  `pull_rows`: its row variant, f32 neighbour-row sums for
// GraphSAGE (below the f64 kernel).
//
// The port's own kernels: they replace no Pallas kernel.  `pull_contrib`
// replaces the f64 `index_add_`s of repro_torch/core/pagerank.py
// `_contrib`, core/extensions.py, ppr/query.py and graph/structure.py
// `push`, whose CUDA form adds with atomics in an order that changes from
// run to run, so the served ranks did too.
// Plain version: repro_torch/kernels/pull_contrib/ref.py
//   `pull_contrib_ref`.
//
// What it computes.  The solve sorts the edge slots once by dst (stable,
// live slots first: `pull_order`), giving each vertex v the segment
// [ptr[v], ptr[v+1]) of sorted slots and their sources src[k].  Each call
//     out[v] = ((0.0 + w_0) + w_1) + ...,   w_k = ranks[s] * inv[s],
//     s = src[k]
// over v's segment in slot order: each product one IEEE f64 multiply
// (with a weight, w_k = (ranks[s] * weight[k]) * inv[s], two), the sum the
// segment's terms added one at a time from +0.0.  That is
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
// `index_add_` of the same products takes 29.5 ms.  With weights: 1.30 ms
// against a 0.13 ms bound (the weights' 8 bytes a live slot).
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

// the term of sorted slot k: ranks[s] * inv[s], or with a weight
// (ranks[s] * weight[k]) * inv[s]
template <bool kWeighted>
__device__ __forceinline__ double term(const int32_t* __restrict__ src,
                                       const double* __restrict__ ranks,
                                       const double* __restrict__ inv,
                                       const double* __restrict__ weight,
                                       int k, int end) {
  if (k >= end) return 0.0;
  const int32_t s = __ldcs(src + k);
  if (kWeighted)
    return __dmul_rn(__dmul_rn(__ldg(ranks + s), __ldcs(weight + k)),
                     __ldg(inv + s));
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

template <bool kWeighted>
__global__ void __launch_bounds__(kThreads)
pull_contrib_kernel(const int32_t* __restrict__ ptr,
                    const int32_t* __restrict__ src,
                    const double* __restrict__ ranks,
                    const double* __restrict__ inv,
                    const double* __restrict__ weight,
                    double* __restrict__ out, int num_vertices) {
  const int lane = threadIdx.x & 31;
  const int v = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (v >= num_vertices) return;                     // warp-uniform
  const int begin = __ldg(ptr + v), end = __ldg(ptr + v + 1);
  double w[kRounds];
#pragma unroll
  for (int q = 0; q < kRounds; ++q)
    w[q] = term<kWeighted>(src, ranks, inv, weight, begin + 32 * q + lane,
                           end);
  double acc = 0.0;
  for (int base = begin; base < end; base += 32 * kRounds) {
    // the next rounds' terms, in flight while these are added
    double wn[kRounds];
#pragma unroll
    for (int q = 0; q < kRounds; ++q)
      wn[q] = term<kWeighted>(src, ranks, inv, weight,
                              base + 32 * (kRounds + q) + lane, end);
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

// ---------------------------------------------------------------------------
// pull_rows: out[v, :] = sum over v's sorted slots k of x[src[k], :], f32.
//
// The row variant of the sum above, for GraphSAGE's neighbour sums
// (repro_torch/models/gnn.py `neighbor_sum`; it replaces that function's
// f32 `index_add_`, whose CUDA atomics added in an order that changed from
// run to run).  Plain version: ref.py `pull_rows_ref`.
//
// A vertex's segment is cut into chunks of at most K slots by the chunk
// plan of repro_torch/kernels/segment_ops/plan.py (windows = vertices,
// entries = sorted slots), so a hub (62,458 in-edges of 602 floats at the
// smoke's size) is walked by ~1,000 warps, not one.  One warp a chunk;
// lane i owns columns i, i + 32, ..., 32 * kCols - 32 + i of a pass of
// 32 * kCols columns, passes until the row's D columns are done.  The
// warp walks its chunk's slots in order, 4 rows' loads in flight before
// their adds, each column summed in slot order from +0.0 (__fadd_rn, no
// FMA).  Chunk 0 of a vertex writes its row of `out`; chunk j >= 1 of a
// split vertex writes a partial row to scratch, and a second launch adds
// a split vertex's partial rows to its row in chunk order.  No atomics:
// the result is the same bit for bit from run to run, and equals the
// plain version's sum on the CPU (whose index_add_ walks in order).
//
// Bound.  Bytes: ptr, the live slots' src, x's rows once per distinct
// source, out written once (chip_smoke.py pull_rows_bound).  The kernel
// reads a row once per live slot, not once per distinct source, as
// cuSPARSE's SpMM does: at R-MAT 2^21 and D = 602 (phase 6; NVIDIA H100
// 80GB HBM3, 700 W) 26.30 ms against a 2.30 ms bound and cuSPARSE's
// 24.32 ms; 72 registers a thread, 7 blocks a SM.

constexpr int kRowWarps = 4;              // chunks a block
constexpr int kRowThreads = 32 * kRowWarps;
constexpr int kCols = 8;                  // columns a lane a pass
constexpr int kRowsInFlight = 4;

__device__ __forceinline__ void add_rows(float (&acc)[kCols],
                                         const float* __restrict__ x,
                                         const int32_t (&s)[kRowsInFlight],
                                         int n, int64_t d, int col) {
  float r[kRowsInFlight][kCols];
#pragma unroll
  for (int i = 0; i < kRowsInFlight; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      r[i][c] = (i < n && col + 32 * c < d)
                    ? __ldg(x + s[i] * d + col + 32 * c) : 0.0f;
#pragma unroll
  for (int i = 0; i < kRowsInFlight; ++i)
    if (i < n) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = __fadd_rn(acc[c], r[i][c]);
    }
}

__global__ void __launch_bounds__(kRowThreads)
pull_rows_kernel(const int32_t* __restrict__ chunk_vertex,
                 const int32_t* __restrict__ chunk_begin,
                 const int32_t* __restrict__ chunk_end,
                 const int32_t* __restrict__ chunk_part,
                 const int32_t* __restrict__ src,
                 const float* __restrict__ x, float* __restrict__ out,
                 float* __restrict__ partial, int num_chunks,
                 int num_vertices, int d) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (c >= num_chunks) return;                       // warp-uniform
  const int v = __ldg(chunk_vertex + c);
  if (v >= num_vertices) return;                     // a surplus slot
  const int begin = __ldg(chunk_begin + c), end = __ldg(chunk_end + c);
  const int part = __ldg(chunk_part + c);
  float* row = part < 0 ? out + static_cast<int64_t>(v) * d
                        : partial + static_cast<int64_t>(part) * d;
  for (int col = lane; col - lane < d; col += 32 * kCols) {
    float acc[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q) acc[q] = 0.0f;
    for (int base = begin; base < end; base += 32) {
      const int n = min(32, end - base);
      const int32_t mine = lane < n ? __ldg(src + base + lane) : 0;
      for (int i = 0; i < n; i += kRowsInFlight) {
        int32_t s[kRowsInFlight];
#pragma unroll
        for (int q = 0; q < kRowsInFlight; ++q)
          s[q] = __shfl_sync(kAll, mine, (i + q) & 31);
        add_rows(acc, x, s, n - i, d, col);
      }
    }
#pragma unroll
    for (int q = 0; q < kCols; ++q)
      if (col + 32 * q < d) row[col + 32 * q] = acc[q];
  }
}

// out[v, :] += the split vertex's partial rows, in chunk order
__global__ void __launch_bounds__(kRowThreads)
pull_rows_split_kernel(const int32_t* __restrict__ split_vertex,
                       const int32_t* __restrict__ split_part,
                       const int32_t* __restrict__ split_count,
                       const float* __restrict__ partial,
                       float* __restrict__ out, int num_splits,
                       int num_vertices, int d) {
  const int s = blockIdx.x;
  const int v = __ldg(split_vertex + s);
  if (v >= num_vertices) return;
  const int p0 = __ldg(split_part + s), n = __ldg(split_count + s);
  for (int col = blockIdx.y * kRowThreads + threadIdx.x; col < d;
       col += gridDim.y * kRowThreads) {
    float* o = out + static_cast<int64_t>(v) * d + col;
    float acc = *o;
    for (int j = 0; j < n; ++j)
      acc = __fadd_rn(acc, __ldg(partial + static_cast<int64_t>(p0 + j) * d
                                 + col));
    *o = acc;
  }
}

}  // namespace

extern "C" int pull_contrib_launch(int device, const void* ptr,
                                   const void* src, const void* ranks,
                                   const void* inv, const void* weight,
                                   void* out, int num_vertices,
                                   void* stream) {
  // this library links its own CUDA runtime, whose current device is not
  // the caller's: select the tensors' device explicitly
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_vertices > 0) {
    const int blocks = (num_vertices + kWarps - 1) / kWarps;
    auto* p = static_cast<const int32_t*>(ptr);
    auto* s = static_cast<const int32_t*>(src);
    auto* r = static_cast<const double*>(ranks);
    auto* i = static_cast<const double*>(inv);
    auto* w = static_cast<const double*>(weight);
    auto* o = static_cast<double*>(out);
    auto st = static_cast<cudaStream_t>(stream);
    if (w != nullptr)
      pull_contrib_kernel<true><<<blocks, kThreads, 0, st>>>(
          p, s, r, i, w, o, num_vertices);
    else
      pull_contrib_kernel<false><<<blocks, kThreads, 0, st>>>(
          p, s, r, i, w, o, num_vertices);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pull_rows_launch(int device, const void* chunk_vertex,
                                const void* chunk_begin,
                                const void* chunk_end,
                                const void* chunk_part,
                                const void* split_vertex,
                                const void* split_part,
                                const void* split_count, const void* src,
                                const void* x, void* out, void* partial,
                                int num_chunks, int num_splits,
                                int num_vertices, int d, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  if (num_chunks > 0 && d > 0) {
    const int blocks = (num_chunks + kRowWarps - 1) / kRowWarps;
    pull_rows_kernel<<<blocks, kRowThreads, 0, st>>>(
        static_cast<const int32_t*>(chunk_vertex),
        static_cast<const int32_t*>(chunk_begin),
        static_cast<const int32_t*>(chunk_end),
        static_cast<const int32_t*>(chunk_part),
        static_cast<const int32_t*>(src), static_cast<const float*>(x),
        static_cast<float*>(out), static_cast<float*>(partial), num_chunks,
        num_vertices, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (num_splits > 0 && d > 0) {
    const dim3 grid(num_splits, (d + kRowThreads - 1) / kRowThreads);
    pull_rows_split_kernel<<<grid, kRowThreads, 0, st>>>(
        static_cast<const int32_t*>(split_vertex),
        static_cast<const int32_t*>(split_part),
        static_cast<const int32_t*>(split_count),
        static_cast<const float*>(partial), static_cast<float*>(out),
        num_splits, num_vertices, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// info[0..3]: registers a thread, resident blocks a SM, the SMs, and
// threads a block, of the unweighted f64 kernel; info[4..5]: registers a
// thread and resident blocks a SM of the row kernel.
extern "C" int pull_contrib_info(int device, int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr, row_attr;
  err = cudaFuncGetAttributes(&attr, pull_contrib_kernel<false>);
  int blocks = 0, sms = 0, row_blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, pull_contrib_kernel<false>, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&row_attr, pull_rows_kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &row_blocks, pull_rows_kernel, kRowThreads, 0);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = blocks;
  info[2] = sms;
  info[3] = kThreads;
  info[4] = row_attr.numRegs;
  info[5] = row_blocks;
  return static_cast<int>(cudaSuccess);
}
