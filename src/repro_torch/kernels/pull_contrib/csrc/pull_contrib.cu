// Fixed-order pull sums for Hopper (sm_90a).
//
// `pull_contrib`: f64 sums over sorted edge slots, the contributions of
// the f64 PageRank loop, c[v] = sum over live in-edges (u, v) of R[u] / d_u,
// or with a per-slot weight w of (R[u] * w) / W_u (weighted PageRank), and
// the other f64 segment sums of the port (PPR visit counts, weighted
// degrees).  `pull_rows`: its row variant, f32 neighbour-row sums for
// GraphSAGE (below the f64 kernels).
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
// [ptr[v], ptr[v+1]) of sorted slots and their sources src[k].  The term
// of slot k is w_k = ranks[s] * inv[s], s = src[k], one IEEE f64 multiply
// (with a weight, w_k = (ranks[s] * weight[k]) * inv[s], two).  A segment
// is cut into chunks of at most K slots (ref.py PULL_CHUNK), by the chunk
// plan of repro_torch/kernels/segment_ops/plan.py (windows = vertices,
// entries = sorted slots); each chunk's terms are added in slot order
// from +0.0, and a vertex's chunk sums are then added to its first
// chunk's sum in chunk order:
//     out[v] = ((c_0 + c_1) + c_2) + ...,  c_j = ((0.0 + w_a) + w_a+1) + ...
// A segment of at most K slots is one chunk: its terms added one at a
// time from +0.0.  The plain version computes the same adds on the CPU,
// so the card's sum equals the CPU's bit for bit and is the same from
// run to run.
//
// Design.  Three launches on the caller's stream:
//   1. y[i] = ranks[i] * inv[i] over the N values: a slot's term depends
//      on its source alone, so one pass forms the same IEEE products and
//      the chunks gather one f64 a slot, not two.  With weights the pass
//      writes the pairs z[i] = (ranks[i], inv[i]): one 16-byte gather.
//   2. One thread a chunk, in the plan's (vertex) order: it walks its
//      chunk's slots in order, reading the sources 16 bytes (4 slots) a
//      load two steps ahead, and gathers a step's 8 terms before the
//      previous step's 8 are added.  Chunk 0 writes out[v]; chunk j >= 1
//      of a split vertex writes its partial slot.  No segment's chain is
//      longer than K adds, and no term passes between lanes.
//   3. One thread a split vertex adds its partials to out[v] in chunk
//      order (the smoke graph's hub: 243 adds).
// No atomics, no host read; it allocates nothing (the wrapper hands in
// the scratch: y or z, and the plan's E // K partials).
//
// What was measured (chip_smoke.py phase 3b, R-MAT 2^21; NVIDIA H100
// 80GB HBM3, 700 W; PERF.md §6): the terms pass halves the gathers and
// pays (0.60 ms a call with two gathers a slot, 0.34 with one); plan
// order beats chunks sorted longest first (0.42 ms: neighbouring lanes
// share source lines and out's lines); 8 slots a step beats 16 (96
// registers, 5 blocks a SM); without the gathers held across the loop,
// the compiler issues each gather next to its add (one L2 latency a slot,
// ~120 ns: the hub's chunks took 0.045 ms).  K = 256 (128 to 2048 swept):
// 128 halves the hub's chain but slows the whole graph.
//
// Bitwise contract.  __dmul_rn and __dadd_rn, so no multiply-add is
// contracted into an FMA; no --use_fast_math.
//
// Bound.  A gather and a sum: bytes bound (ptr, the live slots' src,
// ranks and inv once per distinct source, the output; 2 f64 operations a
// live slot; chip_smoke.py pull_contrib_bound).  In practice the random
// gathers: ~32.4 M a call, one L2 sector each, ~3.5 TB/s of sectors at
// 0.29 ms.
//
// It launches on the caller's stream, allocates nothing and does not
// synchronise; the C entry points return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;             // chunks (or split vertices) a block
constexpr int kGroups = 2;                // 4-slot source groups a step
constexpr int kSlots = 4 * kGroups;       // slots a step
constexpr int kSplitUnroll = 16;          // partials loaded at once
constexpr unsigned kAll = 0xffffffffu;

// how a slot's term is formed: y[s], the products of launch 1, or with a
// weight (z[s].x * weight[k]) * z[s].y, z[s] = (ranks[s], inv[s])
template <bool kWeighted>
__device__ __forceinline__ double term(int32_t s, int k,
                                       const double* __restrict__ y,
                                       const double* __restrict__ weight) {
  if (!kWeighted) return __ldg(y + s);
  const double2 z = __ldg(reinterpret_cast<const double2*>(y) + s);
  return __dmul_rn(__dmul_rn(z.x, __ldg(weight + k)), z.y);
}

// launch 1: y[i] = ranks[i] * inv[i], or with weights z[i] = (ranks[i],
// inv[i]): the chunks then gather one 8- or 16-byte value a slot
template <bool kWeighted>
__global__ void __launch_bounds__(kThreads)
pull_contrib_terms_kernel(const double* __restrict__ ranks,
                          const double* __restrict__ inv,
                          double* __restrict__ y, int n) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    if (kWeighted)
      reinterpret_cast<double2*>(y)[i] = make_double2(__ldg(ranks + i),
                                                      __ldg(inv + i));
    else
      y[i] = __dmul_rn(__ldg(ranks + i), __ldg(inv + i));
  }
}

// the terms of the kSlots slots from k0 on, their sources in q: a slot
// outside [b, e) gathers source 0's term at slot b (both exist: the chunk
// is not empty), so every gather is unconditional
template <bool kWeighted>
__device__ __forceinline__ void gather(double (&t)[kSlots],
                                       const int4 (&q)[kGroups], int k0,
                                       int b, int e,
                                       const double* __restrict__ y,
                                       const double* __restrict__ weight) {
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int k = k0 + i;
    const int4 g = q[i / 4];
    const int s = i % 4 == 0 ? g.x : i % 4 == 1 ? g.y : i % 4 == 2 ? g.z : g.w;
    const bool in = k >= b && k < e;
    t[i] = term<kWeighted>(in ? s : 0, in ? k : b, y, weight);
  }
}

// ((0.0 + w_b) + w_b+1) + ... + w_e-1, in steps of kSlots slots.  The
// sources are read 16 bytes (4 slots, a group) a load, two steps ahead;
// the next step's terms are gathered before this step's are added, so
// they are in flight during the adds (held across the loop, they cannot
// be scheduled next to their adds).  A slot outside [b, e) adds +0.0:
// the sum starts at +0.0 and so is never -0.0, and acc + 0.0 == acc bit
// for bit for every other acc, NaN and infinities included.
template <bool kWeighted>
__device__ __forceinline__ double chunk_sum(
    int b, int e, const int32_t* __restrict__ src,
    const double* __restrict__ y, const double* __restrict__ weight) {
  double acc = 0.0;
  if (b >= e) return acc;
  // src[k] is element k + off of the 16-byte aligned src4
  const int off = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2)
                                   & 3);
  const int4* src4 = reinterpret_cast<const int4*>(src - off);
  const int g_end = (e + off + 3) >> 2;      // one past e - 1's group
  int g = (b + off) >> 2;                    // the group holding slot b
  const int4 none = make_int4(0, 0, 0, 0);
  int4 q[kGroups];
#pragma unroll
  for (int i = 0; i < kGroups; ++i)
    q[i] = g + i < g_end ? __ldg(src4 + g + i) : none;
  double t[kSlots];
  gather<kWeighted>(t, q, 4 * g - off, b, e, y, weight);
#pragma unroll
  for (int i = 0; i < kGroups; ++i)
    q[i] = g + kGroups + i < g_end ? __ldg(src4 + g + kGroups + i) : none;
  for (; g < g_end; g += kGroups) {
    const int k0 = 4 * g - off;
    double tn[kSlots];
    if (g + kGroups < g_end) {
      gather<kWeighted>(tn, q, k0 + kSlots, b, e, y, weight);
    } else {
#pragma unroll
      for (int i = 0; i < kSlots; ++i) tn[i] = 0.0;
    }
#pragma unroll
    for (int i = 0; i < kGroups; ++i)
      q[i] = g + 2 * kGroups + i < g_end
                 ? __ldg(src4 + g + 2 * kGroups + i) : none;
#pragma unroll
    for (int i = 0; i < kSlots; ++i)
      acc = __dadd_rn(acc, k0 + i >= b && k0 + i < e ? t[i] : 0.0);
#pragma unroll
    for (int i = 0; i < kSlots; ++i) t[i] = tn[i];
  }
  return acc;
}

template <bool kWeighted>
__global__ void __launch_bounds__(kThreads)
pull_contrib_chunks_kernel(const int32_t* __restrict__ chunk_vertex,
                           const int32_t* __restrict__ chunk_begin,
                           const int32_t* __restrict__ chunk_end,
                           const int32_t* __restrict__ chunk_part,
                           const int32_t* __restrict__ src,
                           const double* __restrict__ y,
                           const double* __restrict__ weight,
                           double* __restrict__ out,
                           double* __restrict__ partial, int num_chunks,
                           int num_vertices) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= num_chunks) return;
  const int v = __ldg(chunk_vertex + c);
  if (v >= num_vertices) return;                     // a surplus slot
  const int b = __ldg(chunk_begin + c), e = __ldg(chunk_end + c);
  const int part = __ldg(chunk_part + c);
  const double acc = chunk_sum<kWeighted>(b, e, src, y, weight);
  if (part < 0) out[v] = acc;
  else partial[part] = acc;
}

// out[v] += the split vertex's partials, in chunk order
__global__ void __launch_bounds__(kThreads)
pull_contrib_splits_kernel(const int32_t* __restrict__ split_vertex,
                           const int32_t* __restrict__ split_part,
                           const int32_t* __restrict__ split_count,
                           const double* __restrict__ partial,
                           double* __restrict__ out, int num_splits,
                           int num_vertices) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= num_splits) return;
  const int v = __ldg(split_vertex + s);
  if (v >= num_vertices) return;                     // a surplus slot
  const int p0 = __ldg(split_part + s), n = __ldg(split_count + s);
  double acc = out[v];
  int j = 0;
  for (; j + kSplitUnroll <= n; j += kSplitUnroll) {
    double p[kSplitUnroll];
#pragma unroll
    for (int i = 0; i < kSplitUnroll; ++i)
      p[i] = __ldg(partial + p0 + j + i);
#pragma unroll
    for (int i = 0; i < kSplitUnroll; ++i) acc = __dadd_rn(acc, p[i]);
  }
  for (; j < n; ++j) acc = __dadd_rn(acc, __ldg(partial + p0 + j));
  out[v] = acc;
}

// ---------------------------------------------------------------------------
// pull_rows: out[v, :] = sum over v's sorted slots k of x[src[k], :], f32.
//
// The row variant of the sum above, for GraphSAGE's neighbour sums
// (repro_torch/models/gnn.py `neighbor_sum`; it replaces that function's
// f32 `index_add_`, whose CUDA atomics added in an order that changed from
// run to run).  Plain version: ref.py `pull_rows_ref`.
//
// A vertex's non-empty segment is cut into chunks of at most K slots by
// the live-segment plan of repro_torch/kernels/segment_ops/plan.py
// (`live_chunk_plan`: the chunks of non-empty segments only, O(slots) where
// the slots are fewer than the rows), so a hub (62,458 in-edges of 602
// floats at the smoke's size) is walked by ~1,000 warps, not one, and a
// vertex with no live slot by none.  Each chunk's slots are walked in
// order, each column summed by one lane in slot order from +0.0
// (__fadd_rn, no FMA): a wide row (more than 16 vectors) by a warp a chunk,
// R rows' loads in flight before their adds; a narrow one by a group of G
// lanes a chunk (its vectors rounded up to a power of two), so a warp
// walks 32 / G chunks: at d = 1 a lane a chunk, at d = 10 (five float2) 8
// lanes.  Chunk 0 of a vertex writes its row; chunk j >= 1 of a split
// vertex a partial row to scratch, which the last launch adds to the row
// in chunk order.  The rows of the empty segments come from the fill, one
// coalesced pass over ptr (a launch of its own, not a prologue of the row
// launch: it needs no plan and leaves the row launches' registers and
// grids as they were).  Launches, in order:
//   - dense regime (wide rows, or slots at least the rows): fill (the
//     empty rows' zeros), [tag], rows into `out`, [release], splits;
//   - sparse regime (narrow rows into more rows than slots): [tag], rows
//     into `staged`, a row at each segment's first slot, [release], fill
//     (every row of `out`: zeros or the staged row), splits.
// No atomics: the result is the same bit for bit from run to run, and
// equals the plain version's sum on the CPU (whose index_add_ walks in
// order).
//
// What bounds it, by regime.  Sparse (DeepFM's table gradients: 2,555,904
// ids into 39 M rows, 6 % of them live, d = 10 and 1): the bytes of out,
// almost all zeros, and of ptr; the slots are few.  The first design
// built and walked a plan of one chunk a row (39 M chunks: ~20 int64
// passes and a searchsorted over 39 M to build, a warp and 16 bytes of
// plan a row to walk) and kept 5 or 1 of a warp's 32 lanes busy: 14.37 and
// 12.51 ms against index_add_'s 0.79 and 0.22.  Now the plan and the row
// walk are O(slots), a warp walks 4 (d = 10) or 32 (d = 1) chunks, and
// every sector of out is written whole, once: a sector that two launches
// write in parts (the fill's zeros around a live row, the row launch's
// row) costs the memory a read besides the write, and those two launches
// took 1.07 + 0.37 ms at d = 10 against 0.72 + 0.18 for the staged rows
// and the fill that places them.  What is left above index_add_'s time
// (0.92 against 0.80 ms at d = 10; 0.21 against 0.22 at d = 1): ptr's
// 157 MB, which an atomic add into zeros does not read, and the staged
// rows' write and read.  Dense (the GNN, d = 602 and 128): the gathers
// below; the fill takes the rows of no in-edge off the row launch.
//
// Bound.  Bytes: ptr, the live slots' src, x's rows once per distinct
// source, out written once (chip_smoke.py pull_rows_bound).  What sets the
// time in the dense regime is the bytes that reach DRAM: a row is gathered
// once per live slot
// (32.4 M gathers, 78 GB at D = 602 on the smoke's R-MAT 2^21 graph), and
// with plain loads the 50 MB L2 kept almost none of it: the first design
// was slower than cuSPARSE's SpMM over the same rows.  The sources are
// skewed (30 MB of rows, those of the 12,458
// sources with the most live out-edges, feed 44 % of the slots at D = 602;
// 70 % at D = 128), so the rows of the hot sources stay in L2 and the
// others stream past them:
//   - a first launch tags each live slot of a hot source by the sign bit
//     of its src (ids are < 2^31) into scratch, from a table of the hot
//     sources (pull_contrib.py hot_set), so the row launch reads the tag
//     with the id;
//   - a hot row is loaded with an L2 evict_last policy, a cold row with
//     evict_first, so the cold rows do not push the hot ones out; a last
//     launch sets the hot rows' lines back to the normal priority, so that
//     none stays at evict_last after the sum (lines a first variant left
//     at a persisting priority slowed every kernel after it);
//   - a row is read in one pass of vector loads where its width and x's
//     address allow: float2 at D = 602 (2,408-byte rows, 8-byte aligned:
//     10 a lane cover 640 columns), float4 at D = 128; else scalar loads,
//     8 a lane, in passes of 256 columns.
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): 19.98 ms at
// D = 602 and 3.89 at D = 128, the tag launch's 0.22 included, against
// cuSPARSE's 23.86 and 4.31 in the same run; the first design took 25.16
// and 4.93 beside cuSPARSE's 23.85 and 4.32 in another.  A 20-40 MB
// budget is as fast as 30; a copy of the hot rows under a persisting L2
// access-policy window was no faster and left its lines in L2.

constexpr int kRowWarps = 4;              // chunks a block
constexpr int kRowThreads = 32 * kRowWarps;
constexpr int32_t kIdBits = 0x7fffffff;   // the id of a tagged src

// By the floats a lane loads from a row: the rows whose loads a warp has
// in flight before their adds (16 floats a lane, or one row), and the
// blocks a SM the compiler must fit (at most 64 registers; 51 at 4
// floats).  Resident warps hide more latency than rows in flight a warp:
// at D = 602, one row and 8 blocks (62 registers) took 19.65 ms against
// 21.76 for two rows and 5 blocks (93); at D = 128, 4 rows and 10 blocks
// (42) 3.65 against 4.25 for 8 rows and 7 blocks (66) (PERF.md §6).
__host__ __device__ constexpr int rows_in_flight(int floats) {
  return floats >= 16 ? 1 : 16 / floats;
}
__host__ __device__ constexpr int min_blocks(int floats) {
  return floats <= 4 ? 10 : 8;
}

__device__ __forceinline__ uint64_t l2_policy_keep() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_policy_stream() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

// r = the V floats at p (4V-byte aligned), read through the non-coherent
// path with the L2 policy `pol`
__device__ __forceinline__ void load_vec(float (&r)[1], const float* p,
                                         uint64_t pol) {
  asm volatile("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
               : "=f"(r[0]) : "l"(p), "l"(pol));
}

__device__ __forceinline__ void load_vec(float (&r)[2], const float* p,
                                         uint64_t pol) {
  asm volatile("ld.global.nc.L2::cache_hint.v2.f32 {%0, %1}, [%2], %3;"
               : "=f"(r[0]), "=f"(r[1]) : "l"(p), "l"(pol));
}

__device__ __forceinline__ void load_vec(float (&r)[4], const float* p,
                                         uint64_t pol) {
  asm volatile(
      "ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
      : "=f"(r[0]), "=f"(r[1]), "=f"(r[2]), "=f"(r[3])
      : "l"(p), "l"(pol));
}

// r = the V floats at p (4V-byte aligned), read once (streaming)
__device__ __forceinline__ void load_once(float (&r)[1], const float* p) {
  r[0] = __ldcs(p);
}
__device__ __forceinline__ void load_once(float (&r)[2], const float* p) {
  const float2 a = __ldcs(reinterpret_cast<const float2*>(p));
  r[0] = a.x;
  r[1] = a.y;
}
__device__ __forceinline__ void load_once(float (&r)[4], const float* p) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  r[0] = a.x;
  r[1] = a.y;
  r[2] = a.z;
  r[3] = a.w;
}

// the V floats of a written row go out with the streaming (evict-first)
// store: they are not read again by this launch
__device__ __forceinline__ void store_vec(float* p, const float (&a)[1]) {
  __stcs(p, a[0]);
}
__device__ __forceinline__ void store_vec(float* p, const float (&a)[2]) {
  __stcs(reinterpret_cast<float2*>(p), make_float2(a[0], a[1]));
}
__device__ __forceinline__ void store_vec(float* p, const float (&a)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(a[0], a[1], a[2], a[3]));
}

// One warp a chunk.  Lane l owns the V-float vectors l, l + 32, ...,
// l + 32 (N - 1) of a pass of 32 N vectors (32 N V columns); passes until
// the row's d / V vectors are done (d % V == 0, x 4V-byte aligned: the
// wrapper's choice).  A slot's src < 0 is a hot source: its row, x's row
// src & kIdBits, is loaded with the L2 evict_last policy; any other row
// with evict_first.
template <int V, int N>
__global__ void __launch_bounds__(kRowThreads, min_blocks(V * N))
pull_rows_kernel(const int32_t* __restrict__ chunk_vertex,
                 const int32_t* __restrict__ chunk_begin,
                 const int32_t* __restrict__ chunk_end,
                 const int32_t* __restrict__ chunk_part,
                 const int32_t* __restrict__ src,
                 const float* __restrict__ x, float* __restrict__ out,
                 float* __restrict__ partial, int num_chunks,
                 int num_vertices, int d) {
  constexpr int R = rows_in_flight(V * N);
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (c >= num_chunks) return;                       // warp-uniform
  const int v = __ldg(chunk_vertex + c);
  if (v >= num_vertices) return;                     // a surplus slot
  const int begin = __ldg(chunk_begin + c), end = __ldg(chunk_end + c);
  const int part = __ldg(chunk_part + c);
  float* row = part < 0 ? out + static_cast<int64_t>(v) * d
                        : partial + static_cast<int64_t>(part) * d;
  const uint64_t keep = l2_policy_keep(), stream = l2_policy_stream();
  const int dv = d / V;                              // vectors a row
  for (int col = lane; col - lane < dv; col += 32 * N) {
    float acc[N][V];
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[j][e] = 0.0f;
    for (int base = begin; base < end; base += 32) {
      const int n = min(32, end - base);
      const int32_t mine = lane < n ? __ldcs(src + base + lane) : 0;
      for (int i = 0; i < n; i += R) {
        float r[R][N][V];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          // the slot's tag and id, the same in every lane
          const int32_t t = __shfl_sync(kAll, mine, (i + q) & 31);
          const float* p = x + static_cast<int64_t>(t & kIdBits) * d;
          const uint64_t pol = t < 0 ? keep : stream;
#pragma unroll
          for (int j = 0; j < N; ++j) {
            const int cv = col + 32 * j;
            if (i + q < n && cv < dv) {
              load_vec(r[q][j], p + cv * V, pol);
            } else {
#pragma unroll
              for (int e = 0; e < V; ++e) r[q][j][e] = 0.0f;
            }
          }
        }
#pragma unroll
        for (int q = 0; q < R; ++q)
          if (i + q < n) {
#pragma unroll
            for (int j = 0; j < N; ++j)
#pragma unroll
              for (int e = 0; e < V; ++e)
                acc[j][e] = __fadd_rn(acc[j][e], r[q][j][e]);
          }
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (col + 32 * j < dv) store_vec(row + (col + 32 * j) * V, acc[j]);
  }
}

// the row paths (floats a load V, loads a lane a pass N) the wrapper picks
// from (pull_contrib.py ROW_PATHS)
#define PULL_ROWS_PATHS(X) X(1, 8) X(2, 10) X(4, 1)

// A group of G lanes a chunk, 32 / G chunks a warp, for rows of at most G
// V-float vectors (the wrapper's choice, pull_contrib.py row_lanes): lane
// g of a group owns vector g of the row (lanes g >= d / V have nothing to
// do and leave).  Chunk 0 of a segment writes its row of `out`, or, with
// `staged`, row `begin` (the segment's first slot) of the staged rows,
// which the fill then places.  A group walks kPackedChunks chunks, the
// block's neighbouring chunks i, i + groups, ... (so each load of the plan
// is coalesced), and loads the plan entries, first sources and first rows
// of all of them before its first add: a sparse sum's chunks are short
// (DeepFM's: 1.03 slots on average).  A chunk's further slots are walked
// in order, 8 / V slots' loads in flight before their adds.  At DeepFM's
// d = 10 the launch took 0.40 ms with a chunk a group, 0.37 with four, and
// 0.19 once its rows went to the staged rows, contiguous, instead of into
// 39 M rows (PERF.md §6).  Tags and L2 policies as in
// pull_rows_kernel.
constexpr int kPackedChunks = 4;
constexpr int kPackedMinBlocks = 10;      // at most 51 registers

template <int V, int G>
__global__ void __launch_bounds__(kRowThreads, kPackedMinBlocks)
pull_rows_packed_kernel(const int32_t* __restrict__ chunk_vertex,
                        const int32_t* __restrict__ chunk_begin,
                        const int32_t* __restrict__ chunk_end,
                        const int32_t* __restrict__ chunk_part,
                        const int32_t* __restrict__ src,
                        const float* __restrict__ x, float* __restrict__ out,
                        float* __restrict__ partial,
                        float* __restrict__ staged, int num_chunks,
                        int num_vertices, int d) {
  constexpr int R = 8 / V;                           // slots in flight
  constexpr int M = kPackedChunks;
  constexpr int groups = kRowThreads / G;            // groups a block
  const int g = threadIdx.x % G;
  if (g >= d / V) return;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * M * groups
                     + threadIdx.x / G;
  const uint64_t keep = l2_policy_keep(), stream = l2_policy_stream();
  int v[M], b[M], e[M], p[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int64_t c = c0 + i * groups;
    v[i] = c < num_chunks ? __ldg(chunk_vertex + c) : num_vertices;
    const bool real = v[i] < num_vertices;
    b[i] = real ? __ldg(chunk_begin + c) : 0;
    e[i] = real ? __ldg(chunk_end + c) : 0;
    p[i] = real ? __ldg(chunk_part + c) : 0;
  }
  // the first slot of every chunk (a real chunk has one), its row loaded
  int32_t t[M];
#pragma unroll
  for (int i = 0; i < M; ++i) t[i] = b[i] < e[i] ? __ldcs(src + b[i]) : 0;
  float first[M][V];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (b[i] < e[i]) {
      load_vec(first[i], x + static_cast<int64_t>(t[i] & kIdBits) * d + g * V,
               t[i] < 0 ? keep : stream);
    } else {
#pragma unroll
      for (int q = 0; q < V; ++q) first[i][q] = 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (v[i] >= num_vertices) continue;              // a surplus slot
    float acc[V];
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] = __fadd_rn(0.0f, first[i][q]);
    for (int base = b[i] + 1; base < e[i]; base += R) {
      const int n = min(R, e[i] - base);
      int32_t s[R];
#pragma unroll
      for (int k = 0; k < R; ++k) s[k] = k < n ? __ldcs(src + base + k) : 0;
      float r[R][V];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        if (k < n) {
          load_vec(r[k], x + static_cast<int64_t>(s[k] & kIdBits) * d
                             + g * V, s[k] < 0 ? keep : stream);
        } else {
#pragma unroll
          for (int q = 0; q < V; ++q) r[k][q] = 0.0f;
        }
      }
#pragma unroll
      for (int k = 0; k < R; ++k)
        if (k < n) {
#pragma unroll
          for (int q = 0; q < V; ++q) acc[q] = __fadd_rn(acc[q], r[k][q]);
        }
    }
    float* row = p[i] >= 0 ? partial + static_cast<int64_t>(p[i]) * d
                 : staged != nullptr ? staged + static_cast<int64_t>(b[i]) * d
                                     : out + static_cast<int64_t>(v[i]) * d;
    store_vec(row + g * V, acc);
  }
}

// the packed paths (floats a load V, lanes a chunk G)
#define PULL_ROWS_PACKED_PATHS(X) \
  X(1, 1) X(1, 2) X(1, 4) X(1, 8) X(1, 16) \
  X(2, 1) X(2, 2) X(2, 4) X(2, 8) X(2, 16) \
  X(4, 1) X(4, 2) X(4, 4) X(4, 8) X(4, 16)

// The zero rows of the empty segments and, with `staged` (the sparse
// regime), every other row too: a live row is the staged row of its
// segment's first slot, staged[ptr[w]], which the packed launch wrote (so
// that each sector of `out` is written whole, once: see the header).  A
// warp takes kFillGroups groups of 32 neighbouring vertices w at once: it
// loads ptr[w] and ptr[w + 1] of all of them (coalesced, kFillGroups loads
// in flight), then writes the rows with V-float stores (d % V == 0, out
// 4V-byte aligned).  A row of fewer than 32 vectors is written with the
// warp's lanes across the 32 rows' vectors in address order, so that a
// store covers whole sectors; a wider one a row at a time.  Placing, a
// lane loads the staged vectors of its next 8 / V stores before it stores
// them (where a row is one vector, a lane a row, the 8 groups' loads
// first): d = 1's fill took 0.23 ms with a load before each store, 0.12
// with the loads first.  Written with the streaming store: nothing in this
// sum reads them.
constexpr int kFillGroups = 8;

template <int V>
__global__ void __launch_bounds__(kRowThreads)
pull_rows_fill_kernel(const int32_t* __restrict__ ptr,
                      const float* __restrict__ staged,
                      float* __restrict__ out, int num_vertices, int d) {
  constexpr int B = 8 / V;                           // stores a batch
  const int lane = threadIdx.x & 31;
  const int dv = d / V;                              // vectors a row
  const float zero[V] = {};
  const int64_t span = 32 * kFillGroups;             // vertices a warp step
  for (int64_t w0 = span * (static_cast<int64_t>(blockIdx.x) * kRowWarps
                            + (threadIdx.x >> 5));
       w0 < num_vertices;
       w0 += span * gridDim.x * kRowWarps) {          // warp-uniform
    int32_t lo[kFillGroups], hi[kFillGroups];
#pragma unroll
    for (int u = 0; u < kFillGroups; ++u) {
      const int64_t w = w0 + 32 * u + lane;
      lo[u] = w < num_vertices ? __ldcs(ptr + w) : 0;
      hi[u] = w < num_vertices ? __ldcs(ptr + w + 1) : 0;
    }
    unsigned empty[kFillGroups], live[kFillGroups];
#pragma unroll
    for (int u = 0; u < kFillGroups; ++u) {
      const bool in = w0 + 32 * u + lane < num_vertices;
      empty[u] = __ballot_sync(kAll, in && lo[u] == hi[u]);
      live[u] = __ballot_sync(kAll, in && lo[u] != hi[u]);
    }
    if (staged != nullptr && dv == 1) {
      // a row a lane: its own first slot, the 8 groups' loads at once
      float a[kFillGroups][V];
#pragma unroll
      for (int u = 0; u < kFillGroups; ++u) {
        if ((live[u] >> lane) & 1u) {
          load_once(a[u], staged + static_cast<int64_t>(lo[u]) * d);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) a[u][e] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kFillGroups; ++u)
        if (((empty[u] | live[u]) >> lane) & 1u)
          store_vec(out + (w0 + 32 * u + lane) * d, a[u]);
      continue;
    }
    if (staged != nullptr) {
#pragma unroll
      for (int u = 0; u < kFillGroups; ++u) {
        const unsigned any = empty[u] | live[u];
        if (any == 0u) continue;                     // warp-uniform
        float* base = out + (w0 + 32 * u) * d;
        // vector i = lane + 32 k of the 32 rows' 32 dv: row i / dv, kept
        // as (r, col); B of them loaded before they are stored
        const int step_r = 32 / dv, step_c = 32 % dv;
        int r = lane / dv, col = lane % dv;
        for (int k0 = 0; k0 < dv; k0 += B) {         // warp-uniform
          float a[B][V];
          bool put[B];
#pragma unroll
          for (int j = 0; j < B; ++j) {
            const bool valid = k0 + j < dv;
            const int32_t first = __shfl_sync(kAll, lo[u], r & 31);
            put[j] = valid && ((any >> (r & 31)) & 1u);
            if (valid && ((live[u] >> (r & 31)) & 1u)) {
              load_once(a[j], staged + static_cast<int64_t>(first) * d
                                  + col * V);
            } else {
#pragma unroll
              for (int e = 0; e < V; ++e) a[j][e] = 0.0f;
            }
            r += step_r;
            col += step_c;
            if (col >= dv) {
              col -= dv;
              ++r;
            }
          }
#pragma unroll
          for (int j = 0; j < B; ++j)
            if (put[j])
              store_vec(base + static_cast<int64_t>(lane + 32 * (k0 + j)) * V,
                        a[j]);
        }
      }
      continue;
    }
#pragma unroll
    for (int u = 0; u < kFillGroups; ++u) {
      unsigned mask = empty[u];
      if (mask == 0u) continue;                      // warp-uniform
      float* base = out + (w0 + 32 * u) * d;
      if (dv < 32) {
        // vector i of the 32 rows' 32 dv: row i / dv, kept as (r, col)
        int r = lane / dv, col = lane % dv;
        const int step_r = 32 / dv, step_c = 32 % dv;
        for (int i = lane; i < 32 * dv; i += 32) {
          if ((mask >> r) & 1u)
            store_vec(base + static_cast<int64_t>(i) * V, zero);
          r += step_r;
          col += step_c;
          if (col >= dv) {
            col -= dv;
            ++r;
          }
        }
      } else {
        while (mask != 0u) {
          const int r = __ffs(mask) - 1;
          mask &= mask - 1;
          float* row = base + static_cast<int64_t>(r) * d;
          for (int i = lane; i < dv; i += 32) store_vec(row + i * V, zero);
        }
      }
    }
  }
}

// out[v, :] += the split vertex's partial rows, in chunk order.  The plan
// lists the split vertices first and its surplus slots after them, so a
// block walks split vertices blockIdx.x, + gridDim.x, ... up to the first
// surplus slot: a grid of at most kSplitBlocks, not a block a slot of the
// plan's bound (748,067 at the smoke's size).
constexpr int kSplitBlocks = 2048;

__global__ void __launch_bounds__(kRowThreads)
pull_rows_split_kernel(const int32_t* __restrict__ split_vertex,
                       const int32_t* __restrict__ split_part,
                       const int32_t* __restrict__ split_count,
                       const float* __restrict__ partial,
                       float* __restrict__ out, int num_splits,
                       int num_vertices, int d) {
  for (int s = blockIdx.x; s < num_splits; s += gridDim.x) {
    const int v = __ldg(split_vertex + s);
    if (v >= num_vertices) return;                   // surplus from here on
    const int p0 = __ldg(split_part + s), n = __ldg(split_count + s);
    for (int col = blockIdx.y * kRowThreads + threadIdx.x; col < d;
         col += gridDim.y * kRowThreads) {
      float* o = out + static_cast<int64_t>(v) * d + col;
      float acc = *o;
      for (int j = 0; j < n; ++j)
        acc = __fadd_rn(acc, __ldg(partial
                                   + static_cast<int64_t>(p0 + j) * d
                                   + col));
      *o = acc;
    }
  }
}

// The slots' tags, the first launch of a sum with a hot set: tagged[k] =
// src[k] | tag[src[k]] (the sign bit for a hot source, else 0) for the
// live slots k < *live_end, 4 slots (16 bytes) a load where src is
// 16-byte aligned (tagged, fresh scratch, always is).
__global__ void __launch_bounds__(kRowThreads)
pull_rows_tag_kernel(const int32_t* __restrict__ src,
                     const int32_t* __restrict__ tag,
                     const int32_t* __restrict__ live_end,
                     int32_t* __restrict__ tagged) {
  const int end = __ldg(live_end);
  const int step = gridDim.x * kRowThreads;
  int k = blockIdx.x * kRowThreads + threadIdx.x;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (; 4 * k + 3 < end; k += step) {
      int4 s = __ldcs(reinterpret_cast<const int4*>(src) + k);
      s.x |= __ldg(tag + s.x);
      s.y |= __ldg(tag + s.y);
      s.z |= __ldg(tag + s.z);
      s.w |= __ldg(tag + s.w);
      __stcs(reinterpret_cast<int4*>(tagged) + k, s);
    }
    k = (end & ~3) + blockIdx.x * kRowThreads + threadIdx.x;  // the tail
  }
  for (; k < end; k += step) {
    const int32_t s = __ldcs(src + k);
    __stcs(tagged + k, s | __ldg(tag + s));
  }
}

// After the sum, the L2 lines of x's rows top[0..rows) go back to the
// normal eviction priority, so that they do not crowd the next kernels'
// lines out of L2.
__global__ void __launch_bounds__(kRowThreads)
pull_rows_release_kernel(const int64_t* __restrict__ top, int rows,
                         const float* __restrict__ x, int d) {
  const int lane = threadIdx.x & 31;
  for (int i = blockIdx.x * kRowWarps + (threadIdx.x >> 5); i < rows;
       i += gridDim.x * kRowWarps) {
    const uintptr_t b = reinterpret_cast<uintptr_t>(x + __ldg(top + i) * d);
    const uintptr_t e = b + 4 * static_cast<uintptr_t>(d);
    for (uintptr_t line = (b & ~static_cast<uintptr_t>(127)) + 128 * lane;
         line < e; line += 128 * 32)
      asm volatile("applypriority.L2::evict_normal [%0], 128;"
                   :: "l"(line) : "memory");
  }
}

}  // namespace

namespace {

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// The f64 pull sum.  chunk_* and split_* are the chunk plan's arrays
// (segment_ops/plan.py ChunkPlan); `y` scratch of num_values f64
// (unweighted: the terms) or 2 * num_values (weighted: the (ranks, inv)
// pairs); `partial` scratch of the plan's partials.
extern "C" int pull_contrib_launch(
    int device, const void* chunk_vertex, const void* chunk_begin,
    const void* chunk_end, const void* chunk_part, const void* split_vertex,
    const void* split_part, const void* split_count, const void* src,
    const void* ranks, const void* inv, const void* weight, void* y,
    void* out, void* partial, int num_chunks, int num_splits,
    int num_vertices, int num_values, void* stream) {
  // this library links its own CUDA runtime, whose current device is not
  // the caller's: select the tensors' device explicitly
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_vertices == 0) return static_cast<int>(cudaGetLastError());
  auto st = static_cast<cudaStream_t>(stream);
  auto* cv = static_cast<const int32_t*>(chunk_vertex);
  auto* cb = static_cast<const int32_t*>(chunk_begin);
  auto* ce = static_cast<const int32_t*>(chunk_end);
  auto* cp = static_cast<const int32_t*>(chunk_part);
  auto* s = static_cast<const int32_t*>(src);
  auto* r = static_cast<const double*>(ranks);
  auto* i = static_cast<const double*>(inv);
  auto* w = static_cast<const double*>(weight);
  auto* yy = static_cast<double*>(y);
  auto* o = static_cast<double*>(out);
  auto* p = static_cast<double*>(partial);
  const int term_blocks = blocks_for(num_values) < 4096
                              ? blocks_for(num_values) : 4096;
  if (num_values > 0) {
    if (w != nullptr)
      pull_contrib_terms_kernel<true><<<term_blocks, kThreads, 0, st>>>(
          r, i, yy, num_values);
    else
      pull_contrib_terms_kernel<false><<<term_blocks, kThreads, 0, st>>>(
          r, i, yy, num_values);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (w != nullptr)
    pull_contrib_chunks_kernel<true><<<blocks_for(num_chunks), kThreads, 0,
                                       st>>>(cv, cb, ce, cp, s, yy, w, o, p,
                                             num_chunks, num_vertices);
  else
    pull_contrib_chunks_kernel<false><<<blocks_for(num_chunks), kThreads, 0,
                                        st>>>(cv, cb, ce, cp, s, yy, w, o, p,
                                              num_chunks, num_vertices);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_splits > 0)
    pull_contrib_splits_kernel<<<blocks_for(num_splits), kThreads, 0, st>>>(
        static_cast<const int32_t*>(split_vertex),
        static_cast<const int32_t*>(split_part),
        static_cast<const int32_t*>(split_count), p, o, num_splits,
        num_vertices);
  return static_cast<int>(cudaGetLastError());
}

namespace {

using RowKernel = void (*)(const int32_t*, const int32_t*, const int32_t*,
                           const int32_t*, const int32_t*, const float*,
                           float*, float*, int, int, int);
using PackedKernel = void (*)(const int32_t*, const int32_t*,
                              const int32_t*, const int32_t*,
                              const int32_t*, const float*, float*, float*,
                              float*, int, int, int);

// the row kernel of path (vec, loads): a warp a chunk; nullptr if none
RowKernel row_kernel(int vec, int loads) {
#define PULL_ROWS_CASE(V, N) \
  if (vec == V && loads == N) return pull_rows_kernel<V, N>;
  PULL_ROWS_PATHS(PULL_ROWS_CASE)
#undef PULL_ROWS_CASE
  return nullptr;
}

// the packed kernel of (vec, group) lanes a chunk; nullptr if none
PackedKernel packed_kernel(int vec, int group) {
#define PULL_ROWS_PACKED_CASE(V, G) \
  if (vec == V && group == G) return pull_rows_packed_kernel<V, G>;
  PULL_ROWS_PACKED_PATHS(PULL_ROWS_PACKED_CASE)
#undef PULL_ROWS_PACKED_CASE
  return nullptr;
}

using FillKernel = void (*)(const int32_t*, const float*, float*, int, int);

// the fill kernel of the widest store d allows (out and the staged rows
// are 16-byte aligned), and its vectors a row
FillKernel fill_kernel(int d, int* vectors) {
  const int v = d % 4 == 0 ? 4 : d % 2 == 0 ? 2 : 1;
  *vectors = d / v;
  if (v == 4) return pull_rows_fill_kernel<4>;
  if (v == 2) return pull_rows_fill_kernel<2>;
  return pull_rows_fill_kernel<1>;
}

}  // namespace

// The f32 row sum.  chunk_* and split_* are the live-segment plan's arrays
// (segment_ops/plan.py live_chunk_plan); `ptr` the order's num_vertices + 1
// segment bounds; `src` the order's num_slots sources; (vec, loads) the row
// path, `group` the lanes a chunk (32: a warp, the wide path).  Launches:
// the fill (the rows of the empty segments), then the rows; or, with
// `staged` (narrow rows, group < 32: num_slots rows of scratch), the rows
// into `staged`, then the fill, which writes every row of `out`; then the
// splits.  With a hot set (`tag` not
// null: tag[s] is the sign bit for a hot source s, else 0) the live slots
// (k < ptr[num_vertices]) are first tagged into `tagged`, which the row
// launch reads, and after it the lines of x's top_rows rows top[i] go back
// to the normal L2 priority.
extern "C" int pull_rows_launch(int device, const void* chunk_vertex,
                                const void* chunk_begin,
                                const void* chunk_end,
                                const void* chunk_part,
                                const void* split_vertex,
                                const void* split_part,
                                const void* split_count, const void* src,
                                const void* tag, const void* ptr,
                                void* tagged, int num_slots, const void* x,
                                const void* top, int top_rows, void* out,
                                void* partial, void* staged, int num_chunks,
                                int num_splits, int num_vertices, int d,
                                int vec, int loads, int group, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  const RowKernel wide = group == 32 ? row_kernel(vec, loads) : nullptr;
  const PackedKernel packed = group < 32 ? packed_kernel(vec, group)
                                         : nullptr;
  int fill_vectors;
  const FillKernel fill = fill_kernel(d, &fill_vectors);
  if ((wide == nullptr && packed == nullptr) || d % vec != 0
      || (packed != nullptr && d / vec > group)
      || (staged != nullptr && (packed == nullptr || fill_vectors >= 32)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_vertices == 0 || d == 0) return static_cast<int>(cudaSuccess);
  auto* xs = static_cast<const float*>(x);
  auto* slots = static_cast<const int32_t*>(src);
  auto* bounds = static_cast<const int32_t*>(ptr);
  auto* rows = static_cast<float*>(staged);
  const int span = 32 * kFillGroups * kRowWarps;
  const int fill_blocks = (num_vertices + span - 1) / span < 8192
                              ? (num_vertices + span - 1) / span : 8192;
  if (rows == nullptr) {
    fill<<<fill_blocks, kRowThreads, 0, st>>>(
        bounds, nullptr, static_cast<float*>(out), num_vertices, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (num_chunks > 0) {
    int blocks;
    if (tag != nullptr && num_slots > 0) {
      blocks = (num_slots + kRowThreads - 1) / kRowThreads;
      pull_rows_tag_kernel<<<blocks < 4096 ? blocks : 4096, kRowThreads, 0,
                             st>>>(slots, static_cast<const int32_t*>(tag),
                                   bounds + num_vertices,
                                   static_cast<int32_t*>(tagged));
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      slots = static_cast<const int32_t*>(tagged);
    }
    auto* cv = static_cast<const int32_t*>(chunk_vertex);
    auto* cb = static_cast<const int32_t*>(chunk_begin);
    auto* ce = static_cast<const int32_t*>(chunk_end);
    auto* cp = static_cast<const int32_t*>(chunk_part);
    if (packed != nullptr) {
      const int per_block = kPackedChunks * kRowThreads / group;
      blocks = (num_chunks + per_block - 1) / per_block;
      packed<<<blocks, kRowThreads, 0, st>>>(
          cv, cb, ce, cp, slots, xs, static_cast<float*>(out),
          static_cast<float*>(partial), rows, num_chunks, num_vertices, d);
    } else {
      blocks = (num_chunks + kRowWarps - 1) / kRowWarps;
      wide<<<blocks, kRowThreads, 0, st>>>(
          cv, cb, ce, cp, slots, xs, static_cast<float*>(out),
          static_cast<float*>(partial), num_chunks, num_vertices, d);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (top_rows > 0) {
      blocks = (top_rows + kRowWarps - 1) / kRowWarps;
      pull_rows_release_kernel<<<blocks < 1024 ? blocks : 1024, kRowThreads,
                                 0, st>>>(static_cast<const int64_t*>(top),
                                          top_rows, xs, d);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  if (rows != nullptr) {
    fill<<<fill_blocks, kRowThreads, 0, st>>>(
        bounds, rows, static_cast<float*>(out), num_vertices, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (num_splits > 0) {
    const dim3 grid(num_splits < kSplitBlocks ? num_splits : kSplitBlocks,
                    (d + kRowThreads - 1) / kRowThreads);
    pull_rows_split_kernel<<<grid, kRowThreads, 0, st>>>(
        static_cast<const int32_t*>(split_vertex),
        static_cast<const int32_t*>(split_part),
        static_cast<const int32_t*>(split_count),
        static_cast<const float*>(partial), static_cast<float*>(out),
        num_splits, num_vertices, d);
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {

// info[0..1]: registers a thread and resident blocks a SM of `f`
template <typename F>
cudaError_t func_info(F f, int threads, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, f);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[1], f, threads,
                                                       0);
}

}  // namespace

// info[0..3]: registers a thread, resident blocks a SM, the SMs, and
// threads a block, of the unweighted chunk kernel; info[4..5]: registers a
// thread and resident blocks a SM of the scalar row kernel (path (1, 8));
// info[6..7] of the weighted chunk kernel; info[8..9] of the split kernel.
extern "C" int pull_contrib_info(int device, int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = func_info(pull_contrib_chunks_kernel<false>, kThreads, info);
  if (err == cudaSuccess)
    err = func_info(row_kernel(1, 8), kRowThreads, info + 4);
  if (err == cudaSuccess)
    err = func_info(pull_contrib_chunks_kernel<true>, kThreads, info + 6);
  if (err == cudaSuccess)
    err = func_info(pull_contrib_splits_kernel, kThreads, info + 8);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // func_info wrote blocks a SM into info[1]; the SMs and threads follow
  info[2] = sms;
  info[3] = kThreads;
  return static_cast<int>(cudaSuccess);
}

// info[0..1]: registers a thread and resident blocks a SM of the row
// kernel of path (vec, loads) (group 32), or of the packed kernel of
// (vec, group) lanes a chunk
extern "C" int pull_rows_info(int device, int vec, int loads, int group,
                              int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (group == 32) {
    const RowKernel kernel = row_kernel(vec, loads);
    if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(func_info(kernel, kRowThreads, info));
  }
  const PackedKernel kernel = packed_kernel(vec, group);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(func_info(kernel, kRowThreads, info));
}
