// Edge-slot counts for Hopper (sm_90a): the degrees and the frontier
// pushes of the PageRank loops.  Three kernels:
//
//   slot_count      out[index[e]] += 1 for every slot e with weight[e] set
//                   (and flags[gather[e]] set, when given): the counts by
//                   src (`out_degree`, the row sum's source ranking);
//   segment_bounds  ptr[v] = the first position of a dst-sorted slot order
//                   whose key is >= v: the order's own segments, so that
//                   in_degree[v] = ptr[v + 1] - ptr[v];
//   segment_or      out[v] = OR of flags[src[k]] over v's segment of the
//                   sorted order: `push_or`.
//
// The port's own kernels: they replace no Pallas kernel.  `slot_count`
// replaced the int32 `index_add_` that counted the degrees and frontier
// pushes of repro_torch/graph/structure.py; that CUDA `index_add_` issued
// one atomic add per slot, zero weights included, and a graph's free slots
// all carry src = dst = 0 (`from_coo` pads with vertex 0): at R-MAT 2^21,
// 16.2 M atomic adds of 0 piled up on one address a call, 12.07 of its
// 13.17 ms.  `segment_bounds` and `segment_or` replace `slot_count`'s
// atomic counts by dst (this file's `slot_count_kernel`, `in_degree` and
// every `push_or`).  Plain versions: repro_torch/kernels/slot_count/ref.py
// `slot_count_ref`, `segment_bounds_ref`, `segment_or_ref`.
//
// slot_count.  A warp takes 4 rounds of 32 consecutive slots at a time,
// all loads issued before the adds: the weights coalesced; with a gather,
// gather[e] and flags[gather[e]] only for a slot whose weight is set; the
// index only for a slot still counted.  A slot whose weight (or flag) is
// 0 issues no atomic and reads no index.  In each round the lanes with a
// set slot that share an index find each other with __match_any_sync, and
// the lowest of them adds their number with one atomicAdd: the runs of
// equal src of a src-sorted edge list become one atomic a warp instead of
// up to 32.  Counts by dst hit scattered addresses and barely merge: at
// R-MAT 2^21 `in_degree` took 0.657 ms against a 0.056 ms bound, 32.4 M
// scattered L2 atomics (phase 3b; NVIDIA H100 80GB HBM3, 700 W).  The
// counts are integers, so the result is exact in any order and equals
// the CPU's `index_add_`.
//
// The dst-sorted order.  Every solve sorts the slots by dst once (stable;
// dead slots keyed V, so they come last), and the sort returns the sorted
// keys with the permutation.  On that order a vertex's in-edges are one
// run of equal keys, so neither count by dst needs an atomic:
//
// segment_bounds.  Position k of the sorted keys (k = n is the end, keyed
// V) with key[k-1] < key[k] (key[-1] = -1) writes ptr[key[k-1]+1 ..
// key[k]] = k: the vertices up to key[k] whose segments begin at k,
// including the empty ones before it, those before the first live key and
// ptr[V], where the dead keys begin.  Every ptr entry is written once, by
// plain stores.  A thread takes 4 consecutive keys, one 16-byte streaming
// load (scalar loads for an unaligned base or the tail), and the key
// before them from the previous lane by a shuffle.  A run of at most
// kShortRun entries is stored by its lane; a longer one (a long gap of
// vertices without in-edges, or ptr[0..V] all 0 for a graph with no live
// slot) by the whole warp, 32 consecutive entries a store.  Warps walk
// the keys in a grid stride and stop at the first tile whose keys are all
// dead: past it nothing is written, so the dead keys are read at most one
// tile a warp.  Bound: the live keys read once and ptr written once,
// (4 * 32.4 M + 4 * (2^21 + 1)) B / 3.35 TB/s = 0.041 ms at R-MAT 2^21;
// measured 0.062 ms, against 0.080 for torch.searchsorted and 0.81 for
// the atomic count it replaces (phase 3b, the same card).
//
// segment_or.  Two launches.  The first packs the bool flags into bits
// (a warp a 32-bit word, by ballot; 256 KB at 2^21 vertices) and zeroes
// out.  In the second a thread takes 4 rounds of 4 consecutive live slots
// of the order: per round one 16-byte streaming load of their sources,
// then their flag bits, then, only for a round with a flag set, one
// 16-byte load of their sorted dst; each stage's loads are in flight
// together.  A slot whose flag is set stores a byte 1 to out[dst].  The
// stores are plain, not atomic: every writer of a byte stores the same
// value.  The sorted dst of neighbouring lanes are equal or neighbouring,
// so the stores coalesce, and the cost barely grows with the frontier
// (slot_count's gathered count paid an atomic per set slot).  The live
// count is read on the card from ptr[V]: no host read.  What sets the
// time is the 32.4 M random flag gathers: from the 2 MB of bool bytes
// they went to L2 (0.174 / 0.213 / 0.205 ms at a 1 % / ~50 % / 100 %
// frontier); the 256 KB of bits stay in each SM's L1 (the kernel takes no
// shared memory, and asks for all of it as L1): 0.092 / 0.126 / 0.126,
// the pack launch included, against the old route's 0.100 / 0.385 /
// 0.826 (phase 3b, one call; NVIDIA H100 80GB HBM3, 700 W).  Bound: the
// live slots' src read once, flags read and out written once, and ptr
// read once (a segment's ends, all a push_or needs; fewer bytes than the
// flagged slots' dst at any density here): (4 * 32.4 M + 4 * (2^21 + 1) +
// 2 * 2^21) B / 3.35 TB/s = 0.0425 ms at R-MAT 2^21, so the kernel is
// 2-3x its bound.  This design reads the flagged slots' dst in place of
// ptr (0.079 ms of bytes at a dense frontier); one that reads ptr is
// still to be tried.
//
// Every index of a set slot must lie in [0, n), every key in [0, V],
// sorted, and every live src in [0, len(flags)): the kernels do not
// check.  Each launches on the caller's stream, allocates nothing and
// does not synchronise (slot_count and segment_or into an output the
// caller zeroed); each C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRounds = 4;                // 32-slot rounds a warp loads
constexpr int kBlocksPerSm = 8;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kShortRun = 8;              // ptr entries a lane stores alone
constexpr int kOrRounds = 4;              // 4-slot groups a segment_or
                                          // thread loads at once

__global__ void __launch_bounds__(kThreads)
slot_count_kernel(const int32_t* __restrict__ index,
                  const uint8_t* __restrict__ weight,
                  const int32_t* __restrict__ gather,
                  const uint8_t* __restrict__ flags,
                  int32_t* __restrict__ out, int64_t num_slots) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * kThreads
                        + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * kThreads) >> 5;
  const int64_t tile = 32 * kRounds;
  for (int64_t base = warp * tile; base < num_slots; base += warps * tile) {
    bool set[kRounds];
    int32_t idx[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int64_t e = base + 32 * r + lane;
      set[r] = e < num_slots && __ldcs(weight + e) != 0;
    }
    if (gather != nullptr) {
#pragma unroll
      for (int r = 0; r < kRounds; ++r)
        if (set[r]) set[r] = __ldg(flags + __ldcs(gather + base + 32 * r
                                                  + lane)) != 0;
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r)
      idx[r] = set[r] ? __ldcs(index + base + 32 * r + lane) : 0;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const unsigned act = __ballot_sync(kAll, set[r]);
      if (set[r]) {
        const unsigned peers = __match_any_sync(act, idx[r]);
        if ((peers & ((1u << lane) - 1u)) == 0u)   // the group's first
          atomicAdd(out + idx[r], __popc(peers));
      }
    }
  }
}

// Keys 4g .. 4g+3 of the sorted order, V at and past its end n.
template <bool kVec>
__device__ __forceinline__ void load_keys(const int32_t* __restrict__ keys,
                                          int64_t n, int64_t k0, int32_t v,
                                          int32_t (&key)[4]) {
  if (kVec && k0 + 4 <= n) {
    const int4 q = __ldcs(reinterpret_cast<const int4*>(keys + k0));
    key[0] = q.x; key[1] = q.y; key[2] = q.z; key[3] = q.w;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      key[r] = k0 + r < n ? __ldcs(keys + k0 + r) : v;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
segment_bounds_kernel(const int32_t* __restrict__ keys, int64_t n,
                      int32_t num_vertices, int32_t* __restrict__ ptr) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * kThreads
                        + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * kThreads) >> 5;
  const int64_t groups = n / 4 + 1;       // the last holds position n
  const int32_t V = num_vertices;
  for (int64_t base = 32 * warp; base < groups; base += 32 * warps) {
    const int64_t k0 = 4 * (base + lane);
    int32_t key[4];
    load_keys<kVec>(keys, n, k0, V, key);
    int32_t prev = __shfl_up_sync(kAll, key[3], 1);
    if (lane == 0)
      prev = k0 == 0 ? -1 : (k0 - 1 < n ? __ldcs(keys + k0 - 1) : V);
    const int32_t before[4] = {prev, key[0], key[1], key[2]};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // position k0 + r begins the segments before[r] + 1 .. key[r]
      const int32_t lo = before[r] + 1, hi = key[r];
      const int32_t at = static_cast<int32_t>(k0 + r);
      const bool run = lo <= hi;
      const bool wide = run && hi - lo >= kShortRun;
      if (run && !wide)
        for (int32_t v = lo; v <= hi; ++v) ptr[v] = at;
      for (unsigned w = __ballot_sync(kAll, wide); w != 0u; w &= w - 1u) {
        const int from = __ffs(w) - 1;
        const int32_t l = __shfl_sync(kAll, lo, from);
        const int32_t h = __shfl_sync(kAll, hi, from);
        const int32_t a = __shfl_sync(kAll, at, from);
        for (int32_t v = l + lane; v <= h; v += 32) ptr[v] = a;
      }
    }
    // lane 0's key before its keys is dead: so is every key after it
    if (__shfl_sync(kAll, prev, 0) == V) break;
  }
}

// Slots 4g .. 4g+3 of an int32 array: one 16-byte streaming load, or four
// scalar ones from an unaligned base.
template <bool kVec>
__device__ __forceinline__ int4 load4(const int32_t* __restrict__ p,
                                      int64_t g) {
  if (kVec) return __ldcs(reinterpret_cast<const int4*>(p) + g);
  return make_int4(__ldcs(p + 4 * g), __ldcs(p + 4 * g + 1),
                   __ldcs(p + 4 * g + 2), __ldcs(p + 4 * g + 3));
}

// bits[w] = bit j set for flags[32 w + j] != 0, a warp a word; and
// out[0..v) = 0, 16 bytes a thread (out is 16-byte aligned)
__global__ void __launch_bounds__(kThreads)
pack_flags_kernel(const uint8_t* __restrict__ flags, int64_t n,
                  uint32_t* __restrict__ bits, uint8_t* __restrict__ out,
                  int64_t v) {
  const int lane = threadIdx.x & 31;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads
                      + threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t words = (n + 31) / 32;
  for (int64_t w = tid >> 5; w < words; w += step >> 5) {
    const int64_t i = 32 * w + lane;
    const unsigned word = __ballot_sync(kAll, i < n && __ldcs(flags + i));
    if (lane == 0) bits[w] = word;
  }
  for (int64_t i = tid; i < v / 16; i += step)
    reinterpret_cast<int4*>(out)[i] = make_int4(0, 0, 0, 0);
  for (int64_t i = v / 16 * 16 + tid; i < v; i += step) out[i] = 0;
}

// flags[s] != 0, from the packed bits
__device__ __forceinline__ unsigned flag(const uint32_t* __restrict__ bits,
                                         int32_t s) {
  return (__ldg(bits + (s >> 5)) >> (s & 31)) & 1u;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
segment_or_kernel(const int32_t* __restrict__ src,
                  const int32_t* __restrict__ dst,
                  const int32_t* __restrict__ live_end,
                  const uint32_t* __restrict__ bits,
                  uint8_t* __restrict__ out) {
  const int64_t n = __ldg(live_end);      // live slots: ptr[V]
  const int64_t full = n / 4;             // whole groups of 4 slots
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads
                      + threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t g0 = tid; g0 < full; g0 += kOrRounds * step) {
    // every round's sources, then every flag, then the dst of a group
    // with a set flag: the loads of a stage in flight together
    int4 s[kOrRounds], d[kOrRounds];
    unsigned hit[kOrRounds];
#pragma unroll
    for (int r = 0; r < kOrRounds; ++r) {
      const int64_t g = g0 + r * step;
      s[r] = g < full ? load4<kVec>(src, g) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int r = 0; r < kOrRounds; ++r)
      hit[r] = g0 + r * step < full
               ? flag(bits, s[r].x) | flag(bits, s[r].y) << 1
                 | flag(bits, s[r].z) << 2 | flag(bits, s[r].w) << 3
               : 0u;
#pragma unroll
    for (int r = 0; r < kOrRounds; ++r)
      d[r] = hit[r] ? load4<kVec>(dst, g0 + r * step) : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int r = 0; r < kOrRounds; ++r) {
      if (hit[r] & 1u) out[d[r].x] = 1;
      if (hit[r] & 2u) out[d[r].y] = 1;
      if (hit[r] & 4u) out[d[r].z] = 1;
      if (hit[r] & 8u) out[d[r].w] = 1;
    }
  }
  // the live slots past the last whole group: at most 3
  if (tid < n - 4 * full) {
    const int64_t k = 4 * full + tid;
    if (flag(bits, __ldcs(src + k))) out[__ldcs(dst + k)] = 1;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// blocks for `work` units of `per_block` each, at most kBlocksPerSm a SM
cudaError_t grid_for(int device, long long work, long long per_block,
                     int* blocks) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long want = (work + per_block - 1) / per_block;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  *blocks = static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
  return cudaSuccess;
}

}  // namespace

extern "C" int slot_count_launch(int device, const void* index,
                                 const void* weight, const void* gather,
                                 const void* flags, void* out,
                                 long long num_slots, void* stream) {
  // this library links its own CUDA runtime, whose current device is not
  // the caller's: select the tensors' device explicitly
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_slots > 0) {
    int blocks = 0;
    err = grid_for(device, (num_slots + 32 * kRounds - 1) / (32 * kRounds),
                   kThreads / 32, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    slot_count_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(index),
        static_cast<const uint8_t*>(weight),
        static_cast<const int32_t*>(gather),
        static_cast<const uint8_t*>(flags), static_cast<int32_t*>(out),
        static_cast<int64_t>(num_slots));
  }
  return static_cast<int>(cudaGetLastError());
}

// ptr[0..num_vertices] of the sorted keys[0..num_slots) (dead keys =
// num_vertices, last).  Writes every entry of ptr, so ptr needs no zeroing.
extern "C" int segment_bounds_launch(int device, const void* keys,
                                     long long num_slots, int num_vertices,
                                     void* ptr, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = grid_for(device, num_slots / 4 + 1, kThreads, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  auto k = static_cast<const int32_t*>(keys);
  auto p = static_cast<int32_t*>(ptr);
  if (aligned16(keys))
    segment_bounds_kernel<true><<<blocks, kThreads, 0, st>>>(
        k, num_slots, num_vertices, p);
  else
    segment_bounds_kernel<false><<<blocks, kThreads, 0, st>>>(
        k, num_slots, num_vertices, p);
  return static_cast<int>(cudaGetLastError());
}

// out[0..num_vertices) = the OR of flags[src[k]] over the live slots
// k < *live_end of a sorted order whose sorted dst (keys) are dst: a first
// launch packs the num_flags bool flags into bits (scratch of
// (num_flags + 31) / 32 words) and zeroes out (16-byte aligned), the
// second ORs.  num_slots (the order's length) only sizes the grid.
template <bool kVec>
cudaError_t launch_or(int device, const int32_t* s, const int32_t* d,
                      const int32_t* e, const uint32_t* b, uint8_t* o,
                      long long num_slots, cudaStream_t st) {
  auto kernel = segment_or_kernel<kVec>;
  // set up once a process: no shared memory, all of it to L1, where the
  // flags are gathered from; the resident blocks a SM at that
  static int per_sm = 0;
  cudaError_t err = cudaSuccess;
  if (per_sm == 0) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 0);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return err;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long want = (num_slots / 4 + kThreads * kOrRounds - 1)
                         / (kThreads * kOrRounds);
  const long long cap = static_cast<long long>(sms) * per_sm;
  const int blocks = static_cast<int>(want < 1 ? 1 : (want < cap ? want
                                                                 : cap));
  kernel<<<blocks, kThreads, 0, st>>>(s, d, e, b, o);
  return cudaSuccess;
}

extern "C" int segment_or_launch(int device, const void* src,
                                 const void* dst, const void* live_end,
                                 const void* flags, long long num_flags,
                                 void* bits, void* out,
                                 long long num_vertices, long long num_slots,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!aligned16(out)) return static_cast<int>(cudaErrorMisalignedAddress);
  auto st = static_cast<cudaStream_t>(stream);
  int blocks = 0;
  const long long words = (num_flags + 31) / 32;
  const long long zero16 = num_vertices / 16 + 1;
  err = grid_for(device, 32 * words > zero16 ? 32 * words : zero16,
                 kThreads, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  pack_flags_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(flags), num_flags,
      static_cast<uint32_t*>(bits), static_cast<uint8_t*>(out),
      num_vertices);
  if (num_slots > 0) {
    auto s = static_cast<const int32_t*>(src);
    auto d = static_cast<const int32_t*>(dst);
    auto e = static_cast<const int32_t*>(live_end);
    auto b = static_cast<const uint32_t*>(bits);
    auto o = static_cast<uint8_t*>(out);
    err = aligned16(src) && aligned16(dst)
              ? launch_or<true>(device, s, d, e, b, o, num_slots, st)
              : launch_or<false>(device, s, d, e, b, o, num_slots, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
