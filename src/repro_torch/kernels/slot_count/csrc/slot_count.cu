// Segment count of edge slots for Hopper (sm_90a): the degrees and the
// frontier pushes of the PageRank loops,
//     out[index[e]] += 1   for every slot e with weight[e] set
//                          (and flags[gather[e]] set, when given).
//
// The port's own kernel: it replaces no Pallas kernel.  It replaces the
// int32 `index_add_` that counted the degrees and frontier pushes of
// repro_torch/graph/structure.py (`out_degree`, `in_degree`, `push_or`,
// `to_device_csr`).  That CUDA `index_add_` issues one atomic add per
// slot, zero weights included, and a graph's free slots all carry
// src = dst = 0 (`from_coo` pads with vertex 0): at R-MAT 2^21, 16.2 M
// atomic adds of 0 piled up on one address a call, 12.07 of its
// 13.17 ms (chip_smoke.py phase 3b; NVIDIA H100 80GB HBM3, 700 W).
// Plain version: repro_torch/kernels/slot_count/ref.py `slot_count_ref`
// (that `index_add_`).
//
// Design.  A warp takes 4 rounds of 32 consecutive slots at a time, all
// loads issued before the adds: the weights coalesced; with a gather,
// gather[e] and flags[gather[e]] only for a slot whose weight is set; the
// index only for a slot still counted.  A slot whose weight (or flag) is
// 0 issues no atomic and reads no index.  In each round the
// lanes with a set slot that share an index find each other with
// __match_any_sync, and the lowest of them adds their number with one
// atomicAdd: a hub's slots, or the runs of equal src of a src-sorted
// edge list, become one atomic a warp instead of up to 32.  The counts
// are integers, so the result is exact in any order and equals the CPU's
// `index_add_`.
//
// Bound.  Bytes: every slot's weight read once; the index of a counted
// slot only, and with a gather the gather index of a slot whose weight
// is set (each by its 32-byte sectors); flags once and the int32 output
// written once; the atomics go to the output, which the L2 cache holds
// (8 MB at 2^21 vertices).  Phase 3b, same card: `in_degree` 0.657 ms
// against a 0.056 ms bound (32.4 M set slots, each an atomic to a
// scattered address), a 1 % `push_or` 0.095 ms against 0.057.
//
// Every index of a set slot must lie in [0, n): the kernel does not
// check.  It launches on the caller's stream into an output the caller
// zeroed, allocates nothing and does not synchronise; the C entry point
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRounds = 4;                // 32-slot rounds a warp loads
constexpr int kBlocksPerSm = 8;
constexpr unsigned kAll = 0xffffffffu;

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

}  // namespace

extern "C" int slot_count_launch(int device, const void* index,
                                 const void* weight, const void* gather,
                                 const void* flags, void* out,
                                 long long num_slots, void* stream) {
  // this library links its own CUDA runtime, whose current device is not
  // the caller's: select the tensors' device explicitly
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_slots > 0) {
    const long long tiles = (num_slots + 32 * kRounds - 1) / (32 * kRounds);
    const long long want = (tiles + kThreads / 32 - 1) / (kThreads / 32);
    const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
    const int blocks = static_cast<int>(want < cap ? want : cap);
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
