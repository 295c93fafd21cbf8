// Frontier-gated blocked SpMV for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/pagerank_spmv/pagerank_spmv.py  frontier_spmv_padded
//   (kernel body `_kernel`, wrapper `frontier_spmv`).
// Plain version: repro_torch/kernels/pagerank_spmv/ref.py.
//
// What it computes.  Edges are packed into entries of BE lanes; entry e
// belongs to dst window w = window[e] of VB consecutive vertices.  For
// every window that is active,
//     out[w*VB + r] = sum over lanes l of entries e with window[e] == w
//                     and dst_rel[e,l] == r  of  rsc[src[e,l]] * valid[e,l]
// and out is exactly 0 in every inactive window.  rsc is f32 or bf16
// (widened with __bfloat162float); sums are f32.
//
// Design.  The TPU kernel compacts the active entries with scalar
// prefetch, keeps the whole rsc vector in VMEM and scatters with a one-hot
// MXU product.  None of that maps to the card:
//   * one block per entry (NE blocks, a grid that needs no host read of the
//     active count); a block whose window is inactive returns at once, so
//     the card reads BE lanes only for active entries;
//   * rsc (8 MB in f32 at 2^21 vertices) does not fit shared memory, so it
//     is gathered from global memory through the read-only path (it fits
//     the 50 MB L2);
//   * each block sums its lanes into a VB-float shared-memory row with
//     shared atomics, then adds the nonzero slots of that row into the
//     output with one global atomic each.  The output is zeroed first with
//     cudaMemsetAsync on the same stream, so inactive windows stay exactly
//     0 and a window split over several entries (hub windows) is summed
//     across blocks.  Per-entry blocks keep hub windows from serialising on
//     one SM.
//
// Bound.  It is a gather plus a segmented sum with no matrix product, so
// no tensor-core work: memory bound.  Least time = bytes / 3.35 TB/s with
// bytes = 4 per lane of an active entry (valid) + 8 per live lane of an
// active entry (src, dst_rel; a padding lane needs neither) + 4 per entry
// (window) + NW (active_window) + rsc entries gathered + 4*NW*VB written.
//
// Determinism.  Float atomics (shared and global) add in an order that
// changes from run to run, so results are NOT bitwise reproducible; they
// agree with the plain version to f32 summation-order error, and every
// tolerance that holds this kernel is stated on that basis.
//
// It launches on the caller's stream, allocates nothing and does not
// synchronise; the C entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_rank(const float* __restrict__ p,
                                           int32_t i) {
  return __ldg(p + i);
}

__device__ __forceinline__ float load_rank(
    const __nv_bfloat16* __restrict__ p, int32_t i) {
  return __bfloat162float(p[i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
frontier_spmv_kernel(const int32_t* __restrict__ src,
                     const int32_t* __restrict__ dst_rel,
                     const float* __restrict__ valid,
                     const int32_t* __restrict__ window,
                     const uint8_t* __restrict__ active_window,
                     const T* __restrict__ rsc, float* __restrict__ out,
                     int be, int vb) {
  extern __shared__ float acc[];
  const int e = blockIdx.x;
  const int w = window[e];
  if (!active_window[w]) return;  // the whole block leaves together

  for (int i = threadIdx.x; i < vb; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const size_t base = static_cast<size_t>(e) * be;
  for (int l = threadIdx.x; l < be; l += blockDim.x) {
    const float v = valid[base + l];
    if (v != 0.f) {
      atomicAdd(&acc[dst_rel[base + l]], load_rank(rsc, src[base + l]) * v);
    }
  }
  __syncthreads();

  float* row = out + static_cast<size_t>(w) * vb;
  for (int i = threadIdx.x; i < vb; i += blockDim.x) {
    const float a = acc[i];
    if (a != 0.f) atomicAdd(row + i, a);
  }
}

}  // namespace

extern "C" int frontier_spmv_launch(int device, const void* src,
                                    const void* dst_rel, const void* valid,
                                    const void* window,
                                    const void* active_window,
                                    const void* rsc, int rsc_is_bf16,
                                    void* out, int ne, int be, int nw,
                                    int vb, void* stream) {
  // this library links its own CUDA runtime, whose current device is not
  // the caller's: select the tensors' device explicitly
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(nw) * vb * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ne > 0) {
    const size_t smem = static_cast<size_t>(vb) * sizeof(float);
    const auto* s32 = static_cast<const int32_t*>(src);
    const auto* d32 = static_cast<const int32_t*>(dst_rel);
    const auto* v32 = static_cast<const float*>(valid);
    const auto* w32 = static_cast<const int32_t*>(window);
    const auto* aw = static_cast<const uint8_t*>(active_window);
    float* o = static_cast<float*>(out);
    if (rsc_is_bf16) {
      frontier_spmv_kernel<__nv_bfloat16><<<ne, kThreads, smem, s>>>(
          s32, d32, v32, w32, aw, static_cast<const __nv_bfloat16*>(rsc),
          o, be, vb);
    } else {
      frontier_spmv_kernel<float><<<ne, kThreads, smem, s>>>(
          s32, d32, v32, w32, aw, static_cast<const float*>(rsc), o, be,
          vb);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
