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
//     out[w*VB + r, c] = sum over the lanes l of w's entries with
//                        dst_rel[l] == r  of  valid[l] * X[src[l], c]
// summed in lane order (every lane, as the plain version sums them)
// and every row of an inactive window is exactly 0.  X is f32
// [>= num_vertices, D] and out f32 [num_vertices, D], both row-major.
//
// Design.  The TPU kernel compacts the active entries with scalar
// prefetch, scatters each entry through a one-hot MXU product and carries
// a window's sum across consecutive grid steps (its `first` flag), which
// relies on the TPU running its grid in order.  On the card:
//   * one block per (window, 64-column tile) owns that tile of the
//     window's rows outright, so blocks may run in any order and need no
//     atomics; the grid needs no host read of the active count: a block of
//     an inactive window writes its zeros (the output comes from
//     torch.empty) and leaves;
//   * thread t owns column tile*64 + t and walks the window's lanes in
//     order, adding valid * X[src, col] into its own column of a VB x 64
//     f32 accumulator in shared memory (64 KB at VB = 256, above the 48 KB
//     default, hence cudaFuncSetAttribute).  The scatter is that add: no
//     one-hot tiles.  No two threads touch one accumulator, so there is no
//     barrier, the order of every sum is fixed (the result is the same bit
//     for bit from run to run) and a warp's read of an X row is 128
//     contiguous bytes;
//   * a thread loads 16 lanes' X values before it adds any, with no branch
//     between them, so a group's gathers can be in flight together (6-8
//     at once as ptxas schedules them, PERF.md);
//   * D is not padded: the last tile's spare threads leave at once.
//
// Bound.  No matrix product (each X value read is added once): bytes
// bound.  Least time = bytes / 3.35 TB/s with bytes = 8 per live lane of
// an active entry (src, dst_rel) + 4 per lane of an active entry (valid)
// + 4*D per distinct source row those lanes read + 4*D*num_vertices
// written.  The kernel reads an X row once per edge, not once per
// distinct source (about 7x the bound's bytes at 100 % active on an R-MAT
// graph of average degree 16), and the accumulator tile holds a SM to 3
// blocks (6 warps), so it is bound by gather latency.  A window that owns
// many entries (an R-MAT hub window) is walked by its blocks alone and can
// set the kernel's time.  Splitting hub windows, sharing a source row
// across tiles and staging rows with TMA are later work.
//
// It launches on the caller's stream, allocates nothing and does not
// synchronise; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;    // feature columns a block owns, one a thread
constexpr int kUnroll = 16;  // lanes whose X values a thread loads at once
// blocks a SM holds at VB = 256 (3 x 64 KB of the 227 KB).  Saying so lets
// ptxas give a thread the registers to keep a group's 16 gathers live;
// without it ptxas aims at 32 blocks a SM, caps a thread at 32 registers
// and interleaves each gather with its add (3-4 in flight, read in SASS).
constexpr int kBlocksPerSM = 3;

__global__ void __launch_bounds__(kTile, kBlocksPerSM)
gated_spmm_kernel(const int32_t* __restrict__ src,
                  const int32_t* __restrict__ dst_rel,
                  const float* __restrict__ valid,
                  const int32_t* __restrict__ entry_start,
                  const uint8_t* __restrict__ active_window,
                  const float* __restrict__ x, float* __restrict__ out,
                  int n_tiles, int be, int vb, int num_vertices, int d) {
  extern __shared__ float acc[];  // [vb][kTile]; column t is thread t's
  const int w = blockIdx.x / n_tiles;
  const int col = (blockIdx.x - w * n_tiles) * kTile + threadIdx.x;
  if (col >= d) return;  // there is no barrier: every thread works alone
  const int row0 = w * vb;
  const int rows = min(vb, num_vertices - row0);
  float* o = out + static_cast<size_t>(row0) * d + col;
  if (!active_window[w]) {
    for (int r = 0; r < rows; ++r) o[static_cast<size_t>(r) * d] = 0.f;
    return;
  }

  float* a = acc + threadIdx.x;
  for (int r = 0; r < vb; ++r) a[r * kTile] = 0.f;
  const float* xc = x + col;
  const size_t end = static_cast<size_t>(entry_start[w + 1]) * be;
  size_t l = static_cast<size_t>(entry_start[w]) * be;
  // Three stages a group, with no branch: a padding lane (src 0, valid 0)
  // gathers a cached row and adds 0, as the plain version does, so the 16
  // gathers of a group are independent loads that may be in flight
  // together.
  for (; l + kUnroll <= end; l += kUnroll) {
    int s[kUnroll], rel[kUnroll];
    float g[kUnroll], v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      s[k] = __ldg(src + l + k);
      rel[k] = __ldg(dst_rel + l + k);
      g[k] = __ldg(valid + l + k);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      v[k] = __ldg(xc + static_cast<size_t>(s[k]) * d);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) a[rel[k] * kTile] += v[k] * g[k];
  }
  for (; l < end; ++l) {
    const size_t s = static_cast<size_t>(__ldg(src + l));
    a[__ldg(dst_rel + l) * kTile] += __ldg(xc + s * d) * __ldg(valid + l);
  }
  for (int r = 0; r < rows; ++r) o[static_cast<size_t>(r) * d] = a[r * kTile];
}

}  // namespace

extern "C" int gated_spmm_launch(int device, const void* src,
                                 const void* dst_rel, const void* valid,
                                 const void* entry_start,
                                 const void* active_window, const void* x,
                                 void* out, int nw, int be, int vb,
                                 int num_vertices, int d, void* stream) {
  // this library links its own CUDA runtime, whose current device is not
  // the caller's: select the tensors' device explicitly
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (d + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(nw) * n_tiles;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (blocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int smem = vb * kTile * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(gated_spmm_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gated_spmm_kernel<<<static_cast<unsigned>(blocks), kTile, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst_rel),
      static_cast<const float*>(valid),
      static_cast<const int32_t*>(entry_start),
      static_cast<const uint8_t*>(active_window),
      static_cast<const float*>(x), static_cast<float*>(out), n_tiles, be,
      vb, num_vertices, d);
  return static_cast<int>(cudaGetLastError());
}
