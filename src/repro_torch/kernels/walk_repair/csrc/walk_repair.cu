// Walk-repair kernel for Hopper (sm_90a): re-walks stale PPR walks.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/walk_repair/walk_repair.py  resample_rows
//   (kernel body `_kernel`).
// Plain version: repro_torch/kernels/walk_repair/ref.py.
//
// What it computes.  Each of C compacted stale walks has a stored row
// rows[c, 0..L-1] (int32 vertices, -1 once terminated), a first stale hop
// t0[c], and precomputed uniforms u[c, t-1, 0..1] for hops t = 1..L-1.
// The walk keeps slots [0..t0] and re-rolls every later hop on the new CSR:
//     alive &= u_cont < alpha
//     j      = min(int(u_choice * f32(deg[cur] + 1)), deg[cur])
//     next   = cur if j == deg[cur] (the implicit self-loop)
//              else indices[clip(indptr[cur] + j, 0, E_cap - 1)]
//     out[t] = rows[t] if t <= t0 else (next if alive else -1)
//     cur    = out[t] if out[t] >= 0 else cur
//
// Design.  The TPU kernel packs 128 walks into the lanes of one grid
// program, holds the whole CSR in VMEM and re-maps excess grid steps of a
// pow2 capacity onto the last active bucket.  None of that carries over:
//   * one thread per walk; each thread runs its L-1 dependent hops in a
//     loop, gathering deg, indptr and indices through the read-only path
//     (the CSR of a 2^21-vertex graph is ~200 MB: no shared-memory copy);
//   * the grid covers exactly the C walks the host already counted (the
//     repair's one host read), so no block is idle and nothing is gated;
//   * the uniforms come in precomputed: the threefry draws are made by the
//     caller in plain torch (repro_torch/ppr/threefry.py), which keeps the
//     kernel's output a pure function of its inputs.
//
// Bitwise contract.  No atomics and no float sums: the only float
// operation is u_choice * f32(deg + 1), done as __int2float_rn, __fmul_rn
// and __float2int_rz (no --use_fast_math, no contraction can apply), the
// IEEE round-to-nearest multiply and truncating convert that torch and
// XLA use.  So the kernel equals the plain version bit for bit.
//
// Bound.  A chain of dependent gathers with one multiply a hop: bytes
// bound on paper, latency bound in practice (each hop waits on the
// previous gather).  Least time = bytes / 3.35 TB/s, bytes = the kept
// prefix rows[0..t0], t0, the draws the walk consumes, deg/indptr/indices
// once per distinct entry the hops read, and the output (chip_smoke.py
// walk_repair_bound).
//
// It launches on the caller's stream, allocates nothing and does not
// synchronise; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
walk_repair_kernel(const int32_t* __restrict__ indptr,
                   const int32_t* __restrict__ indices,
                   const int32_t* __restrict__ deg,
                   const int32_t* __restrict__ rows,
                   const int32_t* __restrict__ t0,
                   const float* __restrict__ u,
                   int32_t* __restrict__ out,
                   int num_walks, int max_len, int num_edges, float alpha) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= num_walks) return;
  const int32_t* row = rows + static_cast<size_t>(c) * max_len;
  const float* uc = u + static_cast<size_t>(c) * (max_len - 1) * 2;
  int32_t* o = out + static_cast<size_t>(c) * max_len;
  const int32_t keep = __ldg(t0 + c);

  const int32_t rows0 = __ldg(row);
  int32_t cur = rows0 > 0 ? rows0 : 0;
  bool alive = rows0 >= 0;
  o[0] = rows0;
  for (int t = 1; t < max_len; ++t) {
    const float2 ut = __ldg(reinterpret_cast<const float2*>(uc) + (t - 1));
    alive = alive && (ut.x < alpha);
    int32_t val;
    if (t <= keep) {
      val = __ldg(row + t);
    } else if (!alive) {
      val = -1;
    } else {
      const int32_t d = __ldg(deg + cur);
      int32_t j = __float2int_rz(__fmul_rn(ut.y, __int2float_rn(d + 1)));
      j = j < d ? j : d;
      if (j >= d) {
        val = cur;
      } else {
        int32_t idx = __ldg(indptr + cur) + j;
        idx = idx < 0 ? 0 : (idx > num_edges - 1 ? num_edges - 1 : idx);
        val = __ldg(indices + idx);
      }
    }
    if (val >= 0) cur = val;
    o[t] = val;
  }
}

}  // namespace

extern "C" int walk_repair_launch(int device, const void* indptr,
                                  const void* indices, const void* deg,
                                  const void* rows, const void* t0,
                                  const void* u, void* out, int num_walks,
                                  int max_len, int num_edges, float alpha,
                                  void* stream) {
  // this library links its own CUDA runtime, whose current device is not
  // the caller's: select the tensors' device explicitly
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_walks > 0 && max_len > 1) {
    const int blocks = (num_walks + kThreads - 1) / kThreads;
    walk_repair_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(indptr),
        static_cast<const int32_t*>(indices),
        static_cast<const int32_t*>(deg), static_cast<const int32_t*>(rows),
        static_cast<const int32_t*>(t0), static_cast<const float*>(u),
        static_cast<int32_t*>(out), num_walks, max_len, num_edges, alpha);
  }
  return static_cast<int>(cudaGetLastError());
}
