"""Gated blocked segment-SpMM: GNN message aggregation on the packed
structure (twin of ``repro.kernels.segment_ops.segment_matmul``).

Same frontier-window gating as ``kernels.pagerank_spmv``, but it sums
*feature rows* instead of scalars:

    out[v, :] = Σ_{u→v} X[u, :]        for v in active dst windows, else 0

i.e. ``A_maskᵀ @ X`` with dst-window granular skipping: the aggregation
behind ``core/incremental_gnn.py``'s frontier.

``gated_spmm`` dispatches on where ``feats`` lies: on the CPU it runs the
plain version (``ref.gated_spmm_ref``); on a CUDA device it launches the
hand-written kernel ``csrc/gated_spmm.cu``, one block per (window,
64-column tile), with no atomics, so its result is the same bit for bit
from run to run.  There is no fallback: a failed build or launch raises.
``LAUNCH_COUNTS`` counts launches of the kernel (plain-version calls are
not counted).
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.kernels.build import check_arg
from repro_torch.kernels.pagerank_spmv.pagerank_spmv import PackedGraph
from repro_torch.kernels.segment_ops.ref import gated_spmm_ref

LAUNCH_COUNTS: collections.Counter = collections.Counter()

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 7
             + [ctypes.c_int] * 5 + [ctypes.c_void_p])
_TILE = 64                       # feature columns a block owns (the .cu's)
# a VB x 64 f32 accumulator tile within a block's 227 KB of shared memory
_MAX_VB = 232448 // (_TILE * 4)
_check = functools.partial(check_arg, "gated_spmm")


def _kernel_fn():
    from repro_torch.kernels.build import load
    fn = load("gated_spmm").gated_spmm_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch_kernel(packed: PackedGraph, feats: torch.Tensor,
                   active_window: torch.Tensor) -> torch.Tensor:
    ne, be = packed.src.shape
    vb, nw, n = packed.vb, packed.num_windows, packed.num_vertices
    dev = feats.device
    d = feats.shape[1]
    if not 0 < vb <= _MAX_VB:
        raise ValueError(f"gated_spmm: vb {vb} outside (0, {_MAX_VB}]")
    _check("src", packed.src, torch.int32, (ne, be), dev)
    _check("dst_rel", packed.dst_rel, torch.int32, (ne, be), dev)
    _check("valid", packed.valid, torch.float32, (ne, be), dev)
    _check("entry_start", packed.entry_start, torch.int32, (nw + 1,), dev)
    _check("active_window", active_window, torch.bool, (nw,), dev)
    _check("feats", feats, torch.float32, (feats.shape[0], d), dev)
    out = torch.empty(n, d, dtype=torch.float32, device=dev)
    if n == 0 or d == 0:
        return out
    fn = _kernel_fn()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(torch.cuda.current_device(), packed.src.data_ptr(),
                packed.dst_rel.data_ptr(), packed.valid.data_ptr(),
                packed.entry_start.data_ptr(), active_window.data_ptr(),
                feats.data_ptr(), out.data_ptr(), nw, be, vb, n, d, stream)
    if rc != 0:
        raise RuntimeError(f"gated_spmm kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCH_COUNTS["gated_spmm"] += 1
    return out


def gated_spmm(packed: PackedGraph, feats: torch.Tensor,
               active_window: torch.Tensor) -> torch.Tensor:
    """feats: [>= num_vertices, D] (cast to f32) -> f32[num_vertices, D]
    gated aggregation; rows of inactive windows are exactly 0.
    active_window: bool[NW].  A CPU ``feats`` runs the plain version; a
    CUDA ``feats`` launches the kernel."""
    if feats.dim() != 2 or feats.shape[0] < packed.num_vertices:
        raise ValueError(f"gated_spmm: feats must be [>= "
                         f"{packed.num_vertices}, D], got "
                         f"{tuple(feats.shape)}")
    feats = feats.to(torch.float32)
    if feats.device.type == "cpu":
        return gated_spmm_ref(packed.src, packed.dst_rel, packed.valid,
                              packed.window, feats, active_window,
                              packed.num_vertices, packed.vb)
    if feats.device.type != "cuda":
        raise ValueError(f"gated_spmm: no kernel for device {feats.device}")
    return _launch_kernel(packed, feats, active_window)
