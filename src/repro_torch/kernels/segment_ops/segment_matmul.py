"""Gated blocked segment-SpMM: GNN message aggregation on the packed
structure (twin of ``repro.kernels.segment_ops.segment_matmul``).

Same frontier-window gating as ``kernels.pagerank_spmv``, but it sums
*feature rows* instead of scalars:

    out[v, :] = Σ_{u→v} X[u, :]        for v in active dst windows, else 0

i.e. ``A_maskᵀ @ X`` with dst-window granular skipping: the aggregation
behind ``core/incremental_gnn.py``'s frontier.

``gated_spmm`` dispatches on where ``feats`` lies: on the CPU it runs the
plain version (``ref.gated_spmm_ref``); on a CUDA device it launches the
hand-written kernel ``csrc/gated_spmm.cu``: one block per (chunk of at
most ``chunk_entries`` entries, column block) of the chunk plan
(``plan.py``, built once per packed structure), then a second pass that
adds a split window's partial tiles in chunk order.  No atomics, so its
result is the same bit for bit from run to run.  A ``meta`` ``feats``
runs the launch path with no launch (``kernels.work``).  There is no
fallback: a failed build or launch raises.  ``LAUNCH_COUNTS`` counts
calls that launched the kernel, one per call whatever its device
launches (plain-version calls are not counted).
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.kernels import work
from repro_torch.kernels.build import check_arg
from repro_torch.kernels.pagerank_spmv.pagerank_spmv import PackedGraph
from repro_torch.kernels.segment_ops.plan import cached_plan, plan_sizes
from repro_torch.kernels.segment_ops.ref import gated_spmm_ref

LAUNCH_COUNTS: collections.Counter = collections.Counter()

# entries a block walks at most: 16,384 lanes at BE = 512, so the R-MAT
# hub window of the smoke (1,518 entries) is 48 chunks
CHUNK_ENTRIES = 32

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 14
             + [ctypes.c_int] * 7 + [ctypes.c_void_p])
# rows a window may hold: the kernel's bitmap of rows met is 32 x 32 bits
_MAX_VB = 1024
_check = functools.partial(check_arg, "gated_spmm")


def _lib():
    from repro_torch.kernels.build import load
    lib = load("gated_spmm")
    lib.gated_spmm_launch.argtypes = _ARGTYPES
    lib.gated_spmm_launch.restype = ctypes.c_int
    lib.gated_spmm_info.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.gated_spmm_info.restype = ctypes.c_int
    return lib


def scratch_bytes(packed: PackedGraph, d: int,
                  chunk_entries: int = CHUNK_ENTRIES) -> int:
    """Bytes of the partial tiles a call allocates: one VB x D f32 tile
    for each of the plan's ``NE // chunk_entries`` partial slots."""
    _, parts, _ = plan_sizes(packed.num_windows, packed.num_entries,
                             chunk_entries)
    return parts * packed.vb * d * 4


def scratch_bytes_used(packed: PackedGraph, d: int,
                       chunk_entries: int = CHUNK_ENTRIES) -> int:
    """Bytes of the partial tiles the split windows write: one tile for
    each chunk after a window's first (a host read of the plan)."""
    plan = cached_plan(packed.entry_start, packed.num_entries,
                       chunk_entries)
    real = plan.window < packed.num_windows
    return int(((plan.part >= 0) & real).sum()) * packed.vb * d * 4


def kernel_info(packed: PackedGraph, d: int,
                chunk_entries: int = CHUNK_ENTRIES,
                device=None) -> dict:
    """What the kernel holds on the card (8-byte loads): shared memory a
    block, resident blocks a SM, registers a thread, lanes in flight a
    warp, X bytes in flight a SM at most; and at this shape K, the
    scratch bytes a call allocates (the bound ``NE // K`` tiles) and those
    the split windows use."""
    dev = torch.device(device or torch.cuda.current_device())
    info = (ctypes.c_int * 5)()
    with torch.cuda.device(dev):
        rc = _lib().gated_spmm_info(torch.cuda.current_device(),
                                    ctypes.addressof(info))
    if rc != 0:
        raise RuntimeError(f"gated_spmm_info failed: CUDA error {rc}")
    return dict(chunk_entries=chunk_entries,
                scratch_bytes=scratch_bytes(packed, d, chunk_entries),
                scratch_bytes_used=scratch_bytes_used(packed, d,
                                                      chunk_entries),
                smem_per_block=info[0], blocks_per_sm=info[1],
                registers=info[2], lanes_in_flight=info[3],
                inflight_bytes_per_sm=info[4])


def _launch_kernel(packed: PackedGraph, feats: torch.Tensor,
                   active_window: torch.Tensor,
                   chunk_entries: int) -> torch.Tensor:
    ne, be = packed.src.shape
    vb, nw, n = packed.vb, packed.num_windows, packed.num_vertices
    dev = feats.device
    d = feats.shape[1]
    if not 0 < vb <= _MAX_VB:
        raise ValueError(f"gated_spmm: vb {vb} outside (0, {_MAX_VB}]")
    if chunk_entries < 1:
        raise ValueError(f"gated_spmm: chunk_entries must be >= 1, got "
                         f"{chunk_entries}")
    _check("src", packed.src, torch.int32, (ne, be), dev)
    _check("dst_rel", packed.dst_rel, torch.int32, (ne, be), dev)
    _check("valid", packed.valid, torch.float32, (ne, be), dev)
    _check("entry_start", packed.entry_start, torch.int32, (nw + 1,), dev)
    _check("active_window", active_window, torch.bool, (nw,), dev)
    _check("feats", feats, torch.float32, (feats.shape[0], d), dev)
    out = torch.empty(n, d, dtype=torch.float32, device=dev)
    if n == 0 or d == 0:
        return out
    plan = cached_plan(packed.entry_start, ne, chunk_entries)
    partial = torch.empty(plan.num_partials * vb * d, dtype=torch.float32,
                          device=dev)
    if dev.type == "meta":                 # the dry-run: no launch
        n_live = ne * be
        work.record("gated_spmm", *work.gated_spmm_work(
            be, nw, n, d, ne, n_live, min(feats.shape[0], n_live)))
        return out
    fn = _lib().gated_spmm_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(torch.cuda.current_device(), packed.src.data_ptr(),
                packed.dst_rel.data_ptr(), packed.valid.data_ptr(),
                *(t.data_ptr() for t in plan[:7]), active_window.data_ptr(),
                feats.data_ptr(), out.data_ptr(), partial.data_ptr(),
                plan.window.shape[0], plan.split_window.shape[0], nw, be, vb,
                n, d, stream)
    if rc != 0:
        raise RuntimeError(f"gated_spmm kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCH_COUNTS["gated_spmm"] += 1
    return out


def gated_spmm(packed: PackedGraph, feats: torch.Tensor,
               active_window: torch.Tensor, *,
               chunk_entries: int = CHUNK_ENTRIES) -> torch.Tensor:
    """feats: [>= num_vertices, D] (cast to f32) -> f32[num_vertices, D]
    gated aggregation; rows of inactive windows are exactly 0.
    active_window: bool[NW].  A CPU ``feats`` runs the plain version; a
    CUDA ``feats`` launches the kernel, whose blocks walk at most
    ``chunk_entries`` entries each (the plain version does not split)."""
    if feats.dim() != 2 or feats.shape[0] < packed.num_vertices:
        raise ValueError(f"gated_spmm: feats must be [>= "
                         f"{packed.num_vertices}, D], got "
                         f"{tuple(feats.shape)}")
    feats = feats.to(torch.float32)
    if feats.device.type == "cpu":
        return gated_spmm_ref(packed.src, packed.dst_rel, packed.valid,
                              packed.window, feats, active_window,
                              packed.num_vertices, packed.vb)
    if feats.device.type not in ("cuda", "meta"):
        raise ValueError(f"gated_spmm: no kernel for device {feats.device}")
    return _launch_kernel(packed, feats, active_window, chunk_entries)
