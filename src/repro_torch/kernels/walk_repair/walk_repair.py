"""Suffix resampling of stale PPR walks (twin of
``repro.kernels.walk_repair.walk_repair``).

``resample_rows`` re-walks each compacted stale walk on the new CSR,
keeping its prefix [0..t0], with per-hop uniforms the caller precomputed
(``ppr.repair``).  Dispatch is by device: a CPU ``rows`` runs the plain
version (``ref.resample_rows_ref``); a CUDA ``rows`` launches the
hand-written kernel ``csrc/walk_repair.cu``, one thread per walk, over
exactly C walks.  There is no fallback: a failed build or launch raises.

The kernel has no atomics and its only float operation is an IEEE float32
multiply, so it equals the plain version bit for bit.  ``LAUNCH_COUNTS``
counts launches of the kernel (plain-version calls are not counted).
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.graph.structure import CSRView
from repro_torch.kernels.walk_repair.ref import resample_rows_ref

LAUNCH_COUNTS: collections.Counter = collections.Counter()

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 7
             + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])


def _kernel_fn():
    from repro_torch.kernels.build import load
    fn = load("walk_repair").walk_repair_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"walk_repair: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"walk_repair: {name} must have shape "
                         f"{tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"walk_repair: {name} is on {t.device}, expected "
                         f"{device}")
    if not t.is_contiguous():
        raise ValueError(f"walk_repair: {name} must be contiguous")


def _launch_kernel(csr: CSRView, rows: torch.Tensor, t0: torch.Tensor,
                   u: torch.Tensor, alpha: float) -> torch.Tensor:
    C, L = rows.shape
    dev = rows.device
    V, E = csr.deg.shape[0], csr.indices.shape[0]
    _check("rows", rows, torch.int32, (C, L), dev)
    _check("t0", t0, torch.int32, (C,), dev)
    _check("u", u, torch.float32, (C, L - 1, 2), dev)
    _check("indptr", csr.indptr, torch.int32, (V + 1,), dev)
    _check("indices", csr.indices, torch.int32, (E,), dev)
    _check("deg", csr.deg, torch.int32, (V,), dev)
    if u.data_ptr() % 8:
        raise ValueError("walk_repair: u must be 8-byte aligned (the kernel "
                         "reads (continue, choice) pairs as float2)")
    if E == 0:
        raise ValueError("walk_repair: the CSR has no edge slots")
    out = torch.empty_like(rows)
    if C == 0:
        return out
    fn = _kernel_fn()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(torch.cuda.current_device(), csr.indptr.data_ptr(),
                csr.indices.data_ptr(), csr.deg.data_ptr(), rows.data_ptr(),
                t0.data_ptr(), u.data_ptr(), out.data_ptr(), C, L, E,
                float(alpha), stream)
    if rc != 0:
        raise RuntimeError(f"walk_repair kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCH_COUNTS["walk_repair"] += 1
    return out


def resample_rows(csr: CSRView, rows: torch.Tensor, t0: torch.Tensor,
                  u: torch.Tensor, *, alpha: float) -> torch.Tensor:
    """Re-walk ``rows`` (int32[C, L]) on ``csr``, keeping each row's prefix
    [0..t0]; ``u`` f32[C, L-1, 2] are the precomputed per-hop uniforms
    ([..., 0] continue, [..., 1] choice).  Returns int32[C, L]."""
    if rows.shape[1] == 1:
        return rows
    if rows.device.type == "cpu":
        return resample_rows_ref(csr, rows, t0, u, alpha=alpha)
    if rows.device.type != "cuda":
        raise ValueError(f"walk_repair: no kernel for device {rows.device}")
    return _launch_kernel(csr, rows, t0, u, alpha)
