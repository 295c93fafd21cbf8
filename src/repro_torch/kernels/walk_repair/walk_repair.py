"""Suffix resampling of stale PPR walks (twin of
``repro.kernels.walk_repair.walk_repair``).

``resample_rows`` re-walks each compacted stale walk on the new CSR,
keeping its prefix [0..t0], with the walk's own threefry draws: hop t of
walk i draws from ``fold_in(fold_in(key, i), t)`` (``threefry``).
Dispatch is by device: a CPU ``rows`` runs the plain version
(``ref.resample_rows_keyed_ref``, which makes every draw up front); a
CUDA ``rows`` launches the hand-written kernel ``csrc/walk_repair.cu``,
which makes only the draws the recurrence reads; a ``meta`` ``rows``
runs the launch path with no launch (``kernels.work``).  There is no
fallback: a failed build or launch raises.

The kernel has no atomics and its only float operations are exact or
single IEEE float32 operations, so it equals the plain version bit for
bit.  ``LAUNCH_COUNTS`` counts launches of the kernel (plain-version
calls are not counted).
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.graph.structure import CSRView
from repro_torch.kernels import work
from repro_torch.kernels.build import check_arg
from repro_torch.kernels.walk_repair.ref import resample_rows_keyed_ref
from repro_torch.kernels.walk_repair.threefry import MASK, Key

LAUNCH_COUNTS: collections.Counter = collections.Counter()

MAX_LEN = 100          # slots a walk may hold (the kernel's shared rows)

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
             + [ctypes.c_uint32] * 2 + [ctypes.c_float, ctypes.c_void_p])
_check = functools.partial(check_arg, "walk_repair")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load("walk_repair")
    lib.walk_repair_launch.argtypes = _ARGTYPES
    lib.walk_repair_launch.restype = ctypes.c_int
    lib.walk_repair_info.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]
    lib.walk_repair_info.restype = ctypes.c_int
    return lib


def kernel_info(max_len: int, device=None) -> dict:
    """What the kernel takes on the card for walks of ``max_len`` slots:
    shared memory a block, resident blocks a SM, registers a thread, the
    SMs and the walks a block owns."""
    index = None if device is None else torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    info = (ctypes.c_int * 6)()
    rc = _lib().walk_repair_info(index, max_len, ctypes.addressof(info))
    if rc != 0:
        raise RuntimeError(f"walk_repair_info failed: CUDA error {rc}")
    return dict(smem_per_block=info[0], blocks_per_sm=info[1],
                registers=info[2], sms=info[3], walks_per_block=info[4],
                max_len=info[5])


def _key_words(key: Key):
    words = tuple(int(k) for k in key)
    if len(words) != 2 or not all(0 <= k <= MASK for k in words):
        raise ValueError(f"walk_repair: key must be two uint32 words, got "
                         f"{key!r}")
    return words


def _launch_kernel(csr: CSRView, rows: torch.Tensor, t0: torch.Tensor,
                   key: Key, ids: torch.Tensor,
                   alpha: float) -> torch.Tensor:
    C, L = rows.shape
    dev = rows.device
    V, E = csr.deg.shape[0], csr.indices.shape[0]
    _check("rows", rows, torch.int32, (C, L), dev)
    _check("t0", t0, torch.int32, (C,), dev)
    _check("ids", ids, torch.int64, (C,), dev)
    _check("indptr", csr.indptr, torch.int32, (V + 1,), dev)
    _check("indices", csr.indices, torch.int32, (E,), dev)
    _check("deg", csr.deg, torch.int32, (V,), dev)
    k0, k1 = _key_words(key)
    if L > MAX_LEN:
        raise ValueError(f"walk_repair: walks of {L} slots exceed the "
                         f"kernel's {MAX_LEN}")
    if E == 0:
        raise ValueError("walk_repair: the CSR has no edge slots")
    out = torch.empty_like(rows)
    if C == 0:
        return out
    if dev.type == "meta":                 # the dry-run: no launch
        hops = C * (L - 1)                 # every walk redrawn from t0 = 0
        work.record("walk_repair", *work.walk_repair_work(
            C, L, C, min(V, hops), min(E, hops), C + 3 * hops),
            integer=True)
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().walk_repair_launch(
            torch.cuda.current_device(), csr.indptr.data_ptr(),
            csr.indices.data_ptr(), csr.deg.data_ptr(), rows.data_ptr(),
            t0.data_ptr(), ids.data_ptr(), out.data_ptr(), C, L, E, k0, k1,
            float(alpha), stream)
    if rc != 0:
        raise RuntimeError(f"walk_repair kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCH_COUNTS["walk_repair"] += 1
    return out


def resample_rows(csr: CSRView, rows: torch.Tensor, t0: torch.Tensor,
                  key: Key, ids: torch.Tensor, *,
                  alpha: float) -> torch.Tensor:
    """Re-walk ``rows`` (int32[C, L]) on ``csr``, keeping each row's prefix
    [0..t0], with the draws of walks ``ids`` (int64[C], taken mod 2**32)
    under the index's base ``key`` (two uint32 words).  Returns
    int32[C, L]."""
    if rows.shape[1] == 1:
        return rows
    if rows.device.type == "cpu":
        return resample_rows_keyed_ref(csr, rows, t0, key, ids, alpha=alpha)
    if rows.device.type not in ("cuda", "meta"):
        raise ValueError(f"walk_repair: no kernel for device {rows.device}")
    return _launch_kernel(csr, rows, t0, key, ids, alpha)
