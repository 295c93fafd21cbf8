"""Plain PyTorch versions of the walk-repair kernel.

``resample_rows_ref`` is the twin of ``repro.kernels.walk_repair.ref``:
the hop recurrence on precomputed uniforms, one torch op per step.
``resample_rows_keyed_ref`` is the CUDA kernel's plain version
(``csrc/walk_repair.cu``): the same recurrence on the walks' own threefry
draws (``threefry.walk_uniforms``), all of them made up front.  The
kernel's output is bitwise identical to it: the draws are integer
arithmetic, and every step is an integer gather, an integer compare or
one IEEE float32 multiply with a truncating convert.
"""
from __future__ import annotations

import torch

from repro_torch.graph.structure import CSRView
from repro_torch.kernels.walk_repair.threefry import Key, walk_uniforms


def resample_rows_ref(csr: CSRView, rows: torch.Tensor, t0: torch.Tensor,
                      u: torch.Tensor, *, alpha: float) -> torch.Tensor:
    """Re-walk ``rows`` (int32[C, L]) on ``csr``, keeping each row's prefix
    [0..t0]; ``u`` f32[C, L-1, 2] are the per-hop uniforms ([..., 0]
    continue, [..., 1] choice).  Returns int32[C, L]."""
    C, L = rows.shape
    if L == 1:
        return rows
    E = csr.indices.shape[0]
    a32 = torch.tensor(alpha, dtype=torch.float32, device=rows.device)
    rows0 = rows[:, 0]
    cur = rows0.clamp(min=0)
    alive = rows0 >= 0
    out = [rows0]
    for t in range(1, L):
        alive = alive & (u[:, t - 1, 0] < a32)
        cur_l = cur.long()
        deg = csr.deg[cur_l]
        j = torch.minimum((u[:, t - 1, 1] * (deg + 1).to(torch.float32))
                          .to(torch.int32), deg)
        idx = (csr.indptr[cur_l] + j).clamp(0, E - 1)
        nxt = torch.where(j >= deg, cur, csr.indices[idx.long()])
        val = torch.where(t <= t0, rows[:, t],
                          torch.where(alive, nxt, -1))
        cur = torch.where(val >= 0, val, cur)
        out.append(val)
    return torch.stack(out, dim=1)


def resample_rows_keyed_ref(csr: CSRView, rows: torch.Tensor,
                            t0: torch.Tensor, key: Key, ids: torch.Tensor,
                            *, alpha: float) -> torch.Tensor:
    """``resample_rows_ref`` with the draws of walks ``ids`` (int64[C],
    taken mod 2**32) under the index's base ``key``: hop t of walk i draws
    ``uniform2(fold_in(fold_in(key, i), t))``."""
    return resample_rows_ref(csr, rows, t0,
                             walk_uniforms(key, ids, rows.shape[1]),
                             alpha=alpha)
