"""Plain PyTorch version of the walk-repair kernel (twin of
``repro.kernels.walk_repair.ref``): the same hop recurrence, one torch op
per step.  Its output is bitwise identical to the CUDA kernel's
(``csrc/walk_repair.cu``): every step is an integer gather, an integer
compare or one IEEE float32 multiply with a truncating convert.
"""
from __future__ import annotations

import torch

from repro_torch.graph.structure import CSRView


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
