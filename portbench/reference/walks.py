"""Decay-terminated random walks (Bahmani, Chowdhury and Goel, PVLDB 4(3),
2010), R a vertex, L slots a walk, as the ``ppr_index`` section of a
configuration states them:

  * walk id i = v * R + r for walk r of vertex v; its key is
    fold_in(PRNGKey(seed), i); hop t (1 <= t < L) draws
    (u0, u1) = uniform(fold_in(walk key, t), (2,), float32);
  * slot 0 holds v; at hop t the walk goes on iff it is still going and
    u0 < float32(alpha); it then takes slot j = min(int(u1 * float32(d +
    1)), d) of its vertex's live out-neighbours in slot order, slot d
    being the self-loop (it stays); a walk that stopped holds -1 from
    then on.
"""
from __future__ import annotations

import torch

from . import threefry


def walks(indptr: torch.Tensor, indices: torch.Tensor, deg: torch.Tensor,
          sources: torch.Tensor, num_walks: int, max_len: int,
          alpha: float, seed: int) -> torch.Tensor:
    """int32[len(sources), R, L]: every walk of each source vertex."""
    R, L = num_walks, max_len
    dev = indptr.device
    v = sources.long().repeat_interleave(R)
    ids = v * R + torch.arange(R, device=dev).repeat(sources.shape[0])
    key = threefry.fold_in(threefry.prng_key(seed), ids)
    a32 = torch.tensor(alpha, dtype=torch.float32, device=dev)
    out = torch.empty((v.shape[0], L), dtype=torch.int32, device=dev)
    cur = v.clone()
    going = torch.ones_like(v, dtype=torch.bool)
    out[:, 0] = cur.to(torch.int32)
    n_ind = max(1, indices.shape[0])
    for t in range(1, L):
        u = threefry.uniform2(threefry.fold_in(key, t))
        going = going & (u[:, 0] < a32)
        d = deg[cur]
        j = torch.minimum((u[:, 1] * (d + 1).to(torch.float32))
                          .to(torch.int64), d)
        pos = (indptr[cur] + j).clamp(0, n_ind - 1)
        nxt = torch.where(j >= d, cur, indices[pos] if indices.numel()
                          else cur)
        cur = torch.where(going, nxt, cur)
        out[:, t] = torch.where(going, cur, -1).to(torch.int32)
    return out.view(sources.shape[0], R, L)
