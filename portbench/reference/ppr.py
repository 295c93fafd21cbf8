"""Personalised PageRank of one seed estimated from stored walks, unrolled
one step through the seed's own rank equation (self-loop included):

    pi_s = [(1 - a) e_s + a / (d_s + 1) * sum over out-neighbours u of
            pi_u] / (1 - a / (d_s + 1))

with pi_u estimated as (1 - a) / R times the visits of u's R walks, then
rescaled to sum to 1.  The top-k of it is what a query returns.
"""
from __future__ import annotations

import torch

from . import walks as ref_walks


def estimate(indptr: torch.Tensor, indices: torch.Tensor, deg: torch.Tensor,
             seed_vertex: int, *, num_walks: int, max_len: int, alpha: float,
             key_seed: int, dtype: torch.dtype = torch.float64
             ) -> torch.Tensor:
    """dtype[V]: the normalised estimate for ``seed_vertex``."""
    n = deg.shape[0]
    dev = deg.device
    s = int(seed_vertex)
    d = int(deg[s])
    nbrs = indices[int(indptr[s]): int(indptr[s]) + d]
    z = 1.0 - alpha / (d + 1.0)
    est = torch.zeros(n, dtype=dtype, device=dev)
    if d:
        w = torch.zeros(n, dtype=torch.int64, device=dev)
        steps = ref_walks.walks(indptr, indices, deg, nbrs, num_walks,
                                max_len, alpha, key_seed).reshape(-1)
        steps = steps[steps >= 0].long()
        w.index_add_(0, steps, torch.ones_like(steps))
        scale = alpha * (1.0 - alpha) / ((d + 1.0) * z * num_walks)
        est = w.to(dtype) * torch.tensor(scale, dtype=dtype, device=dev)
    est[s] += torch.tensor((1.0 - alpha) / z, dtype=dtype, device=dev)
    return est / est.sum()
