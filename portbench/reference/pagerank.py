"""PageRank with an implicit self-loop at every vertex, by power iteration
from the uniform vector (the DF/DF-P report's definition, §3.1):

    r[v] = (1 - a) / V + a * sum over (u, v) of r[u] / (d[u] + 1)
                      + a * r[v] / (d[v] + 1)

with d the live out-degree.  Every vertex has an out-edge (its loop), so
no rank leaks.  ``dtype`` is the precision the whole solve runs in.
"""
from __future__ import annotations

import torch


def pagerank(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
             num_vertices: int, *, alpha: float = 0.85,
             dtype: torch.dtype = torch.float64, tol: float = 0.0,
             max_iter: int = 1000) -> torch.Tensor:
    """The ranks, iterated until an iteration changes no rank by more
    than ``tol`` (0: until the iteration stops changing them, which in
    f64 takes ~220 iterations at a = 0.85), or ``max_iter``."""
    s = src[valid].long()
    d = dst[valid].long()
    n = int(num_vertices)
    dev = src.device
    inv = 1.0 / (torch.bincount(s, minlength=n).to(dtype) + 1.0)
    r = torch.full((n,), 1.0 / n, dtype=dtype, device=dev)
    base = torch.full((n,), (1.0 - alpha) / n, dtype=dtype, device=dev)
    last = float("inf")
    for it in range(max_iter):
        y = r * inv
        c = torch.zeros(n, dtype=dtype, device=dev).index_add_(0, d, y[s])
        r_new = base + alpha * (c + y)
        change = float((r_new - r).abs().max())
        r = r_new
        # converged, or down to rounding: the change stopped falling
        if change <= tol or (it >= 50 and change >= last):
            break
        last = change
    return r
