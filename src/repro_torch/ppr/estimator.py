"""Error accounting for the walk index: trade R (memory, build time) for ε
(twin of ``repro.ppr.estimator``).

Both regimes are per-vertex pointwise bounds for a single-seed query:

* **Sampling error**: each walk's contribution to est(v) lies in
  [0, (1-α)·L] (a walk can visit v at most L times), so Hoeffding gives

      P(|est(v) − E est(v)| ≥ ε) ≤ 2·exp(−2 R ε² / ((1−α)L)²)

  a conservative sizing rule; the endpoint-bound variant (c = 1−α) is the
  optimistic floor.

* **Truncation bias**: walks are capped at L slots (L-1 transitions), so
  the lost tail mass is α^(L-1) of the PPR distribution (~8.7e-2 at
  α=0.85, L=16).  ``normalize=True`` in the query path redistributes it.

``diagnostics`` reports the realised index shape (mean walk length,
truncated fraction, bytes).
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.ppr.walks import WalkIndex


def truncation_bias(alpha: float, max_len: int) -> float:
    """PPR mass beyond the L-hop cap: α^(L-1)."""
    return float(alpha) ** int(max_len - 1)


def walks_for_error(eps: float, delta: float, alpha: float,
                    max_len: int, per_visit_cap: bool = True) -> int:
    """Smallest R with P(|est − E| ≥ eps) ≤ delta per vertex (Hoeffding).

    ``per_visit_cap=True`` uses the conservative c = (1−α)L walk
    contribution; False uses the endpoint-estimator bound c = 1−α.
    """
    if not (0 < eps and 0 < delta < 1):
        raise ValueError("need eps > 0 and 0 < delta < 1")
    c = (1.0 - alpha) * (max_len if per_visit_cap else 1.0)
    return max(1, math.ceil(c * c * math.log(2.0 / delta) / (2.0 * eps * eps)))


def error_bound(num_walks: int, delta: float, alpha: float,
                max_len: int, per_visit_cap: bool = True) -> float:
    """The ε guaranteed at confidence 1−δ by R walks (inverse of
    ``walks_for_error``)."""
    if not (num_walks >= 1 and 0 < delta < 1):
        raise ValueError("need num_walks >= 1 and 0 < delta < 1")
    c = (1.0 - alpha) * (max_len if per_visit_cap else 1.0)
    return c * math.sqrt(math.log(2.0 / delta) / (2.0 * num_walks))


# Effective sample floor for serving top-k from the index (mode="auto"):
# a query over seed set S aggregates Σ_s d_s·R walks (the unrolled
# estimator).  The reference measured the top-10 tail of a power-law graph
# as noise-ranked below ~512 effective walks and serving-grade at or above
# it; thinner seeds route to the exact solver.
DEFAULT_MIN_EFFECTIVE_WALKS = 512


def effective_walks(index: WalkIndex, seeds: Sequence[int]) -> int:
    """Σ_s out_degree(s) · R: walks the unrolled estimator aggregates for
    this seed set; the routing signal of ``QueryClient`` mode="auto".  One
    gather and one host read of the sum."""
    s = np.unique(np.asarray(seeds, np.int64).reshape(-1))
    idx = torch.from_numpy(s).to(index.device)
    deg_sum = int(index.csr.deg[idx].sum(dtype=torch.int64))
    return deg_sum * index.num_walks


def diagnostics(index: WalkIndex) -> Dict[str, float]:
    """Realised-sample health: walk lengths against the geometric model."""
    mask = index.mask()
    lengths = mask.sum(dim=-1, dtype=torch.int64)        # [V, R] incl. source
    mean_len = float(lengths.to(torch.float64).mean())
    # a walk still alive in the last slot was truncated by the L cap
    truncated = float(mask[:, :, -1].to(torch.float64).mean())
    return dict(
        num_walks=float(index.num_walks),
        max_len=float(index.max_len),
        mean_length=mean_len,
        # geometric model: E[len] = 1/(1-α), capped at L
        expected_length=min(1.0 / (1.0 - index.alpha), float(index.max_len)),
        truncated_frac=truncated,
        truncation_bias=truncation_bias(index.alpha, index.max_len),
        nbytes=float(index.nbytes()),
    )


def precision_at_k(approx_top: Sequence[int], exact_ranks: np.ndarray,
                   k: int, rel_tol: float = 0.05) -> float:
    """Tie-tolerant precision@k: the fraction of the approximate top-k
    whose exact value is within ``rel_tol`` of the exact k-th largest (any
    order inside such a tie class is equally correct)."""
    exact_ranks = np.asarray(exact_ranks, np.float64).reshape(-1)
    approx = np.asarray(approx_top).reshape(-1)[:k]
    kth = np.partition(exact_ranks, -k)[-k]
    eligible = exact_ranks >= kth * (1.0 - rel_tol)
    return float(np.sum(eligible[approx])) / max(1, len(approx))
