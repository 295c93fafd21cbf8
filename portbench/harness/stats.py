"""The arithmetic of the metrics: a tail is the tail of all samples."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def percentile(xs: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile of every sample (linear interpolation between
    order statistics, numpy's default); None without samples."""
    if len(xs) == 0:
        return None
    return float(np.percentile(np.asarray(xs, np.float64), q))


def mean(xs: Sequence[float]) -> Optional[float]:
    return None if len(xs) == 0 else float(np.mean(np.asarray(xs,
                                                               np.float64)))
