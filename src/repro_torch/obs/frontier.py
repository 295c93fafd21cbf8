"""Per-iteration convergence telemetry for the DF/DF-P loops (twin of
``repro.obs.frontier``).

The paper's whole claim is about the *trajectory* of the affected set —
how the frontier seeds, grows, prunes and dies per iteration — yet the
engines historically returned only endpoint scalars (iterations, final
delta).  This module fixes the schema: every engine loop, when asked
(``telemetry=True``), builds one row per iteration:

  ========== ============================================================
  column      meaning (per iteration, before the frontier update)
  ========== ============================================================
  affected    |affected| entering the iteration — the vertices whose
              rank the sweep recomputes (the paper's work proxy and the
              touched-mass signal of Rossi & Gleich / Jayaram et al.)
  residual    L∞ rank change over the affected set this iteration
  grew        vertices newly marked by frontier expansion (net:
              ``|new \\ old|``)
  pruned      vertices dropped by DF-P contraction (net: ``|old \\ new|``)
  active      engine-granularity work units gated on this iteration:
              active *windows* for the frontier_spmv kernel loop,
              affected *vertices* for the f64 loop (its gating
              granularity)
  ========== ============================================================

The loops end on data: each iteration already reads one boolean
(``delta > tol``) back to the host.  With telemetry on, the row is
stacked with that boolean and the two come back in the same one read,
so telemetry adds **no host sync** (only the few small launches that
build the row); with ``telemetry=False`` the loops launch and read
exactly what they do without this module.  The rows are host-side from
the start: a result carries them trimmed, as f64 ``[iters, k]`` NumPy.

The f64 loop records rows in f64, the kernel loop in f32; counts are
exact in both up to 2^24 vertices and ``FrontierTelemetry`` normalizes
to f64 numpy.  ``affected`` and ``residual`` are engine-comparable: the
parity tests assert they match between the two engines (and against
``repro``'s rows) on the harness graphs.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

FIELDS = ("affected", "residual", "grew", "pruned", "active")
NUM_FIELDS = len(FIELDS)
_IDX = {name: i for i, name in enumerate(FIELDS)}

__all__ = ["FIELDS", "NUM_FIELDS", "FrontierTelemetry", "combine",
           "read_row", "telemetry_row"]


def telemetry_row(affected, residual, grew, pruned, active, dtype):
    """One ``[NUM_FIELDS]`` row of 0-d tensors, built on their device.

    Kept here so the engine loops and this schema can never drift: the
    column order is defined once.
    """
    return torch.stack([affected.to(dtype), residual.to(dtype),
                        grew.to(dtype), pruned.to(dtype), active.to(dtype)])


def read_row(row, more) -> tuple:
    """(row as a list of floats, more): ``row`` and the loop's boolean
    ``more`` (0-d, on the row's device) come back in ONE host read."""
    vals = torch.cat([row, more.to(row.dtype).reshape(1)]).tolist()
    return vals[:NUM_FIELDS], bool(vals[NUM_FIELDS])


class FrontierTelemetry(NamedTuple):
    """Trimmed, host-side telemetry: ``data`` is f64 ``[iters, k]``."""

    data: np.ndarray

    @classmethod
    def from_padded(cls, padded, iterations) -> "FrontierTelemetry":
        """Trim a padded ``[max_iter, k]`` buffer (or a host list of
        rows) to the rows the solve actually executed."""
        n = int(iterations)
        arr = np.asarray(padded, np.float64)[:n]
        return cls(np.ascontiguousarray(arr))

    @classmethod
    def concat(cls, *parts: "FrontierTelemetry") -> "FrontierTelemetry":
        """Stack phase trajectories (e.g. f32 kernel sweep + f64 polish)
        into one per-batch trajectory, in execution order."""
        rows = [p.data for p in parts if p is not None and len(p.data)]
        if not rows:
            return cls(np.zeros((0, NUM_FIELDS), np.float64))
        return cls(np.concatenate(rows, axis=0))

    @property
    def iterations(self) -> int:
        return int(self.data.shape[0])

    def column(self, name: str) -> np.ndarray:
        return self.data[:, _IDX[name]]

    def summary(self) -> dict:
        """Scalar digest for metrics/trace args (JSON-safe floats)."""
        if not len(self.data):
            return dict(iterations=0)
        aff = self.column("affected")
        res = self.column("residual")
        return dict(
            iterations=self.iterations,
            affected_initial=float(aff[0]),
            affected_peak=float(aff.max()),
            affected_final=float(aff[-1]),
            residual_initial=float(res[0]),
            residual_final=float(res[-1]),
            grew_total=float(self.column("grew").sum()),
            pruned_total=float(self.column("pruned").sum()),
            active_mean=float(self.column("active").mean()),
        )

    def rows(self) -> list:
        """Per-iteration dicts (the JSONL exporter's record shape)."""
        return [dict(zip(FIELDS, map(float, r))) for r in self.data]


def combine(kernel_tel: Optional[FrontierTelemetry],
            polish_tel: Optional[FrontierTelemetry]
            ) -> Optional[FrontierTelemetry]:
    """Hybrid-ladder helper: kernel phase then polish phase, or None if
    neither phase recorded anything."""
    if kernel_tel is None and polish_tel is None:
        return None
    return FrontierTelemetry.concat(
        *(p for p in (kernel_tel, polish_tel) if p is not None))
