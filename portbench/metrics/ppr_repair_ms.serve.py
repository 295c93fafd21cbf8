"""ppr_repair_ms.serve (per-layer, walk repair, program_span, ms; moves update_ms.p95): the
span ``ppr.repair`` the program records with its tracer on, mean over the
traced window's batches."""
from harness.stats import mean


def read(run):
    xs = run["spans"].get("ppr.repair") if run["trace"] else None
    return None if not xs else mean(xs) * 1e3
