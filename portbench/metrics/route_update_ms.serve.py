"""route_update_ms.serve (per-layer, graph update + frontier seed, program_span, ms; moves update_ms.p95): the
span ``route_update`` the program records with its tracer on, mean over the
traced window's batches."""
from harness.stats import mean


def read(run):
    xs = run["spans"].get("route_update") if run["trace"] else None
    return None if not xs else mean(xs) * 1e3
