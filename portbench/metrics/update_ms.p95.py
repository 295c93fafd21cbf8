"""update_ms.p95 (end-to-end, host_clock, ms, lower): freshness.  The
95th percentile over every batch of the window of the time from the
start of the batch's submission to the return of the step that
published it."""
from harness.stats import percentile


def read(run):
    v = percentile([b["pub"] - b["sub"] for b in run["batches"]], 95)
    return None if v is None else v * 1e3
