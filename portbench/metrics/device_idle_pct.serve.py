"""device_idle_pct.serve (per-layer, device, device_trace, %; moves update_ms.p95):
the share of the traced window in which no kernel, copy or memset ran on
the card (torch.profiler's CUPTI trace)."""


def read(run):
    p = run["profile"]
    if not run["trace"] or p is None or run["window_s"] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - p["busy_s"] / run["window_s"])
