"""walks_resampled.serve (per-layer, walk repair, program_counter, count;
moves update_ms.p95): ServeMetrics.walks_resampled over the traced
window's batches, a batch."""


def read(run):
    if not run["trace"] or run["walks_resampled"] is None \
            or not run["batches"]:
        return None
    return run["walks_resampled"] / len(run["batches"])
