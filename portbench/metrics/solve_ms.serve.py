"""solve_ms.serve (per-layer, DF-P solve, program_span, ms; moves update_ms.p95): the
solve's time a batch, whichever path the engine took: the spans
``fused_update_loop`` (packed maintenance and the f32 sweeps) and
``polish.f64`` of the DF-P path, or ``solve`` of the static fallback,
summed over the traced window and divided by its batches."""

SPANS = ("fused_update_loop", "polish.f64", "solve")


def read(run):
    if not run["trace"] or not run["batches"]:
        return None
    total = sum(sum(run["spans"].get(s, ())) for s in SPANS)
    return None if total <= 0 else total / len(run["batches"]) * 1e3
