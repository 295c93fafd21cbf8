"""A cell small enough for the CPU: the configuration's shapes at 2^10
vertices, with short walks, and its mix at 64-event batches."""
from __future__ import annotations

import copy
import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness.manifest import Cell, load_module, load_reader  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())

LIMITS = {"edge_slots_differing": 0, "rank_l1": 1e-6,
          "walk_steps_differing": 0, "answer_gap": 1e-10}


def _load(kind: str, name: str) -> dict:
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def tiny_cell(workload: str) -> Cell:
    manifest = MANIFEST
    w = next(x for x in manifest["workloads"] if x["name"] == workload)
    config = copy.deepcopy(_load("configs", w["config"]))
    config["graph"].update(scale=10, edge_factor=8)
    if config.get("ppr_index"):
        config["ppr_index"].update(num_walks=4, max_len=6)
    mix = copy.deepcopy(_load("traffic", w["traffic"]))
    mix.update(batch_events=64, warmup_batches=2, max_batches_per_s=40)
    if mix.get("queries"):
        mix["queries"]["rate_per_s"] = 50

    def metrics(kind):
        from harness.manifest import Metric
        return [Metric(x["name"], x["unit"], kind, load_reader(x["name"]))
                for x in manifest[kind]
                if "workloads" not in x or workload in x["workloads"]]

    return Cell(workload, config, mix, metrics("end_to_end"),
                metrics("per_layer"), load_module("systems", config["system"]),
                load_module("loops", mix["loop"]))


def run_tiny(workload: str, *, seed: int = 7, batches: int = 12,
             trace: bool = False, tune_cache: str, scale: int = 10,
             limits: dict = LIMITS, **kw) -> dict:
    """One run of the tiny cell on the CPU over exactly ``batches`` window
    batches (the window outlasts the feed, so the count does not follow
    the host's speed); the engine's tuner caches into ``tune_cache``;
    at ``scale`` 15 64-event batches take the DF-P path, not the static
    fallback."""
    seconds = 120.0
    import time
    import torch
    from harness import cell
    torch.set_num_threads(1)
    c = tiny_cell(workload)
    if not c.config.get("ppr_index"):
        limits = {k: v for k, v in limits.items()
                  if k in ("edge_slots_differing", "rank_l1")}
    c.traffic["max_batches_per_s"] = batches / seconds
    if scale != 10:
        c.config["graph"].update(scale=scale, edge_factor=16)
    before = os.environ.get("REPRO_TORCH_TUNE_CACHE")
    os.environ["REPRO_TORCH_TUNE_CACHE"] = tune_cache
    try:
        return cell.run(c, seed=seed, seconds=seconds, trace=trace,
                        device="cpu", limits=limits,
                        t_start=time.perf_counter(),
                        log=kw.pop("log", lambda *a: None), **kw)
    finally:
        if before is None:
            os.environ.pop("REPRO_TORCH_TUNE_CACHE", None)
        else:
            os.environ["REPRO_TORCH_TUNE_CACHE"] = before
