#!/usr/bin/env python3
"""Readings for the limits of ``correct``: the compared numbers of sound
runs and of the controls, many seeds in one process.

    python3 portbench/readings.py --workload <name> --seconds <s> \
        --seeds 1,2,3 [--f32-seeds 4,5,6] [--out FILE]

For each of ``--seeds`` it runs the cell as the command does and prints
the compared numbers, then the same numbers with the reference computed
in float32 put in the program's place (the ranks and the answers).  For
each of ``--f32-seeds`` it runs the cell with the program's own
lower-precision path switched on: the f32 sweeps alone, without the f64
polish (``polish=False``).  One JSON line a run, on standard output and
appended to ``--out``.  Needs the card; not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))

import run as command  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--f32-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    command._environment()
    import torch
    from harness import cell as cell_run
    from harness import manifest
    if not torch.cuda.is_available():
        command._fail(2, "needs a CUDA card")
    torch.set_num_threads(1)
    cell = manifest.find_cell(args.workload)
    with open(BENCH / "limits" / f"{args.workload}.json") as f:
        limits = json.load(f)
    runs = [(int(s), "program") for s in args.seeds.split(",") if s] + \
        [(int(s), "program_f32") for s in args.f32_seeds.split(",") if s]
    for seed, mode in runs:
        t = time.perf_counter()
        out = cell_run.run(
            cell, seed=seed, seconds=args.seconds, trace=False,
            device="cuda:0", limits=limits,
            overrides=dict(polish=False) if mode == "program_f32" else None,
            extra_controls=("reference_f32",) if mode == "program" else (),
            t_start=t)
        row = dict(workload=args.workload, seed=seed, mode=mode,
                   numbers=out["numbers"], correct=out["line"]["correct"],
                   metrics={k: v["value"] for k, v in
                            out["line"]["metrics"].items()},
                   batches=len(out["record"]["batches"]),
                   rebuilds=out["rebuilds"],
                   reference_f32=out["controls"].get("reference_f32"),
                   seconds=time.perf_counter() - t)
        print("READING " + json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        del out
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


if __name__ == "__main__":
    main()
