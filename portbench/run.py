#!/usr/bin/env python3
"""The benchmark's one command: run one cell of ``BENCHMARK.json`` once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  It makes the cell's inputs from the
seed on the card, sets the program up and warms it, drives it through a
window of ``--seconds`` seconds, judges what the window produced against
the plain reference, and prints one JSON object as the last line of
standard output: the end-to-end metrics with ``--trace 0``, the per-layer
metrics, the device's busy time and a breakdown with ``--trace 1``.  The
numbers it compared, each beside its limit, are the last lines of
standard error and the ``checks`` of that object.

It exits with 2 and prints no result when there is no CUDA card or when
the program (``src/repro_torch``) is not in the checkout, and with 3 when
the process has loaded JAX or the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / ".cache"


def _environment() -> None:
    """Caches at fixed paths inside the checkout, so only a checkout's
    first run builds, compiles or tunes."""
    os.environ["REPRO_TORCH_TUNE_CACHE"] = str(CACHE / "kernel_tune.json")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    CACHE.mkdir(exist_ok=True)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]


def _fail(code: int, msg: str) -> "NoReturn":  # noqa: F821
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch
    from harness import cell as cell_run
    from harness import manifest
    try:
        cell = manifest.find_cell(args.workload)
    except (manifest.UnknownName, FileNotFoundError) as e:
        _fail(2, str(e))
    chips = next(w["chips"] for w in manifest.load_manifest()["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _fail(2, f"the cell needs {chips} CUDA card(s); found "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    try:
        import repro_torch
    except ImportError as e:
        _fail(2, f"the program is not in this checkout: {e}")
    if ROOT / "src" not in Path(repro_torch.__file__).resolve().parents:
        _fail(2, f"repro_torch came from {repro_torch.__file__}, not from "
                 f"this checkout's src/")
    torch.set_num_threads(1)
    with open(BENCH / "limits" / f"{args.workload}.json") as f:
        limits = json.load(f)
    print(f"card: {torch.cuda.get_device_name(0)}, power limit "
          f"{_power_limit()}", file=sys.stderr, flush=True)
    try:
        out = cell_run.run(cell, seed=args.seed, seconds=args.seconds,
                           trace=bool(args.trace), device="cuda:0",
                           limits=limits, t_start=T_START)
    except cell_run.ForbiddenImport as e:
        _fail(3, f"JAX or the JAX package was loaded: {e.names}")
    bad = cell_run.forbidden_modules()
    if bad:
        _fail(3, f"JAX or the JAX package was loaded: {bad}")
    print("readings " + json.dumps(out["numbers"]), file=sys.stderr)
    for name, value, limit in out["rows"]:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["line"]), flush=True)


def _power_limit() -> str:
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


if __name__ == "__main__":
    main()
