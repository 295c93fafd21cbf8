#!/usr/bin/env python3
"""Every geometry of the tuner's grid on one R-MAT graph: the pack, and
``frontier_spmv`` at several active fractions, timed beside the tuner's
model (``kernels/pagerank_spmv/tune.py``).

    PYTHONPATH=src python tools/tune_sweep.py --scale 21 --out sweep.json

The frontier is clustered as the tuner's measured search makes it: the
first ``f·|V|`` vertices.  Each case prints the kernel's time a call over
back-to-back calls (CUDA events), its host time a call, the model's
prediction and its terms, the pack's time and the plan's chunks.  These
are the numbers the model's constants are fitted to: the sweep ends
with the fit (``fit``), and ``--fit sweep.json`` fits a saved sweep again
with no device.  It runs on the CUDA card; ``--device cpu`` runs the
plain version (no device time).

    PYTHONPATH=src python tools/tune_sweep.py --fit sweep.json
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph.generators import rmat_edges
from repro_torch.graph.structure import from_coo
from repro_torch.kernels.pagerank_spmv import tune
from repro_torch.kernels.pagerank_spmv.ops import gated_contrib
from repro_torch.kernels.pagerank_spmv.update import pack_graph


def time_ms(dev, fn, reps: int = 20, warmup: int = 3) -> tuple:
    """(device ms a call over ``reps`` back-to-back calls by CUDA events,
    host ms a call); on the CPU both are host times."""
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t = (time.perf_counter() - t0) / reps * 1e3
        return t, t
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize(dev)
    return start.elapsed_time(stop) / reps, host


# what the model's device constants multiply, in gated_spmv_cost's terms
FEATURES = ("live", "tile_rounds", "partial_floats")
CONSTANTS = ("DEVICE_CALL_S", "GATHER_S", "TILE_S", "PARTIAL_S")


def fit(rows: list) -> dict:
    """The model's constants from a sweep's rows.  ``HOST_CALL_S`` is the
    median host time a call over every row (issued back to back, a call
    costs at least that); the device's constants (``CONSTANTS``) are a
    non-negative least-squares fit of the times of the calls with an
    active window to ``[1, *FEATURES]``, each column scaled to its largest
    value.  Returns
    the constants (seconds), each row's prediction ``max(host, device)``,
    the relative errors, and at each fraction the model's pick beside the
    fastest geometry measured."""
    from scipy.optimize import nnls
    busy = [r for r in rows if r["awin"] > 0]
    a = np.array([[1.0] + [float(r[k]) for k in FEATURES] for r in busy])
    b = np.array([r["ms"] * 1e-3 for r in busy])
    scale = np.where(a.max(axis=0) > 0, a.max(axis=0), 1.0)
    x = nnls(a / scale, b)[0] / scale
    consts = dict(HOST_CALL_S=float(np.median([r["host_ms"] * 1e-3
                                               for r in rows])),
                  **{k: float(v) for k, v in zip(CONSTANTS, x)})
    pred, dev = [], []
    for r in rows:
        dev.append(x[0] + sum(c * float(r[k])
                              for c, k in zip(x[1:], FEATURES)))
        pred.append(max(consts["HOST_CALL_S"], dev[-1]) * 1e3)
    rel = [abs(p - r["ms"]) / r["ms"] for p, r in zip(pred, rows)]
    picks = {}
    for f in sorted({r["frac"] for r in rows}):
        # ranked as candidate_costs ranks: the call, then the device's share
        at = [(p, d, r) for p, d, r in zip(pred, dev, rows)
              if r["frac"] == f]
        model = min(at, key=lambda t: t[:2])[2]
        best = min((t[2] for t in at), key=lambda r: r["ms"])
        picks[f] = dict(model=(model["be"], model["vb"]), model_ms=model["ms"],
                        best=(best["be"], best["vb"]), best_ms=best["ms"],
                        ratio=model["ms"] / best["ms"])
    return dict(constants=consts, predicted_ms=pred, cases=len(busy),
                rows=len(rows), rel_err_median=float(np.median(rel)),
                rel_err_max=float(max(rel)), picks=picks)


def print_fit(out: dict) -> None:
    for k, v in out["constants"].items():
        print(f"{k} = {v:.4g}")
    print(f"device terms fit to {out['cases']} cases with an active "
          f"window, the host's the median of {out['rows']} rows; relative "
          f"error over every row: median {out['rel_err_median']:.3f}, max "
          f"{out['rel_err_max']:.3f}")
    for f, p in out["picks"].items():
        print(f"f={f:<5g} model's pick {p['model']} {p['model_ms']:.4f} ms, "
              f"fastest {p['best']} {p['best_ms']:.4f} ms "
              f"(x{p['ratio']:.3f})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=21)
    ap.add_argument("--edge-factor", type=int, default=16)
    ap.add_argument("--fracs", type=float, nargs="+",
                    default=[0.0, 0.01, 0.05, 0.2, 1.0])
    ap.add_argument("--expected-inserts", type=int, default=65536,
                    help="the serve engine's: max(1024, 64 x flush size)")
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default="")
    ap.add_argument("--fit", default="", metavar="SWEEP_JSON",
                    help="fit the model's constants to a saved sweep and "
                         "print them; runs nothing on a device")
    args = ap.parse_args(argv)
    if args.fit:
        with open(args.fit) as f:
            print_fit(fit(json.load(f)["rows"]))
        return 0
    dev = resolve_device(args.device)
    smi = ""
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(f"nvidia-smi: {smi}")
    t0 = time.perf_counter()
    edges, n = rmat_edges(args.scale, args.edge_factor, seed=0)
    graph = from_coo(edges[:, 0], edges[:, 1], n, dedup=False, device=dev)
    dst = graph.dst[graph.valid].cpu().numpy()
    print(f"graph rmat({args.scale},{args.edge_factor}) |V|={n:,} "
          f"|E|={len(dst):,} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    ranks = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
    inv = (1.0 / graph.out_degree(include_self_loop=True)
           .to(torch.float64)).to(torch.float32)
    rows = []
    for be, vb in tune.CANDIDATE_GRID:
        nw = -(-n // vb)
        spill = tune.spill_for_stream(nw, args.expected_inserts, be)
        geom = tune.KernelGeometry(be, vb, spill)
        t1 = time.perf_counter()
        packed = pack_graph(graph, **geom.pack_kw())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        pack_s = time.perf_counter() - t1
        counts = tune.window_counts(dst, n, vb)
        n_w = tune.window_entries(dst, n, be, vb, spill)
        for f in args.fracs:
            aff = torch.zeros(n, dtype=torch.bool, device=dev)
            aff[: int(f * n)] = True
            awin = packed.active_windows(aff)
            n_act = int(awin.sum())
            ms, host = time_ms(dev, lambda: gated_contrib(
                packed, ranks, inv, active_window=awin))
            model = tune.gated_spmv_cost(counts, n_w, n, be, vb, f)
            row = dict(be=be, vb=vb, spill=spill, frac=f, ms=ms,
                       host_ms=host, pack_s=pack_s,
                       capacity=packed.num_entries,
                       awin=n_act,
                       predicted_ms=model["total_s"] * 1e3,
                       **{k: (v * 1e3 if k.endswith("_s") else v)
                          for k, v in model.items() if k != "total_s"})
            rows.append(row)
            print(f"be={be:4d} vb={vb:3d} spill={spill:4d} f={f:<5g} "
                  f"ms={ms:.4f} host={host:.4f} predicted="
                  f"{row['predicted_ms']:.4f} (gather {row['gather_s']:.4f} "
                  f"wave {row['wave_s']:.4f} partial {row['partial_s']:.4f}"
                  f") entries={packed.num_entries:,} chunks="
                  f"{model['chunks']:,} grid={model['grid']} active "
                  f"windows={n_act:,} pack {pack_s:.2f} s",
                  flush=True)
        del packed
    fitted = fit(rows) if dev.type == "cuda" else None
    if fitted is not None:
        print_fit(fitted)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(smi=smi, scale=args.scale, rows=rows,
                           fit=fitted), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
