"""Chaos-drive the read-replica tier and prove recovery to parity (twin of
``repro.launch.replicate``).

Runs the seeded ``ChaosHarness`` (``serve/chaos.py``): one ``ServeEngine``
writer, N ``ReadReplica``s on a fault-injectable transport, a declarative
kill/partition/delay schedule keyed to event offsets, and a writer-parity
assertion (L∞ ≤ 1e-6 at equal generation) after every recovery point.
Exit status 0 only when every parity check passed.

    PYTHONPATH=src python -m repro_torch.launch.replicate --device cpu \\
        --scale 7 --schedule 'partition:r1@80+60;kill_writer@260'

Schedule grammar: ``kind[:target]@at[+duration]`` semicolon-separated,
kinds ``kill`` / ``partition`` / ``delay`` (with a target replica) and
``kill_writer`` (heartbeat failover).  The printed incident lines
(``replica_resync``, ``slo_burn``, ``writer_failover``) are what a chaos
lane greps for.  Runs on the CUDA card unless ``--device cpu`` is given;
``--engine kernel`` puts the writer on the kernel engine.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.core.api import ENGINES
from repro_torch.serve.chaos import ChaosHarness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="chaos-test the replicated serving tier")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--events", type=int, default=1200,
                    help="length of the seeded edge-event feed")
    ap.add_argument("--schedule", default="",
                    help="chaos schedule, e.g. "
                         "'partition:r1@300+200;kill_writer@900'")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=int, default=9,
                    help="RMAT scale of the bootstrap graph (V = 2^scale)")
    ap.add_argument("--drop", type=float, default=0.0,
                    help="per-message drop probability")
    ap.add_argument("--dup", type=float, default=0.0,
                    help="per-message duplicate probability")
    ap.add_argument("--reorder", type=float, default=0.0,
                    help="per-message reorder (extra delay) probability")
    ap.add_argument("--staleness-slo", type=int, default=256,
                    help="replica staleness SLO in events (degradation "
                         "threshold)")
    ap.add_argument("--ckpt-dir", default="",
                    help="writer RankStore checkpoint directory (failover "
                         "consults the last committed step)")
    ap.add_argument("--method", default="frontier_prune")
    ap.add_argument("--engine", default="xla", choices=ENGINES,
                    help="the writer's engine")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--json", default="",
                    help="write the chaos report as JSON here")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the per-recovery narration")
    args = ap.parse_args(argv)

    harness = ChaosHarness(
        num_replicas=args.replicas, events=args.events,
        schedule=args.schedule, seed=args.seed, scale=args.scale,
        drop_p=args.drop, dup_p=args.dup, reorder_p=args.reorder,
        staleness_slo_events=args.staleness_slo,
        ckpt_dir=args.ckpt_dir or None, method=args.method,
        verbose=not args.quiet, device=args.device, engine=args.engine)
    try:
        report = harness.run()
    except AssertionError as e:
        print(f"PARITY FAILURE: {e}", flush=True)
        return 1
    for line in report.lines():
        print(line, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dataclasses_dict(report), f, indent=1)
        print(f"report written to {args.json}")
    print(f"chaos run complete: {report.parity_checks} parity checks OK, "
          f"{report.failovers} failovers, {report.resyncs} resyncs")
    return 0


def dataclasses_dict(report) -> dict:
    d = dict(report.__dict__)
    d["incidents"] = dict(d["incidents"])
    return d


if __name__ == "__main__":
    sys.exit(main())
