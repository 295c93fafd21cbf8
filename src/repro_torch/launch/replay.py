"""Replay an incident bundle recorded by the serving flight recorder
(twin of ``repro.launch.replay``).

Re-executes every batch in the bundle from its checkpoint anchor
through a freshly-constructed ``ServeEngine`` (same method, engine and
pack geometry as the recording) and diffs each published snapshot's
rank digest — and the engine's method/fallback decisions — against
what the live engine recorded.  Every sum of the port has a fixed
order, so the replay is **bit-for-bit** (DESIGN.md §12); any mismatch
localises the first divergent generation.

    PYTHONPATH=src python -m repro_torch.launch.replay /path/to/bundle

Exit status: 0 when every batch reproduced bit-for-bit, 1 otherwise
(also under ``--strict`` when the bundle carries no batches).  Bundles
are written by ``CorrectnessMonitor`` on the first error-severity
incident (``MonitorConfig.incident_dir``) or manually via
``FlightRecorder.dump()``, by either package.  Runs on the CUDA card
unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.device import resolve_device
from repro_torch.obs.recorder import load_bundle, replay


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="deterministically re-execute a recorded serving "
                    "window and verify it bit-for-bit")
    ap.add_argument("bundle", help="incident bundle directory "
                                   "(manifest.json + anchor/ + records.npz)")
    ap.add_argument("--end-gen", type=int, default=None,
                    help="replay only generations <= this")
    ap.add_argument("--strict", action="store_true",
                    help="exit non-zero on an empty replay window too")
    ap.add_argument("--json", default="",
                    help="write the per-step report as JSON here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg, anchor_gen, _, _, records, incident = load_bundle(args.bundle)
    print(f"bundle {os.path.abspath(args.bundle)}: "
          f"method={cfg.get('method')} engine={cfg.get('engine')} "
          f"anchor=gen{anchor_gen} records={len(records)} device={device}")
    if incident:
        print(f"recorded incident: [{incident.get('severity')}] "
              f"{incident.get('kind')} at gen "
              f"{incident.get('generation')} — {incident.get('message')}")

    report = replay(args.bundle, end_gen=args.end_gen, device=device)
    print(report.describe())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(anchor_generation=report.anchor_generation,
                           ok=report.ok,
                           steps=[s._asdict() for s in report.steps]),
                      f, indent=1)
        print(f"report written to {args.json}")
    if not report.steps:
        print("replay window is empty")
        return 1 if args.strict else 0
    if report.ok:
        print(f"replay ok: {report.num_bitwise}/{len(report.steps)} "
              f"batches bit-for-bit")
        return 0
    print("REPLAY DIVERGED from the recorded digests")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
