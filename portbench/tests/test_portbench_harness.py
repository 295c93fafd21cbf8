"""The harness finds what BENCHMARK.json names, and its arithmetic."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

import tiny  # noqa: F401  (puts portbench/ and src/ on the path)
from harness import manifest, stats

MANIFEST = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload",
                         [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_finds_its_files(workload):
    cell = manifest.find_cell(workload)
    assert cell.config["name"] == workload.split(".")[0]
    assert cell.traffic["batch_events"] > 0
    assert callable(cell.system.System) and callable(cell.loop.drive)
    names = {m.name for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        entry = next(x for x in MANIFEST["per_layer"] if x["name"] == m.name)
        assert entry["moves"] in names, (m.name, entry["moves"])
    limits = json.loads((tiny.BENCH / "limits" / f"{workload}.json")
                        .read_text())
    assert "edge_slots_differing" in limits
    assert {"rank_l1", "rank_rel_max"} & set(limits)


def test_every_name_has_its_file():
    names = manifest.all_names(MANIFEST)
    for n in names["metrics"]:
        assert callable(manifest.load_reader(n))
    for c in MANIFEST["configs"]:
        assert (tiny.ROOT / c["file"]).is_file()
        cfg = json.loads((tiny.ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    for t in names["traffic"]:
        assert (tiny.BENCH / "traffic" / f"{t}.json").is_file()


@pytest.mark.parametrize("kind,name", [("workload", "nope.b1k"),
                                       ("metric", "nope_ms.p95"),
                                       ("systems", "nope_engine"),
                                       ("loops", "nope_loop")])
def test_unknown_names_are_refused(kind, name):
    with pytest.raises(manifest.UnknownName):
        if kind == "workload":
            manifest.find_cell(name, MANIFEST)
        elif kind == "metric":
            manifest.load_reader(name)
        else:
            manifest.load_module(kind, name)


def test_command_refuses_an_unknown_workload():
    r = subprocess.run([sys.executable, str(tiny.BENCH / "run.py"),
                        "--workload", "nope.b1k", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout.strip() == ""


def _run(batches, answers=(), window_s=1.0, trace=False):
    return dict(batches=batches, answers=list(answers), window_s=window_s,
                setup_s=1.0, trace=trace, spans={}, profile=None,
                walks_resampled=None, repacks=0)


def test_tail_is_over_every_sample_so_a_stall_shows():
    fast = [dict(sub=0.0, pub=0.010, events=1) for _ in range(90)]
    slow = [dict(sub=0.0, pub=0.500, events=1) for _ in range(10)]
    read = manifest.load_reader("update_ms.p95")
    assert read(_run(fast)) == pytest.approx(10.0)
    assert read(_run(fast + slow)) == pytest.approx(500.0)


def test_per_layer_readers_are_silent_untraced_or_without_a_trace():
    run = _run([dict(sub=0.0, pub=0.01, events=1, iterations=3,
                     host_syncs=9)])
    for x in MANIFEST["per_layer"]:
        assert manifest.load_reader(x["name"])(run) is None, x["name"]
    run["trace"] = True
    for name in ("device_idle_pct.serve", "ppr_repair_ms.serve"):
        assert manifest.load_reader(name)(run) is None


def test_idle_share_is_the_window_less_the_busy_time():
    run = _run([dict(sub=0.0, pub=0.01, events=1)], window_s=4.0,
               trace=True)
    run["profile"] = dict(busy_s=1.0, idle={}, kernels={})
    assert manifest.load_reader("device_idle_pct.serve")(run) == \
        pytest.approx(75.0)
