"""Whole runs of small cells: sound runs come out correct, the control and
each fault the cells can have come out not correct, and nothing a run
does loads JAX or the JAX package or reads the JAX package's benchmarks.
The last test runs the command itself on the card (marked ``cuda``)."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

import tiny

PPR = "ppr-rmat21.serve-b1k"


@pytest.fixture
def tune_cache(tmp_path):
    return str(tmp_path / "tune.json")


def _numbers(out):
    return {name: value for name, value, _ in out["rows"]}


@pytest.mark.parametrize("workload", [PPR])
def test_sound_run_is_correct(workload, tune_cache):
    out = tiny.run_tiny(workload, tune_cache=tune_cache,
                        extra_controls=("reference_f32",))
    assert out["line"]["correct"], out["rows"]
    assert out["record"]["batches"]
    names = set(out["line"]["metrics"])
    assert "setup_s" in names and len(names) >= 2
    assert list(out["line"])[-1] == "checks"
    if workload == PPR:
        assert out["numbers"]["answers_compared"] > 0
        # the reference in float32 in the program's place fails the gap
        gap = out["controls"]["reference_f32"]["answer_gap"]
        assert gap > tiny.LIMITS["answer_gap"]


@pytest.mark.parametrize("workload", [PPR])
def test_traced_run_reports_every_per_layer_metric(workload, tune_cache):
    # on the CPU the device trace is not taken: its metrics stay out
    out = tiny.run_tiny(workload, trace=True, tune_cache=tune_cache)
    want = {x["name"] for x in tiny.MANIFEST["per_layer"]
            if workload in x.get("workloads", [workload])
            and x["source"] != "device_trace"}
    assert set(out["line"]["metrics"]) == want
    assert "busy_s" not in out["line"]["device"]


# at 2^15 vertices 64-event batches take the DF-P path (no static
# fallback), whose f32 sweeps the f64 polish finishes: seed 8 reads
# rank_rel_max 4.67e-6 sound and 6.11e-4 without the polish (CPU), the
# cell's limit between them
LIMITS_15 = dict(tiny.LIMITS, rank_l1=1e-4, rank_rel_max=5e-4)


def test_program_f32_path_fails_the_rank_limit(tune_cache):
    sound = tiny.run_tiny(PPR, tune_cache=tune_cache, scale=15, seed=8,
                          limits=LIMITS_15)
    assert sound["line"]["correct"], sound["rows"]
    # the published ranks are the last batch's, on the DF-P path
    assert not sound["record"]["batches"][-1]["fallback"]
    f32 = tiny.run_tiny(PPR, tune_cache=tune_cache, scale=15, seed=8,
                        limits=LIMITS_15, overrides=dict(polish=False))
    assert not f32["line"]["correct"]
    assert f32["numbers"]["rank_rel_max"] > LIMITS_15["rank_rel_max"]


def test_repacks_in_the_window_are_counted_and_judged(tune_cache):
    # an overlay of 128 entries runs out every few 51-insertion batches
    out = tiny.run_tiny(PPR, tune_cache=tune_cache,
                        overrides=dict(overlay_capacity=128))
    assert out["line"]["correct"], out["rows"]
    per_batch = [b["repacks"] for b in out["record"]["batches"]]
    assert sum(per_batch) >= 3
    assert out["rebuilds"] == sum(per_batch)


def _fault_step_unchanged(monkeypatch):
    from repro_torch.serve import engine
    monkeypatch.setattr(engine, "apply_batch", lambda graph, update: graph)


def _fault_half_batch(monkeypatch):
    from repro_torch.serve import ingest
    real = ingest.coalesce_events

    def half(events, *a, **kw):
        return real(events[: max(1, len(events) // 2)], *a, **kw)
    monkeypatch.setattr(ingest, "coalesce_events", half)


def _fault_answer_altered(monkeypatch):
    from repro_torch.serve import query
    real = query.ppr_top_k

    def altered(*a, **kw):
        idx, vals = real(*a, **kw)
        return idx.flip(0), vals
    monkeypatch.setattr(query, "ppr_top_k", altered)


def _fault_repair_skipped(monkeypatch):
    from repro_torch.serve import engine
    monkeypatch.setattr(engine, "repair_walk_index",
                        lambda index, graph, touched: (index, 0))


@pytest.mark.parametrize("workload,fault", [
    (PPR, _fault_step_unchanged), (PPR, _fault_half_batch),
    (PPR, _fault_answer_altered), (PPR, _fault_repair_skipped)])
def test_fault_makes_the_run_incorrect(workload, fault, tune_cache,
                                       monkeypatch):
    fault(monkeypatch)
    out = tiny.run_tiny(workload, tune_cache=tune_cache)
    assert not out["line"]["correct"], out["rows"]


SCRIPT = r"""
import json, sys
sys.path.insert(0, {tests!r})
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0]))
                 if ev == "open" and args and isinstance(args[0], str)
                 else None)
import tiny
out = tiny.run_tiny({workload!r}, trace=True, tune_cache={cache!r})
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps(dict(correct=out["line"]["correct"], modules=tops,
                      opened=opened)))
"""


@pytest.mark.parametrize("workload", [PPR])
def test_a_run_loads_no_jax_and_reads_no_benchmarks(workload, tune_cache):
    code = SCRIPT.format(tests=str(tiny.BENCH / "tests"), workload=workload,
                         cache=tune_cache)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, env=env, cwd=tiny.ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(res["modules"])
    assert "repro_torch" in res["modules"]
    bench = str(tiny.ROOT / "benchmarks")
    assert not [p for p in res["opened"] if p.startswith(bench)]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [PPR])
def test_command_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run([sys.executable, str(tiny.BENCH / "run.py"),
                        "--workload", workload, "--seed", str(2**31 + 5),
                        "--seconds", "3", "--trace", "0"],
                       capture_output=True, text=True, timeout=900,
                       cwd=tiny.ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
