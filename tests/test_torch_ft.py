"""The port's checkpoints and checkpointed restart (``repro_torch.ft``,
``RankStore(ckpt_dir=)``, the streaming and serve drivers), on the CPU.

  * the twins of ``tests/test_ft.py``'s checkpoint tests;
  * the on-disk format is the reference's: a checkpoint saved by
    ``repro.ft.checkpoint`` restores in the port with equal leaves, and
    the reverse;
  * a restarted stream equals the uninterrupted one bit for bit (every
    f64 sum of the port has a fixed order), and the reference driver's
    ranks on the same stream within L∞ 1e-12 (the port's f64 contract);
  * ``python -m repro_torch.launch.pagerank --device cpu`` writes
    checkpoints and resumes from them; the serve driver's ``--ckpt-dir``
    restart resumes the feed and the generation clock.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro  # noqa: F401
import jax
import jax.numpy as jnp
from repro.core.api import update_pagerank as j_update
from repro.ft import checkpoint as jck
from repro.graph import dynamic as jdyn
from repro.graph import structure as jstr

from repro_torch.data.snap import load_temporal
from repro_torch.ft import checkpoint as ck
from repro_torch.graph.dynamic import make_batch_update
from repro_torch.graph.generators import TemporalStream
from repro_torch.graph.structure import from_coo
from repro_torch.launch import pagerank as drv
from test_torch_common import CPU

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64


def _like(state):
    """An abstract target: meta tensors of the state's shapes and dtypes."""
    if isinstance(state, dict):
        return {k: _like(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_like(v) for v in state)
    return torch.empty(state.shape, dtype=state.dtype, device="meta")


# ---------------------------------------------------------------------------
# the twins of tests/test_ft.py
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    state = dict(a=torch.arange(12, dtype=torch.float32).reshape(3, 4),
                 b=[torch.ones(2, dtype=torch.int32),
                    torch.zeros((), dtype=F64)])
    path = ck.save(str(tmp_path), 7, state)
    assert os.path.exists(os.path.join(path, "manifest.json"))
    assert ck.latest_step(str(tmp_path)) == 7
    out = ck.restore(str(tmp_path), 7, _like(state), device=CPU)
    assert torch.equal(out["a"], state["a"])
    assert torch.equal(out["b"][0], state["b"][0])
    assert out["b"][1].dtype == F64 and out["b"][1].shape == ()


def test_checkpoint_gc_keeps_last(tmp_path):
    s = dict(x=torch.zeros(2))
    for i in range(6):
        ck.save(str(tmp_path), i, s, keep_last=2)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(steps) == 2
    assert ck.latest_step(str(tmp_path)) == 5


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    ck.save(str(tmp_path), 0, dict(x=torch.zeros(4)))
    with pytest.raises(ValueError):
        ck.restore(str(tmp_path), 0, dict(x=torch.zeros(5)), device=CPU)


def test_torn_write_is_not_a_checkpoint(tmp_path):
    ck.save(str(tmp_path), 3, dict(x=torch.zeros(2)))
    os.makedirs(tmp_path / "step_0000000009.tmp")   # simulated crash
    assert ck.latest_step(str(tmp_path)) == 3


def _corrupt_leaf(tmp_path, step, leaf=0):
    """Bit-flip one element in place: shape and dtype stay valid, the
    crc32 does not."""
    path = os.path.join(str(tmp_path), f"step_{step:010d}",
                        f"leaf_{leaf:05d}.npy")
    arr = np.load(path)
    arr.reshape(-1)[0] += 1
    np.save(path, arr)
    return path


def test_corrupt_leaf_raises_structured_error(tmp_path):
    ck.save(str(tmp_path), 4, dict(x=torch.arange(8, dtype=F64)))
    _corrupt_leaf(tmp_path, 4)
    with pytest.raises(ck.CheckpointCorruptError) as e:
        ck.restore(str(tmp_path), 4, dict(x=torch.zeros(8, dtype=F64)),
                   device=CPU)
    assert e.value.step == 4
    assert "x" in e.value.leaf


def test_unreadable_manifest_is_corrupt_not_crash(tmp_path):
    ck.save(str(tmp_path), 1, dict(x=torch.zeros(4)))
    with open(tmp_path / "step_0000000001" / "manifest.json", "w") as f:
        f.write("{not json")
    with pytest.raises(ck.CheckpointCorruptError):
        ck.restore(str(tmp_path), 1, dict(x=torch.zeros(4)), device=CPU)


def test_restore_latest_valid_falls_back_past_corrupt_step(tmp_path):
    target = dict(x=torch.zeros(8, dtype=F64))
    ck.save(str(tmp_path), 1, dict(x=torch.full((8,), 1.0, dtype=F64)))
    ck.save(str(tmp_path), 2, dict(x=torch.full((8,), 2.0, dtype=F64)))
    _corrupt_leaf(tmp_path, 2)                # newest step is torn
    step, state = ck.restore_latest_valid(str(tmp_path), target, CPU)
    assert step == 1
    assert torch.equal(state["x"], torch.full((8,), 1.0, dtype=F64))
    # every retained step corrupt: the error propagates
    _corrupt_leaf(tmp_path, 1)
    with pytest.raises(ck.CheckpointCorruptError):
        ck.restore_latest_valid(str(tmp_path), target, CPU)


def test_restore_latest_valid_empty_dir(tmp_path):
    assert ck.restore_latest_valid(str(tmp_path / "nope"),
                                   dict(x=torch.zeros(2)), CPU) == \
        (None, None)


def test_manager_restore_latest_skips_corrupt(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), every=1, keep_last=3)
    for step in (1, 2, 3):
        mgr.maybe_save(step, dict(i=torch.tensor(float(step))))
    _corrupt_leaf(tmp_path, 3)
    step, state = mgr.restore_latest(dict(i=torch.zeros(())), CPU)
    assert step == 2 and float(state["i"]) == 2.0


def test_manager_restart(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), every=2)
    state = dict(r=torch.arange(5, dtype=F64), i=torch.tensor(0))
    for step in range(1, 5):
        state["i"] = torch.tensor(step)
        mgr.maybe_save(step, state)
    step, restored = mgr.restore_latest(_like(state), CPU)
    assert step == 4 and int(restored["i"]) == 4


def test_restore_rejects_shardings(tmp_path):
    """restore(shardings=) places each leaf where its NamedSharding says
    (whole, or split over a mesh axis); anything else is refused."""
    from repro_torch.launch.mesh import NamedSharding, ShardedTensor, \
        make_test_mesh
    x = torch.arange(10, dtype=F64)
    ck.save(str(tmp_path), 0, dict(x=x, y=torch.ones(3)))
    target = dict(x=torch.zeros(10, dtype=F64), y=torch.zeros(3))
    with pytest.raises(TypeError, match="NamedSharding"):
        ck.restore(str(tmp_path), 0, target, CPU,
                   shardings=dict(x=object(), y=None))
    mesh = make_test_mesh(4, device=CPU, model=4)
    out = ck.restore(str(tmp_path), 0, target, CPU, shardings=dict(
        x=NamedSharding(mesh, ("model",)), y=NamedSharding(mesh)))
    assert isinstance(out["x"], ShardedTensor)
    assert [p.shape[0] for p in out["x"].pieces] == [3, 3, 2, 2]
    assert torch.equal(out["x"].full(), x)
    assert torch.equal(out["y"], torch.ones(3))
    with pytest.raises(ValueError, match="first dim"):
        NamedSharding(mesh, (None, "model"))


# ---------------------------------------------------------------------------
# one on-disk format for both packages
# ---------------------------------------------------------------------------

def _mixed_state(rng):
    return dict(ranks=rng.random(50), batch_idx=np.int64(9),
                nested=dict(w=rng.standard_normal((3, 4)).astype(np.float32),
                            ids=[np.arange(5, dtype=np.int32),
                                 np.array(-3, np.int64)]))


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    state = _mixed_state(np.random.default_rng(0))
    jck.save(str(tmp_path), 3, jax.tree_util.tree_map(jnp.asarray, state))
    target = jax.tree_util.tree_map(
        lambda a: torch.empty(np.shape(a), device="meta",
                              dtype=torch.from_numpy(np.asarray(a)).dtype),
        state)
    step, out = ck.CheckpointManager(str(tmp_path)).restore_latest(target,
                                                                   CPU)
    assert step == 3
    for (k, a), (_, b) in zip(ck._flatten(state), ck._flatten(out)):
        assert b.dtype == torch.from_numpy(np.asarray(a)).dtype, k
        assert np.array_equal(b.numpy(), np.asarray(a)), k


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    state = _mixed_state(np.random.default_rng(1))
    tstate = jax.tree_util.tree_map(torch.from_numpy,
                                    jax.tree_util.tree_map(np.asarray, state))
    path = ck.save(str(tmp_path), 5, tstate)
    with open(os.path.join(path, "manifest.json")) as f:
        keys = [leaf["key"] for leaf in json.load(f)["leaves"]]
    assert keys == ["['batch_idx']", "['nested']['ids'][0]",
                    "['nested']['ids'][1]", "['nested']['w']", "['ranks']"]
    target = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(np.shape(a), np.asarray(a).dtype),
        state)
    out = jck.restore(str(tmp_path), 5, target)
    for a, b in zip(jax.tree_util.tree_leaves(state),
                    jax.tree_util.tree_leaves(out)):
        assert np.asarray(b).dtype == np.asarray(a).dtype
        assert np.array_equal(np.asarray(b), np.asarray(a))


# ---------------------------------------------------------------------------
# restart through the streaming driver's loop
# ---------------------------------------------------------------------------

def test_stream_restart_equivalence(tmp_path):
    """Kill-and-restart gives the uninterrupted run's ranks bit for bit,
    and the reference driver's within L∞ 1e-12."""
    ds = load_temporal("sx-mathoverflow")
    stream = TemporalStream(ds.edges, ds.num_vertices, 1e-3, 4)
    pre = stream.preload_edges()
    cap = len(pre) + stream.batch_size * stream.num_batches + 64

    def batch_update(i):
        return make_batch_update(np.zeros((0, 2)), stream.batch(i), 8,
                                 max(8, stream.batch_size), device=CPU)

    def fresh():
        return from_coo(pre[:, 0], pre[:, 1], ds.num_vertices,
                        edge_capacity=cap, device=CPU)
    g0 = fresh()
    r0 = drv.update_pagerank(g0, g0, None, None, "static").ranks
    quiet = lambda msg: None
    _, full, _ = drv.run_batches(g0, r0, batch_update, 0, 4,
                                 "frontier_prune", log=quiet)
    # interrupted in batch 2 (checkpoints every 2), then restarted
    mgr = ck.CheckpointManager(str(tmp_path), every=2)
    drv.run_batches(g0, r0, batch_update, 0, 3, "frontier_prune", mgr=mgr,
                    log=quiet)
    start, g_mid, r_mid = drv.restore_stream(mgr, fresh(), batch_update)
    assert start == 2
    _, resumed, rows = drv.run_batches(g_mid, r_mid, batch_update, start, 4,
                                       "frontier_prune", log=quiet)
    assert [r["batch"] for r in rows] == [2, 3]
    assert torch.equal(full, resumed)
    # the reference driver's loop on the same stream
    jg = jstr.from_coo(pre[:, 0], pre[:, 1], ds.num_vertices,
                       edge_capacity=cap)
    jr = j_update(jg, jg, None, None, "static").ranks
    for i in range(4):
        upd = jdyn.make_batch_update(np.zeros((0, 2)), stream.batch(i), 8,
                                     max(8, stream.batch_size))
        jg2 = jdyn.apply_batch(jg, upd)
        jr = j_update(jg, jg2, upd, jr, "frontier_prune").ranks
        jg = jg2
    assert float(np.abs(full.numpy() - np.asarray(jr)).max()) <= 1e-12


def _run(args, timeout=300):
    # one intra-op thread, as test_torch_common sets in-process: a thread
    # per core oversubscribes the CPU under the suite's xdist workers
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable] + args, capture_output=True,
                       text=True, env=env, cwd=_REPO, timeout=timeout)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    return r.stdout


def test_pagerank_driver_restarts_on_cpu(tmp_path, capsys):
    args = ["--device", "cpu", "--dataset", "sx-mathoverflow",
            "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)]
    assert drv.main(args + ["--batches", "2"]) == 0
    out = capsys.readouterr().out
    assert "stream complete" in out and "batch   1" in out
    assert os.listdir(tmp_path) == ["step_0000000002"]
    # the rerun as a user runs it: the module as a program
    out = _run(["-m", "repro_torch.launch.pagerank"] + args
               + ["--batches", "3"])
    assert "restored at batch 2" in out and "stream complete" in out
    lines = [ln for ln in out.splitlines() if ln.startswith("batch")]
    assert len(lines) == 1 and lines[0].startswith("batch   2")


@pytest.mark.parametrize("method", ["static", "naive", "traversal",
                                    "frontier"])
def test_pagerank_driver_runs_every_method(method, tmp_path, capsys):
    rc = drv.main(["--device", "cpu", "--dataset", "sx-mathoverflow",
                   "--method", method, "--batches", "1", "--check-error",
                   "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and "stream complete" in out
    assert float(out.split("L1err=")[1].split()[0]) < 1e-4


def test_pagerank_driver_takes_only_mesh_none(tmp_path, capsys):
    """``--mesh test`` replays the stream on a 2 x 2 test mesh (the CPU
    repeated); ``--mesh production`` needs 256 cards and says so; any
    other name is refused."""
    rc = drv.main(["--device", "cpu", "--mesh", "test", "--batches", "1",
                   "--check-error", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and "mesh {'data': 2, 'model': 2}" in out
    assert float(out.split("L1err=")[1].split()[0]) < 1e-4
    with pytest.raises(RuntimeError, match="production mesh"):
        drv.main(["--device", "cpu", "--mesh", "production"])
    with pytest.raises(SystemExit):
        drv.main(["--device", "cpu", "--mesh", "pods"])


def test_serve_driver_restarts_from_checkpoint(tmp_path, capsys):
    from repro_torch.launch.serve import main
    args = ["--device", "cpu", "--dataset", "sx-mathoverflow",
            "--flush-size", "64", "--flush-interval-ms", "1e9",
            "--query-every", "64", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    assert main(args + ["--events", "256"]) == 0
    out = capsys.readouterr().out
    assert "final generation 4, last_seq 255" in out
    assert sorted(os.listdir(tmp_path))[-1] == "step_0000000004"
    assert main(args + ["--events", "384"]) == 0
    out = capsys.readouterr().out
    assert "restored generation 4; replayed 256 events" in out
    gens = [int(ln.split("gen=")[1].split()[0]) for ln in out.splitlines()
            if "gen=" in ln]
    assert gens == [5, 6]                    # the clock goes on from 4
    assert "final generation 6, last_seq 383" in out
    # a feed shorter than the checkpoint is refused
    assert main(args + ["--events", "100"]) == 1
