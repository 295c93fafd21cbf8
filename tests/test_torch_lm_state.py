"""Port parity: the LM's state and its drivers.

Checkpoints of ``(LMParams, AdamWState)`` across the two packages (keys as
``jax.tree_util.keystr`` writes them, a ``None`` subtree without leaves,
bf16 leaves as the reference writes them), the in-place AdamW bitwise the
functional one, the synthetic corpus bitwise the reference's, the
prefetcher, ``convert``'s bf16 words, and ``launch.train`` restarting
from a checkpoint either package wrote.
"""
import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.configs.registry import REGISTRY as JREG
from repro.data import lm as jlm
from repro.ft import checkpoint as jckpt
from repro.launch import train as jtrain
from repro.optim import adamw as jadamw
from repro.train import inputs as JI
from repro.train import steps as JS

from repro_torch import convert
from repro_torch.configs.registry import REGISTRY as TREG
from repro_torch.data import lm as tlm
from repro_torch.ft import checkpoint as tckpt
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as TT
from repro_torch.models.tree import tree_leaves
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.schedules import warmup_cosine
from test_torch_common import CPU, assert_bitwise, np_

ARCH = "qwen2.5-3b"


def _reference_state():
    """A seeded f32 (LMParams, AdamWState) of the smoke config, one train
    step in (moments not zero)."""
    spec = JREG[ARCH]
    params = JI.init_fn(spec, True)(jax.random.PRNGKey(0))
    batch = JI.build_inputs(spec, spec.shapes["train_4k"], concrete=True,
                            smoke=True, seed=1)
    params, opt, _ = jax.jit(JS.make_lm_train_step(spec.smoke_config))(
        params, jadamw.init_adamw(params), batch)
    return params, opt


def _port_target():
    gen = torch.Generator()
    gen.manual_seed(0)
    params = TT.init_lm(TREG[ARCH].smoke_config, gen)
    return ttrain.checkpoint_state(params, tadamw.init_adamw(params))


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:010d}",
                           "manifest.json")) as f:
        return [(r["key"], r["shape"], r["dtype"])
                for r in json.load(f)["leaves"]]


def test_lm_checkpoint_crosses_packages(tmp_path):
    jstate = _reference_state()
    jleaves = jax.tree_util.tree_leaves(jstate)
    # written by the reference, restored in the port
    jckpt.save(str(tmp_path / "ref"), 1, jstate)
    step, got = tckpt.CheckpointManager(str(tmp_path / "ref")).\
        restore_latest(_port_target(), CPU)
    assert step == 1
    assert isinstance(got[0], TT.LMParams) and got[0].layers.moe is None
    assert len(tree_leaves(got)) == len(jleaves) == 43
    for a, b in zip(tree_leaves(got), jleaves):
        assert_bitwise(a, np.asarray(b), "reference -> port")
    # written by the port, restored in the reference
    params, opt = ttrain.from_checkpoint_state(got)
    tckpt.save(str(tmp_path / "port"), 1,
               ttrain.checkpoint_state(params, opt))
    back = jckpt.restore(str(tmp_path / "port"), 1, jstate)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jstate)
    for a, b in zip(jax.tree_util.tree_leaves(back), jleaves):
        assert_bitwise(np.asarray(a), np.asarray(b), "port -> reference")
    # one manifest: keys, shapes and dtypes
    want = _manifest(tmp_path / "ref", 1)
    assert _manifest(tmp_path / "port", 1) == want
    assert want[0][0] == "[0].embed" and want[-1][0] == "[1].v.ln_f"


def test_bf16_lm_checkpoint_restores_bitwise(tmp_path):
    """A bf16 LMParams written by the port: the reference's file format
    (``descr '<V2'``, dtype "bfloat16", crc32 of the raw bytes), restored
    bitwise in the port without ``ml_dtypes``."""
    import ml_dtypes
    cfg = dataclasses.replace(TREG["qwen3-moe-30b-a3b"].smoke_config,
                              dtype="bfloat16")
    gen = torch.Generator()
    gen.manual_seed(3)
    params = TT.init_lm(cfg, gen)
    tckpt.save(str(tmp_path), 2, params)
    man = _manifest(tmp_path, 2)
    assert {d for _, _, d in man} == {"bfloat16", "float32"}  # f32 router
    got = tckpt.restore(str(tmp_path), 2, params, device=CPU)
    for a, b in zip(tree_leaves(got), tree_leaves(params)):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.detach().view(torch.int16)
                           if b.dtype == torch.bfloat16 else b.detach())
    # the embedding's file is the one np.save writes for the reference's
    # bfloat16 array
    words = tckpt.host_array(params.embed)
    ref = tmp_path / "ref.npy"
    np.save(ref, words.view(np.uint16).view(ml_dtypes.bfloat16))
    with open(tmp_path / "step_0000000002" / "leaf_00000.npy", "rb") as f:
        mine = f.read()
    assert mine == ref.read_bytes()


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("pdt,mdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.float32),
                                     (torch.bfloat16, torch.bfloat16)])
def test_inplace_adamw_bitwise(factored, pdt, mdt, monkeypatch):
    """``adamw_update_`` (the train steps') equals ``adamw_update`` bit
    for bit over 3 steps: f32 and bf16 parameters and moments, factored
    (Adafactor rows/cols) and not, with weight decay."""
    monkeypatch.setattr(tadamw, "_FACTOR_MIN_SIZE", 64)
    rng = np.random.default_rng(0)
    shapes = [(3, 16, 8), (5,), (4, 3)]
    params = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              .to(pdt) for s in shapes]
    a = [p.clone() for p in params]
    b = [p.clone() for p in params]
    sa = tadamw.init_adamw(a, moment_dtype=mdt, factored=factored)
    sb = tadamw.init_adamw(b, moment_dtype=mdt, factored=factored)
    for _ in range(3):
        grads = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(pdt) for s in shapes]
        lr = warmup_cosine(sa.step, peak_lr=1e-2, warmup_steps=1,
                           total_steps=10)
        a, sa = tadamw.adamw_update(a, grads, sa, lr=lr, factored=factored)
        sb = tadamw.adamw_update_(b, grads, sb, lr=lr, factored=factored)
    for x, y in zip(a + tree_leaves(sa.m) + tree_leaves(sa.v),
                    b + tree_leaves(sb.m) + tree_leaves(sb.v)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert int(sa.step) == int(sb.step) == 3


def test_synthetic_corpus_bitwise():
    want, got = jlm.batches(512, 3, 40, seed=7), tlm.batches(512, 3, 40,
                                                             seed=7)
    for _ in range(3):
        w, g = next(want), next(got)
        for k in ("tokens", "labels"):
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])
    assert np.array_equal(tlm.SyntheticCorpus(97, 3).motifs,
                          jlm.SyntheticCorpus(97, 3).motifs)


def test_prefetcher_stages_batches_in_order():
    it = tlm.Prefetcher(tlm.batches(64, 2, 8, seed=1), depth=2, device=CPU)
    ref = tlm.batches(64, 2, 8, seed=1)
    for _ in range(4):
        got, want = next(it), next(ref)
        for k in want:
            assert got[k].device.type == "cpu"
            assert np.array_equal(np_(got[k]), want[k])
    it.stop()


def test_convert_carries_bf16_leaves_as_words():
    """The reference's bf16 parameters carry across bit for bit, and back
    as 2-byte words."""
    cfg = dataclasses.replace(JREG["arctic-480b"].smoke_config,
                              dtype="bfloat16")
    jp = repro.models.transformer.init_lm(cfg, jax.random.PRNGKey(1))
    host = jax.tree_util.tree_map(np.asarray, jp)
    tp = convert.lm_params_from_numpy(host, device=CPU)
    back = convert.lm_params_to_numpy(tp)
    for a, b, c in zip(tree_leaves(tp), jax.tree_util.tree_leaves(host),
                       tree_leaves(back)):
        assert a.requires_grad
        if b.dtype.name == "bfloat16":
            assert a.dtype == torch.bfloat16 and c.dtype == np.dtype("V2")
            assert np.array_equal(np_(a.view(torch.int16)),
                                  b.view(np.int16))
            assert np.array_equal(c.view(np.int16), b.view(np.int16))
        else:
            assert_bitwise(a.detach(), b, "f32 leaf")
    state = convert.adamw_state_from_numpy(
        host, 0, jax.tree_util.tree_map(np.asarray, jadamw.init_adamw(
            jp, moment_dtype=jax.numpy.bfloat16, factored=True).m),
        jax.tree_util.tree_map(np.asarray, jadamw.init_adamw(
            jp, moment_dtype=jax.numpy.bfloat16, factored=True).v),
        device=CPU)
    assert {m.dtype for m in state.m} == {torch.bfloat16}
    assert len(state.m) == len(state.v) == len(tree_leaves(tp))


def _train_args(ckpt, steps, every=3):
    return ["--smoke", "--steps", str(steps), "--batch", "2", "--seq",
            "32", "--ckpt-every", str(every), "--log-every", "1",
            "--ckpt-dir", str(ckpt)]


def _losses(out):
    return {int(line.split()[1]): float(line.split()[3])
            for line in out.splitlines() if line.startswith("step ")}


@pytest.mark.parametrize("first", ["reference", "port"])
def test_launch_train_restarts_from_either_package(first, tmp_path, capsys):
    """A run checkpointed by one package goes on in the other from its
    step ("restored checkpoint at step 6"): the loss of the next step, on
    the restored parameters, agrees with the first package's own next
    step (printed to 4 decimals), and both write the same manifest."""
    mains = dict(reference=jtrain.main,
                 port=lambda a: ttrain.main(a + ["--device", "cpu"]))
    second = "port" if first == "reference" else "reference"
    a, b = tmp_path / "a", tmp_path / "b"
    assert mains[first](_train_args(a, 6)) == 0
    shutil.copytree(a, b)
    capsys.readouterr()
    assert mains[second](_train_args(a, 7, every=1)) == 0
    out = capsys.readouterr().out
    assert "restored checkpoint at step 6" in out and "final loss" in out
    assert mains[first](_train_args(b, 7, every=1)) == 0
    own = capsys.readouterr().out
    assert "restored checkpoint at step 6" in own
    assert abs(_losses(out)[7] - _losses(own)[7]) <= 2e-4
    assert _manifest(a, 7) == _manifest(b, 7)
