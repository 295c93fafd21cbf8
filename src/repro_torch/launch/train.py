"""End-to-end LM training driver on the port: ``--arch <id> [--steps N]``
(twin of ``repro.launch.train``).

A training loop with the full substrate: config registry, the synthetic
corpus through a background prefetcher, AdamW, a checkpoint every
``--ckpt-every`` steps, restart from the newest one, loss logging.  The
checkpoint holds ``(params, AdamWState(step, m, v))`` in the reference's
structure (the moments nested as the parameters), so a checkpoint of
either package restores in the other (f32 configs; the reference cannot
read bf16 leaves back).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --smoke --steps 200

Runs on the CUDA card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.data.lm import Prefetcher, batches
from repro_torch.device import resolve_device
from repro_torch.ft.checkpoint import CheckpointManager, flatten_up_to
from repro_torch.models.transformer import trainable
from repro_torch.models.tree import tree_unflatten
from repro_torch.optim.adamw import AdamWState, init_adamw
from repro_torch.train import inputs as I
from repro_torch.train import steps as S


def checkpoint_state(params, opt: AdamWState):
    """(params, opt) as the reference checkpoints them: the moments nested
    as the parameters."""
    return params, AdamWState(opt.step, tree_unflatten(params, opt.m),
                              tree_unflatten(params, opt.v))


def from_checkpoint_state(state):
    """The inverse of ``checkpoint_state``: trainable parameters and the
    moments as lists in flatten order."""
    params, opt = state
    params = trainable(params)
    return params, AdamWState(opt.step, flatten_up_to(params, opt.m),
                              flatten_up_to(params, opt.v))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized ~100M-max model)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    spec = get_arch(args.arch)
    if spec.family != "lm":
        raise SystemExit("launch.train drives LM archs; use launch.pagerank "
                         "or examples/ for graph/recsys workloads")
    cfg = spec.smoke_config if args.smoke else spec.config
    print(f"arch={args.arch} params≈{cfg.param_count()/1e6:.1f}M "
          f"(active {cfg.active_param_count()/1e6:.1f}M)")

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = I.init_fn(spec, smoke=args.smoke)(gen)
    opt = init_adamw(params)
    step_fn = S.make_lm_train_step(cfg)
    mgr = CheckpointManager(args.ckpt_dir, every=args.ckpt_every)

    start, restored = mgr.restore_latest(checkpoint_state(params, opt),
                                         device)
    if restored is not None:
        params, opt = from_checkpoint_state(restored)
        print(f"restored checkpoint at step {start}")
    start = start or 0

    data = Prefetcher(batches(cfg.vocab, args.batch, args.seq, seed=1),
                      device=device)
    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        batch = next(data)
        params, opt, loss = step_fn(params, opt, batch)
        losses.append(float(loss))
        if (step + 1) % args.log_every == 0:
            rate = args.batch * args.seq * args.log_every \
                / (time.time() - t0)
            recent = float(np.mean(losses[-args.log_every:]))
            print(f"step {step+1:5d} loss {recent:.4f} tok/s {rate:,.0f}",
                  flush=True)
            t0 = time.time()
        mgr.maybe_save(step + 1, checkpoint_state(params, opt))
    data.stop()
    print(f"final loss {np.mean(losses[-10:]):.4f} "
          f"(start {np.mean(losses[:10]):.4f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
