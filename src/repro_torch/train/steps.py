"""Train, prefill, decode and serve steps, LM, GNN and recsys families
(twin of ``repro.train.steps``).

``make_lm_train_step(cfg)``, ``make_gnn_train_step(arch_id, cfg)`` and
``make_recsys_train_step(cfg)`` return ``train_step(params, opt_state,
batch) -> (params, opt_state, loss)``: the loss and its gradients
(``torch.autograd.grad`` over the parameters' leaves in ``jax.tree_util``
flatten order), a
``warmup_cosine`` learning rate and an AdamW update that runs leaf by
leaf in place (``optim.adamw_update_``, bitwise the functional
``adamw_update``): the parameters and moments are overwritten, and no
second optimizer state is ever alive.  Every row sum of the forward and
the backward goes through ``pull_rows`` in a fixed order
(``models.message``), so a step is the same bit for bit from run to run
on the card; nothing in it reads the device back.

``_accumulate_grads`` splits the batch's leading dim into microbatches and
averages their gradients, as the reference's ``lax.scan`` does, adding
each microbatch's gradients into one accumulator in place.
``make_lm_prefill`` projects only the last position's logits;
``make_lm_decode_step`` is ``models.transformer.decode_step``.
``make_recsys_serve`` and ``make_recsys_retrieval`` score without
gradients.  The recsys step updates every table row (the dense AdamW
update of the reference, whose gradient is dense): its table gradient is
one ``pull_rows`` over the batch's ids.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from repro_torch.models import gnn as G
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.models.tree import ParamTree, tree_leaves, tree_map
from repro_torch.optim.adamw import AdamWState, adamw_update_
from repro_torch.optim.compression import compress_tree
from repro_torch.optim.schedules import warmup_cosine

F32 = torch.float32


def value_and_grad(loss_fn: Callable, params, batch
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(loss, gradients in the leaves' flatten order) of a ``ParamTree``
    or a pytree of parameters (``LMParams``); a leaf the loss does not
    reach gets zeros, as ``jax.grad`` gives it."""
    leaves = params.leaves() if isinstance(params, ParamTree) \
        else tree_leaves(params)
    with torch.enable_grad():
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


def _accumulate_grads(loss_fn, params, batch, n_micro: int,
                      accum_dtype=F32):
    """Split the batch's leading dim into ``n_micro`` slices and average
    the gradients (``accum_dtype`` is the accumulator's; each slice's
    gradients are added into it in place, then scaled in place where it
    is f32)."""
    if n_micro <= 1:
        return value_and_grad(loss_fn, params, batch)
    reshaped = tree_map(
        lambda x: x.reshape((n_micro, x.shape[0] // n_micro)
                            + tuple(x.shape[1:])), batch)
    loss_acc = None
    grad_acc = None
    for i in range(n_micro):
        loss, grads = value_and_grad(loss_fn, params,
                                     tree_map(lambda x: x[i], reshaped))
        if grad_acc is None:
            grad_acc = [torch.zeros(g.shape, dtype=accum_dtype,
                                    device=g.device) for g in grads]
        for a, g in zip(grad_acc, grads):
            a.add_(g.to(accum_dtype))
        del grads
        loss_acc = loss if loss_acc is None else loss_acc + loss
    scale = 1.0 / n_micro
    return loss_acc * scale, [g.mul_(scale) if g.dtype == F32
                              else g.to(F32) * scale for g in grad_acc]


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

def make_lm_train_step(cfg, *, peak_lr=3e-4, warmup=100, total=10_000,
                       n_microbatches: int = 1,
                       grad_compression: str = "none",
                       factored: bool = False,
                       accum_dtype=F32) -> Callable:
    def loss_fn(params, batch):
        return T.lm_loss(cfg, params, batch["tokens"], batch["labels"])

    def train_step(params, opt_state: AdamWState, batch):
        loss, grads = _accumulate_grads(loss_fn, params, batch,
                                        n_microbatches, accum_dtype)
        grads = compress_tree(grads, grad_compression)
        lr = warmup_cosine(opt_state.step, peak_lr=peak_lr,
                           warmup_steps=warmup, total_steps=total)
        opt_state = adamw_update_(params, grads, opt_state, lr=lr,
                                  factored=factored)
        return params, opt_state, loss

    return train_step


def make_lm_prefill(cfg) -> Callable:
    @torch.no_grad()
    def prefill(params, tokens):
        # only the LAST position's logits start decoding: the full f32
        # [B, S, V] logits of prefill_32k (32 x 32,768 x 151,936) would
        # be 637 GB
        x, _ = T.backbone(cfg, params, tokens)
        return T.logits_of(params, x[:, -1, :])

    return prefill


def make_lm_decode_step(cfg) -> Callable:
    def serve_step(params, cache: T.KVCache, tokens):
        return T.decode_step(cfg, params, cache, tokens)

    return serve_step


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------

def _xent(logits, labels, mask=None):
    """Mean cross-entropy; with ``mask`` over its rows, in f64 as the
    reference's (its f32 sum over an int count).  The gold logit is picked
    by a one-hot select: no scatter in the backward."""
    logz = torch.logsumexp(logits, dim=-1)
    pick = labels.long()[..., None] == torch.arange(
        logits.shape[-1], device=logits.device)
    gold = torch.where(pick, logits, 0.0).sum(dim=-1)
    per = logz - gold
    if mask is not None:
        per = torch.where(mask, per, 0.0)
        return torch.sum(per).double() / torch.clamp(
            mask.sum(), min=1).double()
    return torch.mean(per)


def _graph_batch(batch) -> G.GraphBatch:
    return G.GraphBatch(
        node_feats=batch["node_feats"],
        edge_src=batch["edge_src"], edge_dst=batch["edge_dst"],
        edge_mask=batch["edge_mask"], node_mask=batch["node_mask"],
        positions=batch.get("positions"),
        mesh_feats=batch.get("mesh_feats"),
        g2m_src=batch.get("g2m_src"), g2m_dst=batch.get("g2m_dst"),
        m2g_src=batch.get("m2g_src"), m2g_dst=batch.get("m2g_dst"))


def make_gnn_loss(spec_arch_id: str, cfg) -> Callable:
    """(params, batch) -> scalar loss for each GNN arch."""
    if spec_arch_id == "graphsage-reddit":
        def loss_fn(params, batch):
            if "blocks_parent" in batch:       # minibatch path
                logits = G.sage_block_forward(
                    cfg, params, batch["blocks_feats"],
                    batch["blocks_parent"], batch["blocks_mask"])
                return _xent(logits, batch["labels"])
            logits = G.sage_forward(cfg, params, _graph_batch(batch))
            return _xent(logits, batch["labels"], batch["node_mask"])
        return loss_fn
    if spec_arch_id == "pna":
        def loss_fn(params, batch):
            logits = G.pna_forward(cfg, params, _graph_batch(batch))
            return _xent(logits, batch["labels"], batch["node_mask"])
        return loss_fn
    if spec_arch_id == "nequip":
        def loss_fn(params, batch):
            args = (batch["species"], batch["positions"], batch["edge_src"],
                    batch["edge_dst"], batch["edge_mask"])
            # a batch of molecules is one graph with node offsets
            if batch["species"].dim() == 2:
                energies = G.nequip_energies(cfg, params, *args)
            else:
                energies = G.nequip_forward(cfg, params, *args)
            return torch.mean(torch.square(energies - batch["energy"]))
        return loss_fn
    if spec_arch_id == "graphcast":
        def loss_fn(params, batch):
            pred = G.graphcast_forward(cfg, params, _graph_batch(batch))
            se = torch.square(pred - batch["targets"])
            m = batch["node_mask"]
            n_valid = torch.clamp(torch.sum(m.to(F32)), min=1.0)
            return torch.sum(torch.where(m[:, None], se, 0.0)) \
                / (n_valid * se.shape[-1])
        return loss_fn
    raise KeyError(spec_arch_id)


def make_gnn_train_step(arch_id: str, cfg, *, peak_lr=1e-3) -> Callable:
    loss_fn = make_gnn_loss(arch_id, cfg)

    def train_step(params: ParamTree, opt_state: AdamWState, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        lr = warmup_cosine(opt_state.step, peak_lr=peak_lr,
                           warmup_steps=10, total_steps=1000)
        opt_state = adamw_update_(params, grads, opt_state, lr=lr,
                                  weight_decay=0.0)
        return params, opt_state, loss

    return train_step


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------

def make_recsys_train_step(cfg, *, peak_lr=1e-3) -> Callable:
    def loss_fn(params, batch):
        return R.deepfm_loss(cfg, params, batch["sparse_ids"],
                             batch["labels"])

    def train_step(params: R.DeepFMParams, opt_state: AdamWState, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        lr = warmup_cosine(opt_state.step, peak_lr=peak_lr,
                           warmup_steps=10, total_steps=10_000)
        opt_state = adamw_update_(params, grads, opt_state, lr=lr,
                                  weight_decay=0.0)
        return params, opt_state, loss

    return train_step


def make_recsys_serve(cfg) -> Callable:
    @torch.no_grad()
    def serve(params, batch):
        return torch.sigmoid(
            R.deepfm_forward(cfg, params, batch["sparse_ids"]))

    return serve


def make_recsys_retrieval(cfg) -> Callable:
    @torch.no_grad()
    def retrieve(params, batch):
        return R.retrieval_score(cfg, params, batch["query_ids"],
                                 batch["cand_ids"])

    return retrieve
