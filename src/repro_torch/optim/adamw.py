"""AdamW with a configurable moment dtype, Adafactor-factored second
moments and decoupled weight decay (twin of ``repro.optim.adamw``).

Parameters, gradients and moments are lists of tensors in
``jax.tree_util.tree_flatten`` order (``models.tree``: a ``ParamTree``'s
``leaves()``), so a state carries across from the reference leaf for leaf
(``convert.adamw_state_from_numpy``).  A factored leaf's second moment is
the pair (v_row, v_col).  ``adamw_update`` is functional: it returns new
tensors and writes nothing in place.  ``adamw_update_`` is the update the
train steps run: leaf by leaf, in place, with at most a few f32 buffers
of one leaf alive at a time (two whole optimizer states never are), and
bit for bit ``adamw_update``'s result (the same f32 operations in the
same order).
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch

from repro_torch.models.tree import ParamTree, tree_leaves

F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32[]
    m: list              # a tensor a parameter leaf
    v: list              # a tensor, or (v_row, v_col) when factored


_FACTOR_MIN_SIZE = 1 << 20


def _leaves(params) -> List[torch.Tensor]:
    if isinstance(params, ParamTree):
        return params.leaves()
    return tree_leaves(params)


def _is_factored(p: torch.Tensor, factored: bool) -> bool:
    return factored and p.dim() >= 2 and p.numel() >= _FACTOR_MIN_SIZE


def init_adamw(params, moment_dtype=F32,
               factored: bool = False) -> AdamWState:
    leaves = _leaves(params)
    dev = leaves[0].device if leaves else None

    def vinit(p):
        if _is_factored(p, factored):
            # Adafactor row/col second moment: O(n+m) instead of O(nm)
            return (torch.zeros(p.shape[:-1], dtype=F32, device=p.device),
                    torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=F32,
                                device=p.device))
        return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)

    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m=[torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
           for p in leaves],
        v=[vinit(p) for p in leaves])


def adamw_update(params, grads: Sequence[torch.Tensor], state: AdamWState,
                 *, lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                 factored: bool = False):
    """Returns (new parameter leaves, new state).  ``lr`` may be a
    schedule value (a tensor)."""
    step = state.step + 1
    b1c = 1.0 - b1 ** step.to(F32)
    b2c = 1.0 - b2 ** step.to(F32)

    def upd(p, g, m, v):
        g32 = g.to(F32)
        m_new = b1 * m.to(F32) + (1 - b1) * g32
        mhat = m_new / b1c
        if _is_factored(p, factored):
            vr, vc = v
            g2 = torch.square(g32) + 1e-30
            vr_new = b2 * vr + (1 - b2) * torch.mean(g2, dim=-1)
            vc_new = b2 * vc + (1 - b2) * torch.mean(g2, dim=-2)
            vhat = (vr_new[..., :, None] * vc_new[..., None, :]
                    / torch.maximum(
                        torch.mean(vr_new, dim=-1, keepdim=True)[..., None],
                        vr_new.new_full((), 1e-30))) / b2c
            v_out = (vr_new, vc_new)
        else:
            v_new = b2 * v.to(F32) + (1 - b2) * torch.square(g32)
            vhat = v_new / b2c
            v_out = v_new.to(v.dtype)
        delta = mhat / (torch.sqrt(vhat) + eps) + \
            weight_decay * p.to(F32)
        p_new = p.to(F32) - lr * delta
        return p_new.to(p.dtype), m_new.to(m.dtype), v_out

    with torch.no_grad():
        out = [upd(p, g, m, v) for p, g, m, v in
               zip(_leaves(params), grads, state.m, state.v)]
    return ([o[0] for o in out],
            AdamWState(step, [o[1] for o in out], [o[2] for o in out]))


def adamw_update_(params, grads: Sequence[torch.Tensor], state: AdamWState,
                  *, lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                  factored: bool = False) -> AdamWState:
    """``adamw_update`` written into the parameters and moments in place,
    leaf by leaf; returns the state with its step advanced (the same
    moment tensors).  Every value is bitwise ``adamw_update``'s."""
    step = state.step + 1
    b1c = 1.0 - b1 ** step.to(F32)
    b2c = 1.0 - b2 ** step.to(F32)
    with torch.no_grad():
        for p, g, m, v in zip(_leaves(params), grads, state.m, state.v):
            g32 = g.to(F32)
            # m_new = b1·m + (1 − b1)·g, kept in f32 for mhat
            mf = m if m.dtype == F32 else m.to(F32)
            mf.mul_(b1).add_(torch.mul(g32, 1 - b1))
            if mf is not m:
                m.copy_(mf)
            if _is_factored(p, factored):
                vr, vc = v
                g2 = torch.square(g32).add_(1e-30)
                del g32
                vr.mul_(b2).add_(torch.mean(g2, dim=-1).mul_(1 - b2))
                vc.mul_(b2).add_(torch.mean(g2, dim=-2).mul_(1 - b2))
                del g2
                vhat = torch.mul(vr[..., :, None], vc[..., None, :])
                vhat.div_(torch.maximum(
                    torch.mean(vr, dim=-1, keepdim=True)[..., None],
                    vr.new_full((), 1e-30))).div_(b2c)
            else:
                vhat = torch.square(g32).mul_(1 - b2)
                del g32
                vf = v if v.dtype == F32 else v.to(F32)
                vf.mul_(b2).add_(vhat)
                if vf is not v:
                    v.copy_(vf)
                torch.div(vf, b2c, out=vhat)
                del vf
            mhat = torch.div(m, b1c) if mf is m else mf.div_(b1c)
            del mf
            # delta = mhat / (sqrt(vhat) + eps) + weight_decay · p
            mhat.div_(vhat.sqrt_().add_(eps))
            vhat.copy_(p)
            mhat.add_(vhat.mul_(weight_decay))
            # p_new = p − lr · delta, rounded to p's dtype
            mhat.mul_(lr)
            if p.dtype == F32:
                p.sub_(mhat)
            else:
                vhat.copy_(p)
                p.copy_(vhat.sub_(mhat))
            del mhat, vhat
    return AdamWState(step, state.m, state.v)
