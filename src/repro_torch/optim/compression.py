"""Gradient compression hooks (twin of ``repro.optim.compression``).

Quantise then dequantise a gradient tree, as a numerics experiment: on one
card no collective carries the quantised values, as in the reference
(whose note says the cast does not shrink its all-reduce either).
"""
from __future__ import annotations

import torch

from repro_torch.models.tree import tree_map


def quantize_int8(g: torch.Tensor):
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32):
    return q.to(dtype) * scale


def compress_tree(grads, mode: str):
    """Quantise then dequantise every leaf of ``grads`` (a list or a
    pytree): ``none``, ``bf16`` or ``int8``."""
    if mode == "none":
        return grads
    if mode == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16).to(g.dtype), grads)
    if mode == "int8":
        def qdq(g):
            q, s = quantize_int8(g.to(torch.float32))
            return dequantize_int8(q, s).to(g.dtype)
        return tree_map(qdq, grads)
    raise ValueError(f"unknown compression mode {mode!r}")
