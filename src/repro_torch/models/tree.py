"""Parameter trees laid out as the reference's pytrees.

The reference's parameters are nested dicts, lists and tuples of arrays,
and its optimizer walks them in ``jax.tree_util.tree_flatten`` order:
dict keys sorted, sequences in order.  ``ParamTree`` holds the same
nesting with each array an ``nn.Parameter`` (trainable), registered in
that flatten order, so ``leaves()`` pairs leaf for leaf with the
reference's ``tree_leaves`` and an ``AdamWState`` carries across.
``tree_leaves`` / ``tree_map`` / ``tree_unflatten`` are the few pytree
functions the port needs, over the same containers; ``trainable`` makes
every leaf of a pytree of tensors (the LM's and DeepFM's NamedTuples) an
``nn.Parameter``.  ``randn`` is the inits' draw: on the ``meta`` device
it draws nothing (``train.inputs.abstract_state``).
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch
from torch import nn

__all__ = ["ParamTree", "init_device", "randn", "tree_leaves", "tree_map",
           "tree_unflatten", "trainable"]


def init_device(generator: torch.Generator, device=None) -> torch.device:
    """Where an init builds its leaves: ``device``, else the generator's."""
    return generator.device if device is None else torch.device(device)


def randn(shape, generator: torch.Generator, device: torch.device,
          dtype=torch.float32) -> torch.Tensor:
    """N(0, 1) draws of ``shape`` from ``generator`` on ``device``; on
    ``meta`` nothing is drawn (the shape and dtype alone)."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=device)


def tree_leaves(tree) -> List[Any]:
    """The leaves in ``jax.tree_util.tree_flatten`` order (None has
    none)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the nesting."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, t, *(r[i] for r in rest))
                            for i, t in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(like, leaves) -> Any:
    """``like``'s nesting with ``leaves`` (in flatten order) in place of
    its own."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def trainable(tree):
    """``tree`` with every leaf a trainable ``nn.Parameter`` (a leaf that
    already is one is kept)."""
    leaves = [p if isinstance(p, nn.Parameter) else nn.Parameter(p)
              for p in tree_leaves(tree)]
    return tree_unflatten(tree, leaves)


class ParamTree(nn.Module):
    """A reference parameter pytree as trainable ``nn.Parameter``s.

    ``tree`` is the nesting (dicts, lists, tuples) with each array a
    parameter; model functions read it as the reference reads its
    pytree.  The parameters are registered as ``leaf<i>`` in flatten
    order, so ``parameters()`` and ``leaves()`` follow it."""

    def __init__(self, tree):
        super().__init__()
        params = [p if isinstance(p, nn.Parameter) else nn.Parameter(p)
                  for p in tree_leaves(tree)]
        for i, p in enumerate(params):
            self.register_parameter(f"leaf{i}", p)
        self.tree = tree_unflatten(tree, params)

    def leaves(self) -> List[torch.Tensor]:
        """The parameters in ``jax.tree_util.tree_flatten`` order."""
        return list(self.parameters())
