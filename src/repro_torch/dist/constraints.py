"""Logical sharding hints for model code (twin of
``repro.dist.constraints``).

Model layers name the dims of their activations with *logical* axes, and
this module resolves them against the active mesh (``use_mesh``); with
no active mesh every hint resolves to nothing.

Logical axes:
  * ``"batch"`` — the data-parallel axes (``data``, plus ``pod`` when the
    mesh has one): batch/token dims of activations;
  * ``"tp"``    — the ``model`` axis: feature/vocab/expert dims;
  * ``"full"``  — every mesh axis combined: giant node/edge tables
    flat-sharded over the whole slice;
  * ``None``    — replicated / no constraint for that dim;
  * any other string names a mesh axis itself.

A hint applies only when the dim's size divides by the resolved axes'
size.

One controller holds every tensor whole (``launch/mesh.py``), so there is
no partitioner to hand a constraint to: ``constrain`` checks its
arguments and returns ``x``.  What a mesh changes in a result is
``data_shards()``: the MoE ranks its tokens within each data shard
(``models/moe.py``), as the reference does under a mesh.  ``use_mesh`` is
the port's own twin of ``jax.set_mesh`` (and of ``repro.compat.
active_mesh``, which the port does not import).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Iterator

import torch

__all__ = ["active_mesh", "constrain", "data_shards", "use_mesh"]

_ACTIVE = threading.local()


def active_mesh():
    """The mesh installed by ``use_mesh`` on this thread, else None."""
    return getattr(_ACTIVE, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator:
    """Make ``mesh`` (a ``launch.mesh.Mesh``, or None for none) the active
    mesh inside the block, on this thread."""
    prev = active_mesh()
    _ACTIVE.mesh = mesh
    try:
        yield mesh
    finally:
        _ACTIVE.mesh = prev


def _axis_sizes(mesh) -> dict:
    return dict(mesh.shape)


def _resolve(name, mesh) -> tuple:
    """Logical name -> tuple of mesh axis names present on this mesh."""
    if name is None:
        return ()
    names = _axis_sizes(mesh)
    if name == "tp":
        axes = ("model",)
    elif name == "batch":
        axes = ("pod", "data")
    elif name == "full":
        axes = ("pod", "data", "model")
    else:                                   # explicit mesh axis name
        axes = (name,)
    return tuple(a for a in axes if a in names)


def data_shards() -> int:
    """Number of shards on the data-parallel axes of the active mesh (1 when
    no mesh is active): the MoE ranks its tokens within each."""
    mesh = active_mesh()
    if mesh is None:
        return 1
    sizes = _axis_sizes(mesh)
    return int(math.prod(sizes[a] for a in _resolve("batch", mesh)) or 1)


def constrain(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` with logical names, one
    per dim of ``x`` at most.  Checks the names and returns ``x``: one
    controller holds the whole tensor, so no layout changes."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"constrain: x must be a tensor, got "
                        f"{type(x).__name__}")
    if len(logical_axes) > x.dim():
        raise ValueError(f"constrain: {len(logical_axes)} axes for a tensor "
                         f"of {x.dim()} dims")
    for name in logical_axes:
        if name is not None and not isinstance(name, str):
            raise TypeError(f"constrain: axis names are strings or None, "
                            f"got {name!r}")
    return x
