"""Sharding rules per arch family for the dry-run cells (twin of
``repro.dist.sharding``).

The rules are the reference's: LM/MoE weights split their feature, vocab
or expert dim over ``model`` (tensor parallelism; expert parallelism for
the MoE stacks), batches their leading dim over the data axes, GNN
parameters stay whole (small), recsys embedding tables split by row over
``model``.  Optimizer state takes its parameters' rules leaf for leaf (a
factored second moment by its own shapes).  Every rule is guarded by
divisibility: a dim that does not divide over its axes stays whole.

A rule gives a ``ShardSpec``: the mesh and, per dim, the mesh axis (or
tuple of axes) it is split over, the reference's ``NamedSharding(mesh,
P(*spec))``; ``()`` is whole on every device.  Any dim may be split here.
The port runs one controller, so nothing is placed by these specs: the
dry-run (``launch/dryrun.py``) reads each leaf's bytes a device from
them.  ``launch.mesh.NamedSharding``, which places restored checkpoints,
splits only the first dim.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.launch.mesh import data_axes
from repro_torch.models.tree import ParamTree
from repro_torch.optim.adamw import AdamWState

__all__ = ["ShardSpec", "data_axes", "family_shardings", "lm_cache_specs"]


class ShardSpec(NamedTuple):
    """Where a leaf lies on a mesh: ``spec[i]`` is the mesh axis name (or
    tuple of names) dim i is split over, or None; ``()`` replicates."""

    mesh: Any
    spec: tuple = ()

    def split(self, dim: int) -> int:
        """How many ways dim ``dim`` is split."""
        if dim >= len(self.spec) or self.spec[dim] is None:
            return 1
        return _axis_size(self.mesh, self.spec[dim])

    def device_shape(self, shape) -> tuple:
        """A device's block of a leaf of ``shape`` (ceil division)."""
        return tuple(-(-int(s) // self.split(i)) for i, s in enumerate(shape))

    def device_bytes(self, leaf: torch.Tensor) -> int:
        """Bytes of ``leaf`` on one device."""
        return math.prod(self.device_shape(leaf.shape)) * leaf.element_size()


def _axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    sizes = dict(mesh.shape)
    return int(math.prod(sizes[a] for a in axes) or 1)


def _map_named(obj, fn, path=()):
    """A tree map that hands each leaf's NamedTuple field and dict key
    names to ``fn`` as its path; model classes are matched by field name,
    never imported."""
    if obj is None:
        return None
    if hasattr(obj, "_fields"):                 # NamedTuple
        return type(obj)(*[_map_named(getattr(obj, f), fn, path + (f,))
                           for f in obj._fields])
    if isinstance(obj, dict):
        return {k: _map_named(v, fn, path + (k,)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_named(v, fn, path + (i,))
                         for i, v in enumerate(obj))
    return fn(path, obj)


def _shard_dim(mesh, leaf, dim: Optional[int], axes=("model",)):
    """``dim`` split over ``axes`` where they are on the mesh and divide
    it, else whole; None for a leaf with no shape (a python scalar)."""
    shape = getattr(leaf, "shape", None)
    if shape is None:
        return None
    axes = tuple(a for a in axes if a in mesh.axis_names)
    n = _axis_size(mesh, axes)
    if (dim is None or not axes or n <= 1 or dim >= len(shape)
            or shape[dim] % n != 0):
        return ShardSpec(mesh, ())
    spec = [None] * len(shape)
    spec[dim] = axes[0] if len(axes) == 1 else axes
    return ShardSpec(mesh, tuple(spec))


# --- per-family parameter rules (leaf name -> dim split over 'model') ------

_LM_LAST = ("wq", "wk", "wv", "w_gate", "w_up", "bq", "bk", "bv",
            "w_router")
_LM_SECOND_LAST = ("wo", "w_down")


def _names(path) -> list:
    return [p for p in path if isinstance(p, str)]


def _lm_rule(mesh, path, leaf):
    names = _names(path)
    name = names[-1] if names else ""
    ndim = len(getattr(leaf, "shape", ()))
    if name == "embed":
        return _shard_dim(mesh, leaf, 0)        # vocab rows over 'model'
    if "moe" in names and name in ("w_gate", "w_up", "w_down"):
        return _shard_dim(mesh, leaf, 1)        # [L, E, ...]: expert dim
    if name in _LM_LAST:
        return _shard_dim(mesh, leaf, ndim - 1)
    if name in _LM_SECOND_LAST:
        return _shard_dim(mesh, leaf, ndim - 2)
    return _shard_dim(mesh, leaf, None)         # norms, scalars


def _recsys_rule(mesh, path, leaf):
    names = _names(path)
    name = names[-1] if names else ""
    ndim = len(getattr(leaf, "shape", ()))
    if name in ("table", "table_w"):
        return _shard_dim(mesh, leaf, 0)        # embedding rows
    if name == "mlp_ws":
        return _shard_dim(mesh, leaf, ndim - 1)
    return _shard_dim(mesh, leaf, None)


def _gnn_rule(mesh, path, leaf):
    return _shard_dim(mesh, leaf, None)         # params small: replicate


_PARAM_RULES = {"lm": _lm_rule, "gnn": _gnn_rule, "recsys": _recsys_rule}


def _batch_rule(mesh, path, leaf):
    return _shard_dim(mesh, leaf, 0, data_axes(mesh))   # data-parallel


def _leaf_paths(tree, path=()) -> list:
    """The paths of ``tree``'s leaves in ``jax.tree_util`` flatten order
    (dict keys sorted), as ``_map_named`` names them."""
    if tree is None:
        return []
    if hasattr(tree, "_fields"):
        return [q for f in tree._fields
                for q in _leaf_paths(getattr(tree, f), path + (f,))]
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _leaf_paths(tree[k],
                                                             path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [q for i, t in enumerate(tree)
                for q in _leaf_paths(t, path + (i,))]
    return [path]


def _opt_specs(rule, mesh, params, opt: AdamWState) -> AdamWState:
    """The port's ``AdamWState`` holds its moments as lists in the
    parameters' flatten order: moment i takes parameter i's path under
    ``m`` / ``v``, as the reference's state (a tree like the parameters)
    names it, so the name rules apply; factored (v_row, v_col) leaves go
    by their own shapes."""
    paths = _leaf_paths(params)
    if len(paths) != len(opt.m):
        raise ValueError(f"{len(opt.m)} moments for {len(paths)} "
                         "parameter leaves")
    return AdamWState(
        step=rule(mesh, ("step",), opt.step),
        m=[_map_named(m, lambda p, leaf: rule(mesh, p, leaf), ("m",) + q)
           for q, m in zip(paths, opt.m)],
        v=[_map_named(v, lambda p, leaf: rule(mesh, p, leaf), ("v",) + q)
           for q, v in zip(paths, opt.v)])


def family_shardings(family: str, mesh, params: Any, batch: Any,
                     opt: Any = None):
    """(param specs, batch specs, opt specs or None): ``ShardSpec`` trees
    in the shapes of ``params`` (a ``ParamTree``'s nesting for one),
    ``batch`` and ``opt``."""
    rule = _PARAM_RULES[family]
    if isinstance(params, ParamTree):
        params = params.tree
    pspec = _map_named(params, lambda p, leaf: rule(mesh, p, leaf))
    bspec = _map_named(batch, lambda p, leaf: _batch_rule(mesh, p, leaf))
    ospec = None if opt is None else _opt_specs(rule, mesh, params, opt)
    return pspec, bspec, ospec


def lm_cache_specs(mesh, cache, batch: int):
    """KV-cache specs: batch over the data axes, KV heads over ``model``
    (both guarded by divisibility); the sequence stays whole, as the
    decode step writes one position a step."""
    dax = data_axes(mesh)
    k = cache.k                                  # [L, B, S_max, KVH, hd]
    spec = [None] * 5
    if dax and batch % _axis_size(mesh, dax) == 0:
        spec[1] = dax[0] if len(dax) == 1 else dax
    if k.shape[3] % _axis_size(mesh, "model") == 0:
        spec[3] = "model"
    kv = ShardSpec(mesh, tuple(spec))
    return type(cache)(k=kv, v=kv, length=ShardSpec(mesh, ()))
