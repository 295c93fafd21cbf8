"""Checkpoints of pytrees of tensors (twin of ``repro.ft.checkpoint``), in
the reference's on-disk format, so that a checkpoint written by either
package restores in the other:

  * one ``.npy`` per leaf under ``<dir>/step_<N>.tmp/``, atomically renamed
    to ``step_<N>/`` after an fsync'd ``manifest.json`` that lists each
    leaf's key, file, shape, dtype and crc32 of its raw bytes: a torn
    write never looks like a checkpoint;
  * leaves in the reference's order and under its key strings
    (``jax.tree_util.keystr``): dict keys sorted, ``"['ranks']"``,
    ``"['b'][0]"``; a NamedTuple's fields by name, ``"[0].embed"``; a
    ``None`` subtree holds no leaf;
  * a bf16 leaf as the reference writes one: a ``.npy`` of 2-byte words
    (``descr '<V2'``), manifest dtype ``"bfloat16"``, crc32 of the raw
    bytes; read back by viewing the words as ``torch.bfloat16`` (no
    ``ml_dtypes`` needed);
  * ``restore`` verifies every digest and raises a structured
    ``CheckpointCorruptError`` for a torn or bit-flipped leaf or an
    unreadable manifest; ``restore_latest_valid`` falls back past corrupt
    steps to the newest restorable one.

``restore`` takes a ``device=`` (the port's entry-point default: the
card) in place of the reference's ``shardings=``.  Reading a card tensor
to save it, and uploading a leaf to restore it, each synchronize the host
with the card: both are recorded with ``device.note_host_syncs``.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, note_host_syncs, resolve_device

_MANIFEST = "manifest.json"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint leaf failed its integrity check on restore.

    ``step`` is the checkpoint step, ``leaf`` the manifest key of the
    offending leaf (None when the manifest itself is unreadable).
    """

    def __init__(self, message: str, *, step: Optional[int] = None,
                 leaf: Optional[str] = None):
        super().__init__(message)
        self.step = step
        self.leaf = leaf


def _flatten(tree, path: str = "") -> List[Tuple[str, Any]]:
    """(key string, leaf) pairs in the reference's leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f, x in zip(tree._fields, tree)
                for kv in _flatten(x, f"{path}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in _flatten(x, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(tree, leaves) -> Any:
    """``tree``'s structure with its leaves taken from the iterator
    ``leaves`` in ``_flatten``'s order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(x, leaves) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(x, leaves) for x in tree)
    return next(leaves)


def flatten_up_to(target, tree) -> list:
    """``tree``'s subtrees at the leaves of ``target``, in ``_flatten``'s
    order (the reference's ``treedef.flatten_up_to``: a None in ``tree``,
    or a factored moment's (row, col) pair, stands for one leaf)."""
    if target is None:
        return []
    if isinstance(target, dict):
        return [x for k in sorted(target)
                for x in flatten_up_to(target[k], tree[k])]
    if isinstance(target, (list, tuple)):
        return [x for a, b in zip(target, tree) for x in flatten_up_to(a, b)]
    return [tree]


def _bf16_words(arr: np.ndarray) -> bool:
    """A bf16 array on the host: ``ml_dtypes``' bfloat16, or the 2-byte
    void words ``np.load`` gives for a bf16 ``.npy``."""
    return arr.dtype.itemsize == 2 and (arr.dtype.kind == "V"
                                        or arr.dtype.name == "bfloat16")


def host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor as host NumPy; bf16 as its 2-byte words (dtype ``V2``)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def tensor_from_host(a) -> torch.Tensor:
    """A host array as a CPU tensor (a copy); bf16 words (``V2``, or
    ``ml_dtypes``' bfloat16) as ``torch.bfloat16``."""
    a = np.asarray(a)
    if _bf16_words(a):
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16).copy()).view(
                torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        note_host_syncs()                  # a read of a device value
        return host_array(leaf)
    return np.asarray(leaf)


def _write_leaf(path: str, arr: np.ndarray) -> str:
    """``arr`` as a ``.npy`` at ``path``; returns the manifest dtype.  bf16
    words get the header the reference's ``np.save`` of a bfloat16 array
    writes (``descr '<V2'``)."""
    if not _bf16_words(arr):
        np.save(path, arr)
        return str(arr.dtype)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": tuple(arr.shape)})
        f.write(np.ascontiguousarray(arr).tobytes())
    return "bfloat16"


def save(directory: str, step: int, state: Any, keep_last: int = 3) -> str:
    """Write a checkpoint; returns the final path.  Atomic."""
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for i, (name, leaf) in enumerate(_flatten(state)):
        arr = _host(leaf)
        fname = f"leaf_{i:05d}.npy"
        dtype = _write_leaf(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            dict(key=name, file=fname, shape=list(arr.shape), dtype=dtype,
                 crc32=zlib.crc32(np.ascontiguousarray(arr).tobytes())))
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep_last)
    return final


def _gc(directory: str, keep_last: int):
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(directory, d))


def _steps(directory: str) -> List[int]:
    """The committed steps of ``directory`` (those with a manifest)."""
    if not os.path.isdir(directory):
        return []
    return [int(d.split("_")[1]) for d in os.listdir(directory)
            if d.startswith("step_") and not d.endswith(".tmp")
            and os.path.exists(os.path.join(directory, d, _MANIFEST))]


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return max(steps) if steps else None


def restore(directory: str, step: int, target: Any,
            device: DeviceLike = None, shardings: Any = None) -> Any:
    """Load into the structure of ``target``, whose tensors (``meta``
    tensors will do) give each restored tensor's shape and dtype.

    Shapes must match; values are cast to the target's dtype.  Every leaf
    with a ``crc32`` digest (all checkpoints written by either package) is
    verified before anything is uploaded; a mismatch, an unreadable
    ``.npy`` or an unreadable manifest raises ``CheckpointCorruptError``.
    The tensors land on ``device`` (default: the CUDA card), or, with
    ``shardings`` (a tree matching ``target`` of
    ``launch.mesh.NamedSharding``, None for a leaf that goes to
    ``device``), where each leaf's sharding places it: whole on the mesh's
    first device, or a ``ShardedTensor`` split over a mesh axis
    (reshard-on-restore; ``ft/elastic.py``).
    """
    from repro_torch.launch.mesh import NamedSharding
    shard_leaves = None
    if shardings is not None:
        shard_leaves = flatten_up_to(target, shardings)
        bad = [sh for sh in shard_leaves
               if sh is not None and not isinstance(sh, NamedSharding)]
        if bad:
            raise TypeError(f"shardings leaves must be "
                            f"launch.mesh.NamedSharding or None, got "
                            f"{type(bad[0]).__name__}")
        if all(sh is not None for sh in shard_leaves) and device is None:
            device = "cpu"                 # every leaf goes where it says
    device = resolve_device(device)
    path = os.path.join(directory, f"step_{step:010d}")
    try:
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(
            f"step {step}: unreadable manifest ({e})", step=step) from e
    leaves = [leaf for _, leaf in _flatten(target)]
    if len(leaves) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, target has "
            f"{len(leaves)}")
    arrays = []
    for leaf, rec in zip(leaves, manifest["leaves"]):
        try:
            arr = np.load(os.path.join(path, rec["file"]))
        except (OSError, ValueError) as e:
            raise CheckpointCorruptError(
                f"step {step} leaf {rec['key']}: unreadable "
                f"({rec['file']}: {e})", step=step, leaf=rec["key"]) from e
        if "crc32" in rec:
            got = zlib.crc32(np.ascontiguousarray(arr).tobytes())
            if got != rec["crc32"]:
                raise CheckpointCorruptError(
                    f"step {step} leaf {rec['key']}: content digest "
                    f"{got:#010x} != manifest {rec['crc32']:#010x} "
                    f"(torn or corrupt {rec['file']})",
                    step=step, leaf=rec["key"])
        want_shape = tuple(leaf.shape)
        if tuple(arr.shape) != want_shape:
            raise ValueError(
                f"leaf {rec['key']}: checkpoint shape {arr.shape} != "
                f"target {want_shape}")
        arrays.append(arr)
    if shard_leaves is not None and len(shard_leaves) != len(leaves):
        raise ValueError(f"shardings has {len(shard_leaves)} leaves, "
                         f"target has {len(leaves)}")
    out = []
    for i, (leaf, arr) in enumerate(zip(leaves, arrays)):
        sh = shard_leaves[i] if shard_leaves is not None else None
        if sh is not None:
            out.append(sh.place(tensor_from_host(arr).to(leaf.dtype)))
            continue
        note_host_syncs()                  # an upload from pageable memory
        out.append(tensor_from_host(arr).to(device=device, dtype=leaf.dtype))
    return _unflatten(target, iter(out))


def restore_latest_valid(directory: str, target: Any,
                         device: DeviceLike = None,
                         shardings: Any = None) -> tuple:
    """(step, state) of the newest restorable checkpoint, or (None, None).

    Walks the retained steps newest-first; a ``CheckpointCorruptError``
    falls back to the previous step instead of propagating, so one torn
    or corrupt checkpoint costs one save interval.  Raises only when every
    retained step is corrupt: a silent cold start would hide it.
    """
    last_err: Optional[CheckpointCorruptError] = None
    for step in sorted(_steps(directory), reverse=True):
        try:
            return step, restore(directory, step, target, device, shardings)
        except CheckpointCorruptError as e:
            last_err = e
    if last_err is not None:
        raise last_err
    return None, None


class CheckpointManager:
    """Periodic checkpointing + restart bookkeeping for drivers."""

    def __init__(self, directory: str, every: int = 10, keep_last: int = 3):
        self.directory = directory
        self.every = every
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)

    def maybe_save(self, step: int, state: Any) -> Optional[str]:
        if step % self.every == 0:
            return save(self.directory, step, state, self.keep_last)
        return None

    def restore_latest(self, target: Any, device: DeviceLike = None,
                       shardings: Any = None):
        """Newest restorable (step, state); corrupt steps fall back to
        the previous retained one (``restore_latest_valid``)."""
        return restore_latest_valid(self.directory, target, device,
                                    shardings)
