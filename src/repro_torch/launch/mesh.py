"""Device meshes for the multi-device engines (twin of
``repro.launch.mesh``).

One controller drives every shard, as ``shard_map`` does: a ``Mesh`` is a
grid of ``torch.device``s with axis names (``("data", "model")``, or
``("pod", "data", "model")``), and each shard's tensors live on the
mesh's device for that shard.  No process group is started.  A device may
appear at several positions, which is how one card (or the CPU) holds a
test mesh of four shards, and how the dry-run lays the production
shapes over ``meta`` positions (``make_meta_mesh``).  Making a mesh
touches no device.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

__all__ = ["Mesh", "NamedSharding", "ShardedTensor", "make_test_mesh",
           "make_production_mesh", "make_meta_mesh", "resolve_mesh",
           "data_axes"]


class Mesh:
    """A grid of torch devices with named axes."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.empty(np.shape(np.asarray(devices, dtype=object)),
                        dtype=object)
        for idx, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            grid[idx] = torch.device(d)
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names):
            raise ValueError(f"a mesh of shape {grid.shape} needs "
                             f"{grid.ndim} axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis names {axis_names}")
        self.devices = grid
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        """{axis name: size}, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str = "model") -> list:
        """The devices along ``axis`` at index 0 of every other axis: shard
        ``i`` of a structure sharded over ``axis`` lives on entry ``i``."""
        k = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[k]):
            idx[k] = i
            out.append(self.devices[tuple(idx)])
        return out

    def _key(self):
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        kinds = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, devices={kinds})"


class ShardedTensor(NamedTuple):
    """A tensor split along its first dim over a mesh axis: piece ``i`` on
    the axis's device ``i`` (``NamedSharding.place``)."""

    pieces: tuple
    sharding: "NamedSharding"

    def full(self, device: DeviceLike = None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the first piece's)."""
        dev = self.pieces[0].device if device is None else \
            torch.device(device)
        return torch.cat([p.to(dev) for p in self.pieces])


class NamedSharding:
    """Where a tensor lives on a mesh (twin of jax's ``NamedSharding``,
    for restored checkpoints and rescaled state): ``spec`` names, per
    dim, the mesh axis it is split over (or None).  Only the first dim
    may be split; an empty spec, or one naming no axis, replicates: the
    tensor goes whole to the mesh's first device."""

    def __init__(self, mesh: Mesh, spec: Sequence = ()):
        spec = tuple(spec)
        for i, a in enumerate(spec):
            if a is not None and (i > 0 or a not in mesh.axis_names):
                raise ValueError(f"spec {spec}: only the first dim may be "
                                 f"split, over one of {mesh.axis_names}")
        self.mesh, self.spec = mesh, spec

    @property
    def axis(self):
        return self.spec[0] if self.spec else None

    def devices(self) -> list:
        if self.axis is None:
            return [self.mesh.devices.flat[0]]
        return self.mesh.axis_devices(self.axis)

    def place(self, t: torch.Tensor):
        """``t`` (a host tensor) on the mesh: whole on the first device,
        or a ``ShardedTensor`` of near-equal pieces along dim 0.  Each
        piece's move is recorded as one upload from pageable memory (on
        the CPU too, as every call site of the port records itself)."""
        from repro_torch.device import note_host_syncs
        devs = self.devices()
        if self.axis is None:
            note_host_syncs()
            return t.to(devs[0])
        pieces = torch.tensor_split(t, len(devs), dim=0)
        note_host_syncs(len(devs))
        return ShardedTensor(tuple(p.to(d) for p, d in zip(pieces, devs)),
                             self)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, spec={self.spec})"


def _positions(n: int, device: DeviceLike) -> list:
    """``n`` mesh positions on ``device``'s kind: cycled over the visible
    cards for CUDA (so one card repeats), the device itself otherwise."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        cards = max(1, torch.cuda.device_count())
        return [torch.device("cuda", i % cards) for i in range(n)]
    return [dev] * n


def make_test_mesh(devices: Union[int, Sequence] = 8, *,
                   device: DeviceLike = None, model: int = None) -> Mesh:
    """A small (data, model) mesh for tests and smoke runs.

    ``devices`` is a count of positions (on ``device``'s kind, cycled over
    the visible cards; default the card) or a list of devices.  The shape
    follows the reference: ``model = 2`` on an even count of at least 2,
    else 1, and ``data`` the rest; ``model=`` overrides it (it must divide
    the count).
    """
    if isinstance(devices, int):
        devs = _positions(devices, device)
    else:
        devs = [torch.device(d) for d in devices]
    n = len(devs)
    if n < 1:
        raise ValueError("a mesh needs at least one device")
    if model is None:
        model = 2 if n >= 2 and n % 2 == 0 else 1
    if n % model:
        raise ValueError(f"model={model} does not divide {n} devices")
    grid = np.empty((n // model, model), dtype=object)
    for i, d in enumerate(devs):
        grid[i // model, i % model] = d
    return Mesh(grid, ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> Mesh:
    """The reference's production shape: (16, 16) over (data, model), or
    (2, 16, 16) over (pod, data, model) with ``multi_pod``.  It needs that
    many distinct cards visible and raises otherwise: it never shrinks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = int(np.prod(shape))
    dev = resolve_device(device)
    have = torch.cuda.device_count() if dev.type == "cuda" else 1
    if have < need:
        raise RuntimeError(
            f"the production mesh {shape} needs {need} {dev.type} devices, "
            f"{have} visible; use make_test_mesh (--mesh test) here")
    grid = np.empty(shape, dtype=object)
    for i, idx in enumerate(np.ndindex(*shape)):
        grid[idx] = torch.device(dev.type, i)
    return Mesh(grid, axes)


def make_meta_mesh(shape: Sequence[int] = (16, 16),
                   axes: Sequence[str] = None) -> Mesh:
    """A mesh of ``meta`` positions: the dry-run's (``launch/dryrun.py``),
    of any shape, the reference's production (16, 16) by default; axes
    ``("data", "model")`` for two dims, ``("pod", "data", "model")`` for
    three.  Nothing on it allocates."""
    shape = tuple(int(s) for s in shape)
    if axes is None:
        axes = {2: ("data", "model"),
                3: ("pod", "data", "model")}.get(len(shape))
        if axes is None:
            raise ValueError(f"name the axes of a {len(shape)}-d mesh")
    grid = np.empty(shape, dtype=object)
    for idx in np.ndindex(*shape):
        grid[idx] = torch.device("meta")
    return Mesh(grid, axes)


# positions of the drivers' --mesh test (a 2 x 2 mesh): one card, or the
# CPU, repeats its device
TEST_MESH_POSITIONS = 4


def resolve_mesh(name: str, device: DeviceLike = None):
    """The drivers' ``--mesh none|test|production``: None (one device),
    ``make_test_mesh`` over at least ``TEST_MESH_POSITIONS`` positions
    (the visible cards, cycled), or ``make_production_mesh`` (raises
    unless its 256 cards are visible)."""
    if name == "none":
        return None
    dev = resolve_device(device)
    if name == "test":
        cards = torch.cuda.device_count() if dev.type == "cuda" else 1
        return make_test_mesh(max(TEST_MESH_POSITIONS, cards), device=dev)
    if name == "production":
        return make_production_mesh(device=dev)
    raise ValueError(f"unknown mesh {name!r}: none, test or production")


def data_axes(mesh) -> tuple:
    """The batch/edge-parallel axes of a mesh: every axis but ``model``
    (``pod`` included when present)."""
    return tuple(a for a in mesh.axis_names if a != "model")
