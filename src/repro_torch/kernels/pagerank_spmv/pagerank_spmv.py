"""Frontier-block-gated SpMV: the packed structure and the kernel's wrapper
(twin of ``repro.kernels.pagerank_spmv.pagerank_spmv``).

The paper skips vertices that are not affected; the blocked form skips
whole dst *windows*:

  * edges are dst-sorted and packed into entries of BE edges, each entry
    belonging to one dst window of VB consecutive vertices
    (``pack_blocks``, host NumPy, at bootstrap and on repack);
  * a window is *active* iff any of its VB vertices is affected;
  * the kernel reads only active entries and writes zeros for inactive
    windows (``csrc/frontier_spmv.cu``, CUDA C++ for sm_90a): windows cut
    into chunks of at most ``CHUNK_ENTRIES`` entries by the chunk plan of
    ``kernels/segment_ops/plan.py`` (built once per packed structure), a
    second pass that adds a split window's partial rows in chunk order,
    and no atomics, so its result is the same bit for bit from run to run.

``frontier_spmv_padded`` dispatches on where its tensors lie: on the CPU
it runs the plain version (``ref.py``); on a CUDA device it launches the
kernel, and a failed build or launch raises; on a ``meta`` device it runs
the launch path with no launch (``kernels.work``).  ``LAUNCH_COUNTS`` counts
calls that launched the kernel, one per call whatever its device
launches, so a run can show that it went through the kernel.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.device import DeviceLike, note_host_syncs, \
    resolve_device
from repro_torch.kernels import work
from repro_torch.kernels.build import check_arg
from repro_torch.kernels.pagerank_spmv.ref import frontier_spmv_ref_padded
from repro_torch.kernels.segment_ops.plan import cached_plan, plan_sizes

DEFAULT_BE = 2048     # edges per entry (paper's OpenMP chunk size)
DEFAULT_VB = 256      # vertices per dst window

LANE_SENTINEL = np.iinfo(np.int64).max   # key of a never-live lane

# calls that launched the kernel, by kernel name
LAUNCH_COUNTS: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class PackedGraph:
    """Blocked edge structure: host-packed bootstrap, device-maintained.

    Entries stay sorted by window and ``window``/``entry_start`` never
    change after packing; incremental updates (``update``) only flip
    lanes.  ``sorted_key``/``sorted_lane`` index the pack-time lanes by
    (src·V + dst) key, and ``ovl_key``/``ovl_lane`` are the append-only
    overlay of lanes claimed since the pack (the edge locator; see
    ``repro.kernels.pagerank_spmv.pagerank_spmv.PackedGraph``).
    """

    src: torch.Tensor        # int32[NE, BE]
    dst_rel: torch.Tensor    # int32[NE, BE]   dst - window*VB
    # f32[NE, BE]: 1.0 live / 0.0 pad, no other value (the gated_spmm
    # kernel skips a 0 lane and adds a live lane's row unscaled)
    valid: torch.Tensor
    window: torch.Tensor     # int32[NE]       window id per entry
    entry_start: torch.Tensor  # int32[NW+1]   window w owns entries
    #                          [entry_start[w], entry_start[w+1])
    sorted_key: torch.Tensor   # int64[NE*BE]  pack-time lane keys, ascending
    sorted_lane: torch.Tensor  # int32[NE*BE]  flat lane id per sorted key
    ovl_key: torch.Tensor      # int64[K]      keys inserted since the pack
    ovl_lane: torch.Tensor     # int32[K]      lane each insertion claimed
    num_vertices: int
    vb: int
    be: int
    # max entries any one window owns (pinned by stream owners)
    max_entries_per_window: int = 1

    @property
    def num_entries(self) -> int:
        return self.src.shape[0]

    @property
    def num_windows(self) -> int:
        return -(-self.num_vertices // self.vb)

    @property
    def overlay_capacity(self) -> int:
        return self.ovl_key.shape[0]

    @property
    def device(self) -> torch.device:
        return self.src.device

    def active_windows(self, affected: torch.Tensor) -> torch.Tensor:
        """bool[NW]: the windows that hold any ``affected`` vertex
        (``affected``: bool[num_vertices] or bool[NW*VB])."""
        nw, vb = self.num_windows, self.vb
        if affected.shape[0] < nw * vb:
            affected = torch.cat([affected, affected.new_zeros(
                nw * vb - affected.shape[0])])
        return affected.reshape(nw, vb).any(dim=1)

    def to(self, device) -> "PackedGraph":
        """The same structure with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def pack_blocks(src: np.ndarray, dst: np.ndarray, valid: np.ndarray,
                num_vertices: int, be: int = DEFAULT_BE,
                vb: int = DEFAULT_VB, num_entries: int | None = None,
                spill_lanes_per_window: int = 0,
                extra_entries: int = 0,
                overlay_capacity: int = 1024,
                max_entries_per_window: int | None = None,
                device: DeviceLike = None) -> PackedGraph:
    """Group live edges by dst window, split each group into BE-edge entries.

    Host NumPy, bitwise the reference's packing (including its
    default-kind argsort over sentinel-tied lane keys); only the final
    arrays move to ``device``.  ``num_entries`` pins the entry capacity
    (the tail is owned by the last window); ``spill_lanes_per_window``
    guarantees that many free lanes per window; ``extra_entries`` appends
    empty tail entries; ``overlay_capacity`` sizes the insertion overlay;
    ``max_entries_per_window`` pins the per-window entry bound (checked).
    """
    device = resolve_device(device)
    src = np.asarray(src, np.int32)[np.asarray(valid, bool)]
    dst = np.asarray(dst, np.int32)[np.asarray(valid, bool)]
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    win = dst // vb
    nw = -(-num_vertices // vb)

    counts = np.bincount(win, minlength=nw).astype(np.int64)
    n_base = -(-counts // be)                        # ceil, 0 for empty
    slack = n_base * be - counts
    need = np.maximum(0, spill_lanes_per_window - slack)
    n_w = n_base + -(-need // be)                    # entries per window
    offsets = np.concatenate([[0], np.cumsum(n_w)])
    ne = int(offsets[-1])
    cap = (num_entries if num_entries is not None
           else max(ne + max(0, extra_entries), 1))
    if ne > cap:
        raise ValueError(
            f"{ne} entries exceed capacity {cap}; raise num_entries or "
            "shrink spill_lanes_per_window")

    s = np.zeros((cap, be), np.int32)
    d = np.zeros((cap, be), np.int32)
    v = np.zeros((cap, be), np.float32)
    # rank of each (dst-sorted) edge within its window -> (entry, lane)
    edge_start = np.concatenate([[0], np.cumsum(counts)])[:-1]
    rank = np.arange(len(dst), dtype=np.int64) - edge_start[win]
    entry_idx = offsets[win] + rank // be
    lane_idx = rank % be
    s[entry_idx, lane_idx] = src
    d[entry_idx, lane_idx] = dst - win * vb
    v[entry_idx, lane_idx] = 1.0

    # entry -> window map; capacity tail belongs to the last window
    window = np.full(cap, nw - 1, np.int32)
    window[:ne] = np.repeat(np.arange(nw, dtype=np.int32), n_w)
    entry_start = offsets.astype(np.int32).copy()
    entry_start[nw] = cap
    owned = np.diff(entry_start.astype(np.int64))

    # edge locator: pack-time lanes sorted by key + an empty overlay
    lane_key = np.full(cap * be, LANE_SENTINEL, np.int64)
    flat = entry_idx * be + lane_idx
    lane_key[flat] = src.astype(np.int64) * num_vertices + dst
    order = np.argsort(lane_key)
    widest = max(1, int(owned.max()))
    if max_entries_per_window is None:
        max_entries_per_window = widest
    elif widest > max_entries_per_window:
        raise ValueError(
            f"{widest} entries in one window exceed the pinned "
            f"max_entries_per_window {max_entries_per_window}")
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    note_host_syncs(7)                     # seven uploads from pageable memory
    return PackedGraph(
        src=as_t(s), dst_rel=as_t(d), valid=as_t(v), window=as_t(window),
        entry_start=as_t(entry_start),
        sorted_key=as_t(lane_key[order]),
        sorted_lane=as_t(order.astype(np.int32)),
        ovl_key=torch.full((overlay_capacity,), LANE_SENTINEL,
                           dtype=torch.int64, device=device),
        ovl_lane=torch.zeros(overlay_capacity, dtype=torch.int32,
                             device=device),
        num_vertices=num_vertices, vb=vb, be=be,
        max_entries_per_window=max_entries_per_window)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

# entries a block walks at most: 8,192 lanes at BE = 512, so the R-MAT hub
# window of the smoke (1,518 entries) is 95 chunks
CHUNK_ENTRIES = 16

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 12
             + [ctypes.c_int] + [ctypes.c_void_p] * 3
             + [ctypes.c_int] * 5 + [ctypes.c_void_p])
# VB f32 rows a warp, 8 warps a block, in the default 48 KB of shared memory
_MAX_VB = 1024
_check = functools.partial(check_arg, "frontier_spmv")


@functools.lru_cache(maxsize=None)
def _lib():
    from repro_torch.kernels.build import load
    lib = load("frontier_spmv")
    lib.frontier_spmv_launch.argtypes = _ARGTYPES
    lib.frontier_spmv_launch.restype = ctypes.c_int
    lib.frontier_spmv_info.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p]
    lib.frontier_spmv_info.restype = ctypes.c_int
    return lib


def _scratch_floats(parts: int, vb: int) -> int:
    """f32 words of a call's scratch: ``parts`` partial rows of VB floats,
    then a byte a partial (did its chunk meet a live lane)."""
    return parts * vb + -(-parts // 4)


def kernel_info(packed: PackedGraph, chunk_entries: int = CHUNK_ENTRIES,
                device=None) -> dict:
    """What the kernel takes on the card at this packed shape (f32 rsc):
    K, the plan's chunk, partial and split-window slots, the grid of each
    pass, shared memory a block, resident blocks a SM and registers."""
    index = None if device is None else torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    info = (ctypes.c_int * 8)()
    rc = _lib().frontier_spmv_info(index, packed.vb, ctypes.addressof(info))
    if rc != 0:
        raise RuntimeError(f"frontier_spmv_info failed: CUDA error {rc}")
    chunks, parts, splits = plan_sizes(packed.num_windows,
                                       packed.num_entries, chunk_entries)
    return dict(chunk_entries=chunk_entries, chunk_slots=chunks,
                partial_slots=parts, split_slots=splits,
                grid=min(chunks, info[2] * info[4]),
                reduce_grid=min(splits, info[7] * info[4]),
                smem_per_block=info[0], static_smem_per_block=info[1],
                blocks_per_sm=info[2], registers=info[3], sms=info[4],
                reduce_registers=info[5], max_vb=info[6],
                scratch_bytes=4 * _scratch_floats(parts, packed.vb))


def _launch_kernel(packed: PackedGraph, rsc: torch.Tensor,
                   active_window: torch.Tensor,
                   chunk_entries: int) -> torch.Tensor:
    ne, be = packed.src.shape
    vb, nw = packed.vb, packed.num_windows
    dev = rsc.device
    if rsc.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"frontier_spmv: rsc must be float32 or bfloat16, "
                        f"got {rsc.dtype}")
    if rsc.dim() != 1 or rsc.shape[0] < nw * vb or not rsc.is_contiguous():
        raise ValueError("frontier_spmv: rsc must be a contiguous vector of "
                         f"length >= {nw * vb}, got {tuple(rsc.shape)}")
    if not 0 < vb <= _MAX_VB:
        raise ValueError(f"frontier_spmv: vb {vb} outside (0, {_MAX_VB}]: "
                         "the kernel keeps 8 rows of VB floats a block in "
                         "shared memory")
    if chunk_entries < 1:
        raise ValueError(f"frontier_spmv: chunk_entries must be >= 1, got "
                         f"{chunk_entries}")
    _check("src", packed.src, torch.int32, (ne, be), dev)
    _check("dst_rel", packed.dst_rel, torch.int32, (ne, be), dev)
    _check("valid", packed.valid, torch.float32, (ne, be), dev)
    _check("entry_start", packed.entry_start, torch.int32, (nw + 1,), dev)
    _check("active_window", active_window, torch.bool, (nw,), dev)
    plan = cached_plan(packed.entry_start, ne, chunk_entries)
    n_chunks, n_splits = plan.window.shape[0], plan.split_window.shape[0]
    # one allocation, the output then the scratch; the caller gets the
    # output's view
    parts = plan.num_partials
    buf = torch.empty(nw * vb + _scratch_floats(parts, vb),
                      dtype=torch.float32, device=dev)
    out = buf[:nw * vb]
    if dev.type == "meta":                 # the dry-run: no launch
        n_live = ne * be
        work.record("frontier_spmv", *work.frontier_spmv_work(
            ne, be, nw, vb, ne, n_live, min(rsc.shape[0], n_live),
            rsc.element_size()))
        return out
    partial = out.data_ptr() + 4 * nw * vb
    # the C entry point selects the device itself; the stream is the raw
    # handle of torch.cuda.current_stream(dev), read without building a
    # Stream object (a few microseconds a call)
    rc = _lib().frontier_spmv_launch(
        dev.index, packed.src.data_ptr(), packed.dst_rel.data_ptr(),
        packed.valid.data_ptr(), *(t.data_ptr() for t in plan[:7]),
        active_window.data_ptr(), rsc.data_ptr(),
        int(rsc.dtype == torch.bfloat16), out.data_ptr(), partial,
        partial + 4 * parts * vb, n_chunks, n_splits, nw, be, vb,
        torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"frontier_spmv kernel launch failed: CUDA "
                           f"error {rc}")
    if n_chunks > 0:
        LAUNCH_COUNTS["frontier_spmv"] += 1
    return out


def frontier_spmv_padded(packed: PackedGraph, rsc: torch.Tensor,
                         active_window: torch.Tensor, *,
                         chunk_entries: int = CHUNK_ENTRIES,
                         use_kernel="auto") -> torch.Tensor:
    """Gated blocked SpMV on pre-padded buffers.  Returns f32[NW*VB]
    contributions; inactive windows are exactly 0.

    rsc: f32/bf16[>= NW*VB] scaled ranks R/d (a shorter vector is
    zero-padded; a longer one, such as a shard's view of every vertex's
    ranks, is read where ``src`` points); active_window: bool[NW].
    ``use_kernel="auto"``: a CPU ``rsc`` runs the plain version, a CUDA
    ``rsc`` launches the kernel, whose blocks walk at most
    ``chunk_entries`` entries each (the plain version does not split).
    ``use_kernel=True`` launches the kernel and raises on a CPU tensor;
    ``False`` (the reference's option) runs the plain version and raises
    on a CUDA tensor: on the card every call launches the kernel.
    """
    v_pad = packed.num_windows * packed.vb
    if rsc.shape[0] < v_pad:
        rsc = torch.cat([rsc, rsc.new_zeros(v_pad - rsc.shape[0])])
    if use_kernel is True and rsc.device.type != "cuda":
        raise ValueError(f"frontier_spmv: use_kernel=True needs CUDA "
                         f"tensors, got {rsc.device}; pass "
                         "use_kernel='auto' or False to run the plain "
                         "version there")
    if use_kernel is False and rsc.device.type == "cuda":
        raise ValueError("frontier_spmv: use_kernel=False runs the plain "
                         "version, which is for CPU tensors only; a CUDA "
                         "tensor launches the kernel (use_kernel='auto' "
                         "or True)")
    if rsc.device.type == "cpu" and use_kernel is not True:
        return frontier_spmv_ref_padded(packed.src, packed.dst_rel,
                                        packed.valid, packed.window, rsc,
                                        active_window, packed.vb)
    if rsc.device.type not in ("cuda", "meta"):
        raise ValueError(f"frontier_spmv: no kernel for device {rsc.device}")
    return _launch_kernel(packed, rsc, active_window, chunk_entries)


def frontier_spmv(packed: PackedGraph, rsc: torch.Tensor,
                  active_window: torch.Tensor) -> torch.Tensor:
    """Gated blocked SpMV.  Returns f32[num_vertices] contributions."""
    return frontier_spmv_padded(packed, rsc,
                                active_window)[: packed.num_vertices]
