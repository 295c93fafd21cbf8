"""Tuned pack geometry: per-graph (BE, VB, spill) instead of fixed pack
constants (twin of ``repro.kernels.pagerank_spmv.tune``).

Two stages, as in the reference:

  1. **model ranking** — for each candidate on the (BE, VB) grid, the
     exact per-window entry counts of the pack (``window_entries``: the
     graph's dst histogram through ``pack_blocks``' sizing arithmetic) and
     a cost model of the Hopper kernel (``gated_spmv_cost``) at the
     expected frontier fraction;
  2. **measured search (optional)** — time the model's top
     ``measure_top`` candidates on one gated contribution (a pack, then
     the SpMV on a clustered frontier of the expected fraction) and keep
     the fastest.

The model is the port's own.  The reference ranks by the TPU kernel's
roofline (a static grid that runs every entry's ``[1,BE]@[BE,VB]`` MXU
step), a cost the Hopper kernel (``csrc/frontier_spmv.cu``) does not
have.  It prices one call on the clustered frontier the measured search
times (the first ``f·|V|`` vertices active, so on a skewed graph the
hub windows), from the pack's exact per-window entries:

  * the device's floor for a call with active windows (``DEVICE_CALL_S``:
    two launches, the walk over every plan slot, the rows of every
    window written);
  * the rsc gathers, one 32-byte L2 sector a live lane of an active
    window (``GATHER_S``);
  * the waves of chunks: windows are cut into chunks of at most
    ``CHUNK_ENTRIES`` entries, a block walks a chunk (8 warps, 256-lane
    tiles a warp) and one resident wave of ``resident_blocks(VB)`` blocks
    a SM takes ``ceil(active chunks / grid)`` rounds, each as long as the
    longest active chunk's tiles (``TILE_S`` a tile);
  * the second pass over split windows: each chunk past a window's first
    writes a partial row of VB floats that is read back
    (``PARTIAL_S`` a float);
  * a host floor (``HOST_CALL_S``): launches are asynchronous, so back to
    back a call costs the larger of its host and device times, and with
    no active window the host's.

The device's terms add up.  The constants are ``tools/tune_sweep.py``'s
fit (``fit``): the device's a non-negative least-squares fit to the
kernel's times at 48 (geometry, fraction) cases of the grid at 1 %, 5 %,
20 % and 100 % active on an R-MAT graph of 2^21 vertices and 32.4 M
edges, the host's the median host time a call, on an NVIDIA H100 80GB
HBM3 at a 700 W limit (PERF.md §6).  Streamed bytes of
``valid``/``src``/``dst_rel`` and per-chunk costs fitted to zero in an
earlier fit with those terms: the gathers and the waves hide them.  On
another card the ranking is the same model's, not a measurement.

Winners are cached keyed by ``(device kind, graph-shape signature,
frontier decade)`` in a JSON file (``~/.cache/repro_torch/kernel_tune.json``
or ``$REPRO_TORCH_TUNE_CACHE``).  The file is the port's own: the two
packages rank geometries by different models, so neither reads the
other's winners.  ``ServeEngine`` bootstrap, ``pack_graph`` (through
``KernelGeometry.pack_kw``) and the sharded engine's ``pack_shards``
consume the result; ``launch/serve.py`` logs what was picked.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["KernelGeometry", "TuneCache", "TuneInfo", "candidate_costs",
           "default_cache_path", "device_kind", "gated_spmv_cost",
           "graph_signature", "resident_blocks", "spill_for_stream",
           "tune_geometry", "window_counts", "window_entries",
           "CANDIDATE_GRID"]

# (be, vb) candidates: the reference's grid (the kernel takes VB <= 1,024)
CANDIDATE_GRID: tuple = tuple(
    (be, vb) for be in (256, 512, 1024, 2048) for vb in (128, 256, 512))

# ---------------------------------------------------------------------------
# the Hopper model's constants (NVIDIA H100 80GB HBM3, 700 W)
# ---------------------------------------------------------------------------

SMS = 132
SMEM_PER_SM = 233_472         # 228 KB a SM
SMEM_RESERVED = 1_024         # the runtime's share of each block
REGISTERS_PER_SM = 65_536
THREADS_PER_SM = 2_048
# frontier_spmv.cu: 256 threads a block, 64 registers a thread (ptxas),
# 8 f32 rows of VB a block in dynamic shared memory, 5,120 B of staged
# plan slots
BLOCK_THREADS = 256
BLOCK_REGISTERS = 64
BLOCK_WARPS = 8
STAGED_PLAN_BYTES = 5_120
TILE_LANES = 256              # lanes a warp loads at once (8 steps of 32)
CHUNK_ENTRIES = 16            # the wrapper's K
# fitted (module doc): a call's host floor, the device's floor, a live
# lane's gather, a tile of the longest chunk a round, a partial-row float
HOST_CALL_S = 65.10e-6
DEVICE_CALL_S = 41.05e-6
GATHER_S = 8.764e-12
TILE_S = 0.5457e-6
PARTIAL_S = 7.182e-12


@dataclasses.dataclass(frozen=True)
class KernelGeometry:
    """One pack geometry: entry width, window width, spill reservation."""

    be: int
    vb: int
    spill_lanes_per_window: int

    def pack_kw(self) -> dict:
        """kwargs for pack_blocks / pack_graph / pack_shards."""
        return dict(be=self.be, vb=self.vb,
                    spill_lanes_per_window=self.spill_lanes_per_window)

    def describe(self) -> str:
        return (f"be={self.be} vb={self.vb} "
                f"spill={self.spill_lanes_per_window}")


@dataclasses.dataclass(frozen=True)
class TuneInfo:
    """How a geometry was picked (logged by launch/serve)."""

    source: str                      # "cache" | "model" | "measured"
    cache_hit: bool
    tune_time_s: float
    key: str
    # (geometry, predicted_s, measured_s|None) per candidate considered
    candidates: tuple = ()


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, int(math.ceil(math.log2(max(1, x)))))


def spill_for_stream(num_windows: int, expected_inserts: int,
                     be: int) -> int:
    """Spill lanes per window sized to absorb ``expected_inserts`` net
    insertions between repacks with 4x skew headroom, clamped to [16, BE]
    (a window never reserves more than one extra entry of slack)."""
    per_window = -(-4 * max(0, expected_inserts) // max(1, num_windows))
    return int(min(be, max(16, _pow2_ceil(per_window))))


def graph_signature(num_vertices: int, num_edges: int,
                    frontier_frac: float) -> str:
    """Bucketed shape key: graphs within ~2x in V/E and the same frontier
    decade share a tuned geometry."""
    lv = int(round(math.log2(max(2, num_vertices))))
    le = int(round(math.log2(max(2, num_edges))))
    lf = int(round(math.log10(max(1e-6, min(1.0, frontier_frac)))))
    return f"v2^{lv}-e2^{le}-f1e{lf}"


def device_kind(device=None) -> str:
    """The card's name with spaces as ``_`` (``cpu`` off the card): the
    first part of a cache key."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type != "cuda":
        return dev.type
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(dev).replace(" ", "_")


def default_cache_path() -> str:
    env = os.environ.get("REPRO_TORCH_TUNE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "kernel_tune.json")


class TuneCache:
    """Persistent {key: geometry} store (JSON, atomic rewrite).

    A missing, corrupt or wrong-schema file is an empty cache, never an
    error: tuning must not take serving down.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_cache_path()
        self._data: dict = {}
        try:
            with open(self.path) as f:
                raw = json.load(f)
            for k, v in raw.items():
                self._data[k] = KernelGeometry(
                    be=int(v["be"]), vb=int(v["vb"]),
                    spill_lanes_per_window=int(v["spill_lanes_per_window"]))
        except (OSError, ValueError, KeyError, TypeError, AttributeError):
            self._data = {}

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: str) -> Optional[KernelGeometry]:
        return self._data.get(key)

    def put(self, key: str, geom: KernelGeometry) -> None:
        self._data[key] = geom
        self.save()

    def save(self) -> None:
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({k: dataclasses.asdict(g)
                           for k, g in self._data.items()}, f, indent=2,
                          sort_keys=True)
            os.replace(tmp, self.path)
        except OSError:                                # pragma: no cover
            pass                                       # cache is best-effort


# ---------------------------------------------------------------------------
# model ranking
# ---------------------------------------------------------------------------

def window_entries(dst: np.ndarray, num_vertices: int, be: int, vb: int,
                   spill: int) -> np.ndarray:
    """int64[NW]: the entries ``pack_blocks`` gives each window of this
    graph's live ``dst`` at (be, vb, spill) — its exact sizing arithmetic,
    before any capacity tail."""
    return _entries(window_counts(dst, num_vertices, vb), be, spill)


def window_counts(dst: np.ndarray, num_vertices: int, vb: int) -> np.ndarray:
    """int64[NW]: the live edges whose dst falls in each window of VB."""
    nw = -(-num_vertices // vb)
    return np.bincount(np.asarray(dst) // vb, minlength=nw).astype(np.int64)


def _entries(counts: np.ndarray, be: int, spill: int) -> np.ndarray:
    n_base = -(-counts // be)
    slack = n_base * be - counts
    need = np.maximum(0, spill - slack)
    return n_base + -(-need // be)


def resident_blocks(vb: int) -> int:
    """Blocks of the chunk pass a SM holds at once at this VB: the least
    of its registers, threads and shared memory."""
    smem = BLOCK_WARPS * vb * 4 + STAGED_PLAN_BYTES + SMEM_RESERVED
    return max(1, min(REGISTERS_PER_SM // (BLOCK_THREADS * BLOCK_REGISTERS),
                      THREADS_PER_SM // BLOCK_THREADS,
                      SMEM_PER_SM // smem))


def gated_spmv_cost(counts: np.ndarray, n_w: np.ndarray,
                    num_vertices: int, be: int, vb: int,
                    frontier_frac: float) -> dict:
    """Seconds of one ``frontier_spmv`` call at (be, vb) on a graph whose
    windows hold ``counts`` live edges in ``n_w`` entries, with the first
    ``frontier_frac·V`` vertices active (module doc).  Returns the terms
    (seconds), the call's ``device_s`` and ``total_s``, and the shape."""
    nw = len(n_w)
    k = CHUNK_ENTRIES
    chunks_w = np.maximum(1, -(-n_w // k))
    active = -(-int(frontier_frac * num_vertices) // vb) if frontier_frac \
        > 0 else 0
    active = min(active, nw)
    slots = nw + int(np.sum(n_w)) // k
    grid = min(slots, resident_blocks(vb) * SMS)
    live = int(np.sum(counts[:active]))
    chunks = int(np.sum(chunks_w[:active]))
    partial_rows = int(np.sum(chunks_w[:active] - 1))
    longest = min(k, int(n_w[:active].max())) * be if active else 0
    tiles = -(-longest // (BLOCK_WARPS * TILE_LANES))
    rounds = -(-chunks // max(1, grid))
    gather_s = live * GATHER_S
    wave_s = rounds * tiles * TILE_S
    partial_s = partial_rows * vb * PARTIAL_S
    device_s = DEVICE_CALL_S + gather_s + wave_s + partial_s
    # live, tile_rounds and partial_floats are what the constants multiply
    # (tools/tune_sweep.py fits them)
    return dict(gather_s=gather_s, wave_s=wave_s, partial_s=partial_s,
                device_s=device_s, host_s=HOST_CALL_S,
                total_s=max(HOST_CALL_S, device_s), grid=grid,
                chunks=int(np.sum(chunks_w)), entries=int(np.sum(n_w)),
                active_windows=active, active_chunks=chunks, live=live,
                tile_rounds=rounds * tiles, partial_floats=partial_rows * vb)


def candidate_costs(dst: np.ndarray, num_vertices: int,
                    frontier_frac: float, expected_inserts: int,
                    grid: Sequence = CANDIDATE_GRID) -> list:
    """[(KernelGeometry, predicted_s)] ranked ascending by model cost
    (ties by the device's share, then by grid order)."""
    dst = np.asarray(dst)
    counts = {}                       # a window histogram a VB
    out = []
    for be, vb in grid:
        if vb > max(128, _pow2_ceil(num_vertices)):
            continue                  # window wider than the whole graph
        nw = -(-num_vertices // vb)
        spill = spill_for_stream(nw, expected_inserts, be)
        geom = KernelGeometry(be=be, vb=vb, spill_lanes_per_window=spill)
        if vb not in counts:
            counts[vb] = window_counts(dst, num_vertices, vb)
        c = gated_spmv_cost(counts[vb], _entries(counts[vb], be, spill),
                            num_vertices, be, vb, frontier_frac)
        out.append((geom, c["total_s"], c["device_s"]))
    out.sort(key=lambda t: (t[1], t[2]))
    return [(g, t) for g, t, _ in out]


# ---------------------------------------------------------------------------
# measured search
# ---------------------------------------------------------------------------

def _measure(graph, geom: KernelGeometry, frontier_frac: float,
             use_kernel: bool, repeats: int = 5) -> float:
    """Seconds of one gated contribution at ``geom`` on a clustered
    frontier of the expected fraction (the first ``f·V`` vertices; the
    pack is not timed: it is per repack, the SpMV per iteration).  On the
    card each call is timed with CUDA events and ends in a device read;
    the best of ``repeats`` is kept."""
    from repro_torch.kernels.pagerank_spmv.ops import gated_contrib
    from repro_torch.kernels.pagerank_spmv.update import pack_graph

    n = graph.num_vertices
    dev = graph.device
    packed = pack_graph(graph, **geom.pack_kw())
    aff = torch.zeros(n, dtype=torch.bool, device=dev)
    aff[: max(1, int(frontier_frac * n))] = True
    ranks = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
    inv = (1.0 / graph.out_degree(include_self_loop=True)
           .to(torch.float64)).to(torch.float32)
    awin = packed.active_windows(aff)

    def call():
        return gated_contrib(packed, ranks, inv, active_window=awin,
                             use_kernel=use_kernel)

    call()
    best = math.inf
    for _ in range(repeats):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = call()
            stop.record()
            float(out[0])                 # ends in a device read
            best = min(best, start.elapsed_time(stop) * 1e-3)
        else:
            t0 = time.perf_counter()
            float(call()[0])
            best = min(best, time.perf_counter() - t0)
    return best


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def tune_geometry(graph, *, frontier_frac: float = 0.05,
                  expected_inserts: int = 1024,
                  measure: bool = False, measure_top: int = 3,
                  use_kernel="auto",
                  cache: Optional[TuneCache] = None,
                  cache_path: Optional[str] = None,
                  grid: Sequence = CANDIDATE_GRID
                  ) -> tuple[KernelGeometry, TuneInfo]:
    """Pick (BE, VB, spill) for ``graph``.

    Order of attack: the persistent cache (keyed by device kind +
    bucketed graph shape + frontier decade), then the model's ranking of
    the grid, then, with ``measure=True``, a timed search over the
    model's top ``measure_top``.  The winner is written back to the cache
    either way, so restarts and same-shaped streams hit it.
    """
    from repro_torch.device import note_host_syncs

    t0 = time.perf_counter()
    n = graph.num_vertices
    note_host_syncs(3)          # the live count; the dst selection and read
    e = int(graph.num_valid_edges())
    key = f"{device_kind(graph.device)}/{graph_signature(n, e, frontier_frac)}"
    if cache is None:
        cache = TuneCache(cache_path)
    hit = cache.get(key)
    if hit is not None:
        return hit, TuneInfo(source="cache", cache_hit=True,
                             tune_time_s=time.perf_counter() - t0, key=key)

    dst = graph.dst[graph.valid].cpu().numpy()
    ranked = candidate_costs(dst, n, frontier_frac, expected_inserts,
                             grid=grid)
    source = "model"
    cands = [(g, p, None) for g, p in ranked]
    best = ranked[0][0]
    if measure and len(ranked) > 1:
        timed = []
        for geom, pred in ranked[: max(2, measure_top)]:
            timed.append((geom, pred,
                          _measure(graph, geom, frontier_frac, use_kernel)))
        timed.sort(key=lambda t: t[2])
        best = timed[0][0]
        cands = timed + cands[len(timed):]
        source = "measured"
    cache.put(key, best)
    return best, TuneInfo(source=source, cache_hit=False,
                          tune_time_s=time.perf_counter() - t0, key=key,
                          candidates=tuple(cands))
