"""The serve-loop engine: micro-batch in, snapshot out (twin of
``repro.serve.engine``, single device).

One ``step`` = poll the ingest queue for a coalesced micro-batch, apply
it (``apply_batch``), build the method's initial affected set
(``core.api.build_initial_state``), run the DF/DF-P solve, publish the new
(graph, ranks, generation) snapshot.  The step is synchronous and
single-consumer; ``start``/``stop`` wrap it in a daemon thread, while
tests and benchmarks drive ``step`` directly.

Static fallback (paper §5.2.2): when the initial affected set of the
chosen dynamic method covers more than ``static_fallback_frac`` of the
vertices, the step reruns from a cold start instead.

``engine="kernel"`` makes the frontier-gated SpMV kernel the hot path:
bootstrap packs the graph into the blocked ``PackedGraph`` once (geometry
``KERNEL_PACK_DEFAULTS`` unless ``kernel_opts`` fixes ``be``/``vb``/...),
every micro-batch maintains it on the device and runs the fused
update+solve step (f32 kernel iterations + f64 polish).  Static solves
(bootstrap, fallback) stay on the f64 loop.  If a window's spill lanes or
the locator overlay run out, the engine repacks from the current graph at
the pinned shapes (``metrics.packed_rebuilds`` counts these).

``kernel_opts`` takes pack sizing (``be``, ``vb``,
``spill_lanes_per_window``, ``num_entries``, ``extra_entries``,
``overlay_capacity``), ``tune=False`` and any ``hybrid_pagerank`` keyword
(``tol_f32``, ``polish``, ...).

``ppr_index=`` (a ``repro_torch.ppr.IndexConfig`` or a prebuilt
``WalkIndex``) makes the engine keep a random-walk PPR index beside the
ranks: built at bootstrap, repaired in every step from the batch's
``touched_vertices_mask`` (only walks that visit a touched vertex are
re-walked, by the ``walk_repair`` kernel on the card) and published in
each snapshot, so index-backed ``personalized_top_k`` answers match the
served graph.  ``metrics.walks_resampled`` counts the re-walked walks.

The reference's geometry tuner, mesh (and with it the sharded walk
index), correctness monitor, iteration budget and telemetry are not
ported yet; asking for them raises.

Each batch records its host syncs (``metrics.batch_host_syncs``): one
per solver iteration, one for the fallback check, one for the fused
step's overflow check, one for the walk repair's stale count when an
index is kept, and one read of the batch's counters, which also waits
for the device (repair kernels included) so that the latency is honest.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import torch

from repro_torch.core import pagerank as pr
from repro_torch.core.api import ENGINES, KERNEL_FLAGS, LOOP_FLAGS, Method, \
    build_initial_state
from repro_torch.core.kernel_engine import fused_hybrid_pagerank, \
    hybrid_pagerank
from repro_torch.graph.dynamic import apply_batch, touched_vertices_mask
from repro_torch.graph.structure import EdgeListGraph
from repro_torch.kernels.pagerank_spmv.update import PackedSpillError, \
    apply_batch_packed, pack_graph
from repro_torch.ppr import IndexConfig, WalkIndex, build_walk_index, \
    repair_walk_index
from repro_torch.serve.ingest import IngestQueue
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.state import RankStore

DYNAMIC_METHODS = ("naive", "traversal", "frontier", "frontier_prune")

# serving pack defaults (the reference's, with tuning off)
KERNEL_PACK_DEFAULTS = dict(be=512, vb=256, spill_lanes_per_window=256)
_PACK_KEYS = ("be", "vb", "spill_lanes_per_window", "num_entries",
              "extra_entries", "overlay_capacity")
# reference kernel_opts with no counterpart in this port yet
_UNPORTED_OPTS = ("use_kernel", "tune_measure", "tune_cache_path",
                  "frontier_frac", "delta_budget")


class ServeEngine:
    def __init__(self, graph: EdgeListGraph, ingest: IngestQueue,
                 store: RankStore, metrics: Optional[ServeMetrics] = None,
                 method: Method = "frontier_prune", mesh=None,
                 engine: str = "xla",
                 kernel_opts: Optional[dict] = None,
                 static_fallback_frac: float = 0.25,
                 ppr_index=None, clock=time.monotonic,
                 telemetry: Optional[bool] = None, monitor=None,
                 iteration_budget=None, **pr_kw):
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; options {ENGINES}")
        unported = [name for name, v in (
            ("mesh", mesh), ("telemetry", telemetry), ("monitor", monitor),
            ("iteration_budget", iteration_budget)) if v is not None]
        opts = dict(kernel_opts or {})
        if opts.pop("tune", False):
            unported.append("kernel_opts['tune']=True")
        unported += [f"kernel_opts[{k!r}]" for k in _UNPORTED_OPTS
                     if k in opts]
        if unported:
            raise NotImplementedError(
                f"ServeEngine: {', '.join(unported)} not ported yet")
        # opt-in walk index: an IndexConfig to build at bootstrap, or a
        # prebuilt WalkIndex to adopt
        self._ppr_cfg: Optional[IndexConfig] = None
        self._ppr: Optional[WalkIndex] = None
        if isinstance(ppr_index, IndexConfig):
            self._ppr_cfg = ppr_index
        elif isinstance(ppr_index, WalkIndex):
            self._ppr = ppr_index
        elif ppr_index is not None:
            raise TypeError("ppr_index must be an IndexConfig or a "
                            f"WalkIndex, got {type(ppr_index).__name__}")
        self.ingest = ingest
        self.store = store
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.method = method
        self.engine = engine
        explicit = {k: opts.pop(k) for k in _PACK_KEYS if k in opts}
        self._pack_kw = {**KERNEL_PACK_DEFAULTS, **explicit}
        self._kernel_kw = opts
        self._packed = None
        self.static_fallback_frac = static_fallback_frac
        self.pr_kw = pr_kw
        self._clock = clock
        self._graph = graph
        self._ranks: Optional[torch.Tensor] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    @property
    def packed(self):
        """The kernel engine's current ``PackedGraph`` (None before
        bootstrap and on the f64 engine)."""
        return self._packed

    # ---- lifecycle -------------------------------------------------------
    @property
    def ppr_index(self) -> Optional[WalkIndex]:
        """The walk index the engine keeps (None without one, or before
        bootstrap builds it)."""
        return self._ppr

    def bootstrap(self, ranks: Optional[torch.Tensor] = None,
                  last_seq: Optional[int] = None) -> int:
        """Publish generation 0: a cold static f64 solve, or given ranks.
        Builds the walk index if one was asked for."""
        if ranks is None:
            ranks = self._solve("static", self._graph, None, None).ranks
        if self.engine == "kernel" and self._packed is None:
            if "num_entries" not in self._pack_kw:
                # mirror the edge list's stream headroom as empty tail
                # entries, so an overflow repack at the pinned capacity
                # can redistribute them to whichever windows grew
                spare = (self._graph.edge_capacity
                         - int(self._graph.num_valid_edges()))
                self._pack_kw.setdefault(
                    "extra_entries", -(-spare // self._pack_kw["be"]))
            # ~64 micro-batches of insertions between locator repacks
            self._pack_kw.setdefault(
                "overlay_capacity", max(1024, 64 * self.ingest.capacity))
            self._packed = pack_graph(self._graph, **self._pack_kw)
            # pin every shape so overflow repacks keep them; the
            # per-window entry bound is pinned at the total entry count
            cap = self._packed.num_entries
            self._pack_kw["num_entries"] = cap
            self._pack_kw["max_entries_per_window"] = cap
            self._pack_kw.pop("extra_entries", None)
            self._packed = dataclasses.replace(
                self._packed, max_entries_per_window=cap)
        if self._ppr_cfg is not None and self._ppr is None:
            self._ppr = build_walk_index(self._graph, self._ppr_cfg)
        self._ranks = ranks
        seq = self.ingest.start_seq - 1 if last_seq is None else last_seq
        return self.store.publish(self._graph, ranks, seq,
                                  ppr_index=self._ppr)

    # ---- one micro-batch -------------------------------------------------
    def step(self, force: bool = False) -> bool:
        """Apply one coalesced micro-batch if due; True if work was done."""
        if self._ranks is None:
            raise RuntimeError("bootstrap() before step()")
        batch = self.ingest.poll(force=force)
        if batch is None:
            return False
        t0 = self._clock()
        syncs = 0
        graph_new = apply_batch(self._graph, batch.update)
        method = self.method
        init_state = build_initial_state(self._graph, graph_new,
                                         batch.update, self._ranks, method)
        fallback = False
        if method in ("traversal", "frontier", "frontier_prune"):
            frac = float(init_state[1].to(torch.float64).mean())
            syncs += 1
            if frac > self.static_fallback_frac:
                method, fallback = "static", True
                init_state = build_initial_state(
                    self._graph, graph_new, batch.update, self._ranks,
                    "static")
        # the fused path folds packed maintenance into the solve
        fuse = (self._packed is not None and not fallback
                and method in DYNAMIC_METHODS)
        if self._packed is not None and not fuse:
            syncs += 1
            try:
                self._packed = apply_batch_packed(self._packed, batch.update)
            except PackedSpillError:
                # spill/overlay exhaustion: repack at the pinned shapes
                self._packed = self._repack(graph_new)
                self.metrics.record_packed_rebuild()
        if fuse:
            kw = dict(KERNEL_FLAGS[method], **self._kernel_kw, **self.pr_kw)
            try:
                self._packed, res = fused_hybrid_pagerank(
                    graph_new, self._packed, batch.update, *init_state, **kw)
            except PackedSpillError:
                # overflow: repack at the pinned shapes and re-run with the
                # SAME update (maintenance is then a no-op)
                syncs += 1
                self._packed = self._repack(graph_new)
                self.metrics.record_packed_rebuild()
                self._packed, res = fused_hybrid_pagerank(
                    graph_new, self._packed, batch.update, *init_state, **kw)
        else:
            res = self._solve(method, graph_new, batch.update, self._ranks,
                              graph_prev=self._graph, init_state=init_state)
        resampled = 0
        if self._ppr is not None:
            # the touched signal that seeds the DF frontier also marks the
            # stale walks; the stale count is the repair's one host read
            touched = touched_vertices_mask(batch.update,
                                            graph_new.num_vertices)
            self._ppr, resampled = repair_walk_index(self._ppr, graph_new,
                                                     touched)
            syncs += 1
        # one read of the batch's counters; it also waits for the device
        affected, edges, verts = torch.stack([
            res.affected_ever.sum(dtype=torch.int64), res.edges_processed,
            res.vertices_processed]).tolist()
        syncs += 1 + res.host_syncs
        latency = self._clock() - t0
        self._graph, self._ranks = graph_new, res.ranks
        self.store.publish(graph_new, res.ranks, batch.last_seq,
                           ppr_index=self._ppr)
        self.metrics.record_batch(
            latency, batch.num_events, batch.num_coalesced,
            affected=affected, iterations=res.iterations, fallback=fallback,
            walks_resampled=resampled,
            edges_processed=edges, vertices_processed=verts,
            host_syncs=syncs)
        self.metrics.set_gauge(
            "staleness_in_events",
            max(0, self.ingest.latest_seq - int(batch.last_seq)))
        return True

    def _repack(self, graph: EdgeListGraph):
        """Repack at the pinned shapes, degrading the spill guarantee if
        the grown windows no longer fit it; a failure beyond that is the
        genuine capacity limit and propagates."""
        try:
            return pack_graph(graph, **self._pack_kw)
        except ValueError:
            return pack_graph(graph, **{**self._pack_kw,
                                        "spill_lanes_per_window": 0})

    def _solve(self, method: Method, graph_new: EdgeListGraph, update,
               prev_ranks, graph_prev: Optional[EdgeListGraph] = None,
               init_state: Optional[tuple] = None):
        graph_prev = graph_prev if graph_prev is not None else graph_new
        init_ranks, init_affected = (
            init_state if init_state is not None else build_initial_state(
                graph_prev, graph_new, update, prev_ranks, method))
        if self.engine == "kernel" and method in DYNAMIC_METHODS:
            kw = dict(KERNEL_FLAGS[method], **self._kernel_kw, **self.pr_kw)
            return hybrid_pagerank(graph_new, self._packed, init_ranks,
                                   init_affected, **kw)
        kw = dict(LOOP_FLAGS[method], **self.pr_kw)
        return pr._pagerank_loop(graph_new, init_ranks, init_affected, **kw)

    def drain(self, force: bool = True) -> int:
        """Run steps until the ingest queue is empty; returns batch count."""
        n = 0
        while self.step(force=force):
            n += 1
        return n

    # ---- background thread ----------------------------------------------
    def start(self, idle_sleep: float = 0.001):
        """Run the step loop in a daemon thread until ``stop``."""
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                if not self.step():
                    time.sleep(idle_sleep)

        self._thread = threading.Thread(target=loop, name="serve-engine",
                                        daemon=True)
        self._thread.start()

    def stop(self, drain: bool = True):
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None
        if drain:
            self.drain(force=True)

    def close(self):
        """Stop the step thread without draining.  Idempotent."""
        self.stop(drain=False)
