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
``WalkIndex`` / ``ShardedWalkIndex``) makes the engine keep a random-walk
PPR index beside the ranks: built at bootstrap (range-sharded over the
mesh's ``model`` axis when a ``mesh=`` is given), repaired in every step
from the batch's
``touched_vertices_mask`` (only walks that visit a touched vertex are
re-walked, by the ``walk_repair`` kernel on the card) and published in
each snapshot, so index-backed ``personalized_top_k`` answers match the
served graph.  ``metrics.walks_resampled`` counts the re-walked walks.

``monitor=`` (an ``obs.monitor.CorrectnessMonitor``) opts the engine
into correctness observability: per-batch invariant sentinels, sampled
shadow verification, flight recording with bit-for-bit replay, and SLO
burn-rate alerts (DESIGN.md §12).  ``inject_fault`` arms a one-shot
debug corruption so that pipeline can be exercised end-to-end.

``telemetry=`` records per-iteration frontier rows (``obs.frontier``):
None follows the global tracer (rows are recorded exactly when a trace
is being taken), True/False pins it.  The rows of the last batch are
``last_telemetry``; ``telemetry_sink`` (an ``obs.export.JsonlSink``,
assignable) receives one record a batch.  With the global tracer on, a
step records the spans ``serve.step``, ``ingest.coalesce``,
``route_update``, ``fused_update_loop`` and ``polish.f64`` (or
``solve``), ``snapshot.publish``, ``monitor.observe`` and
``ppr.repair``, and the instant ``frontier.telemetry``.

``on_publish`` (assignable attribute, like ``telemetry_sink``) is
called after every post-batch snapshot publish with ``(snapshot,
batch)``.  ``close()`` stops the step thread and closes the monitor,
which joins the shadow-verifier thread.

``iteration_budget=`` (an int or an ``ft.straggler.IterationBudget``)
caps each dynamic solve at ``max_iter`` iterations (the kernel engine caps
its f32 phase and its f64 polish each) and carries the ever-affected set
of a batch that stopped unconverged into the next batch's seed set, on
the device.  A static solve (bootstrap, fallback) runs uncapped.  The
convergence test reads the solve's delta only when the solve used every
iteration of its cap: one host sync on such a batch, none otherwise.

Unless ``kernel_opts`` fixes ``be``/``vb``, the kernel engine tunes its
pack geometry at bootstrap, as the reference does
(``kernels/pagerank_spmv/tune.py``: the model's pick for the graph's
shape at ``frontier_frac`` (0.05), cached on disk; ``tune_measure=True``
times the model's top picks on the card; ``tune_cache_path`` names the
cache file; ``tune=False`` keeps ``KERNEL_PACK_DEFAULTS``).
``kernel_geometry`` and ``tune_info`` say what was picked and how.
``use_kernel`` ("auto": the kernel on CUDA tensors, its plain version on
the CPU; True: the kernel, raising on CPU tensors; False: the plain
version, the reference's option, refused for a CUDA graph) reaches every
``frontier_spmv`` call.

``mesh=`` (a ``launch.mesh.Mesh``) runs the multi-device engines
(``dist/pagerank_dist.py``): the kernel engine shards its pack by window
ranges over the mesh's ``model`` axis (``ShardedKernelEngine``; each
shard's geometry from the tuner, ``kernel_opts["delta_budget"]`` bounds a
shard's routed rows, ``kernel_opts["exchange"]`` / ``["wire"]`` pick the
f32 exchange), repacking on a ``ShardCapacityError``
(``metrics.packed_rebuilds_by_shard``); the xla engine runs the f64
dst-range x edge-stripe loop.  ``metrics.comm_bytes`` adds each solve's
wire bytes; the ``halo_occupancy`` gauge is set a batch.  With
``ppr_index=`` the walk index is range-sharded over the same axis
(``ppr.shard``) and each shard repairs its own walks.

Each batch records its host syncs (``metrics.batch_host_syncs``): every
call of the step that synchronizes the host with the card, as each call
site records it (``device.note_host_syncs``), and as
``torch.cuda.set_sync_debug_mode`` counts them on the card.  On the
kernel engine's rank path that is six uploads of the polled batch from
pageable memory, five boolean-mask selections in ``apply_batch`` and
eight in the packed update (each reads its size back), the fallback
check, the fused step's overflow check, one read per solver iteration
(f32 phase and f64 polish), and one read of the batch's counters, which
also waits for the device (repair kernels included) so that the latency
is honest.  A walk index adds one (the stale count); a repack adds its
reads and uploads; an iteration budget adds one (the delta) on a batch
whose capped solve used every iteration of its cap.  Telemetry adds none
(its rows ride the solver's reads).  The ``on_publish`` hook runs inside
the step, so its reads (a replication writer's diff and copies,
``serve/replicate.py``) count in the batch.  The monitor adds one (the
sentinel's read), one a leaf on a batch that takes an anchor, and, with
a synchronous shadow, the shadow solve's reads on a sampled batch; each
is counted in the batch, whose count is taken after the monitor.  The
global tracer, when on, adds one a closed device span (``Tracer.sync``).
On a mesh the kernel engine makes each shard's packed-update selections,
reads the route's budget check, the shards' dropped insertions, the
halo's overflow and the halo-occupancy gauge, and one read per f32
iteration; the xla mesh engine's host partition reads the graph three
times and uploads three arrays.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import torch

from repro_torch.core import pagerank as pr
from repro_torch.core.api import ENGINES, KERNEL_FLAGS, LOOP_FLAGS, Method, \
    build_initial_state, distributed_pagerank
from repro_torch.core.kernel_engine import fused_hybrid_pagerank, \
    hybrid_pagerank
from repro_torch.device import host_sync_count, note_host_syncs
from repro_torch.dist.pagerank_dist import ShardedKernelEngine, _mesh_dims
from repro_torch.ft.straggler import IterationBudget
from repro_torch.graph.dynamic import apply_batch, touched_vertices_mask
from repro_torch.graph.structure import EdgeListGraph
from repro_torch.kernels.pagerank_spmv.shard import ShardCapacityError, \
    halo_occupancy
from repro_torch.kernels.pagerank_spmv.tune import KernelGeometry, \
    tune_geometry
from repro_torch.kernels.pagerank_spmv.update import PackedSpillError, \
    apply_batch_packed, pack_graph
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.frontier import FrontierTelemetry
from repro_torch.ppr import IndexConfig, ShardedWalkIndex, WalkIndex, \
    build_sharded_walk_index, build_walk_index, repair_walk_index, \
    repair_walk_index_sharded
from repro_torch.serve.ingest import IngestQueue
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.state import RankStore

DYNAMIC_METHODS = ("naive", "traversal", "frontier", "frontier_prune")

# serving pack defaults (the reference's), kept when tuning is off
KERNEL_PACK_DEFAULTS = dict(be=512, vb=256, spill_lanes_per_window=256)
_PACK_KEYS = ("be", "vb", "spill_lanes_per_window", "num_entries",
              "extra_entries", "overlay_capacity")


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
        if mesh is not None:
            _mesh_dims(mesh)                 # a Mesh with a 'model' axis
        opts = dict(kernel_opts or {})
        # opt-in walk index: an IndexConfig to build at bootstrap (sharded
        # over `mesh` when one is given), or a prebuilt index to adopt
        self._ppr_cfg: Optional[IndexConfig] = None
        self._ppr = None
        if isinstance(ppr_index, IndexConfig):
            self._ppr_cfg = ppr_index
        elif isinstance(ppr_index, (WalkIndex, ShardedWalkIndex)):
            self._ppr = ppr_index
        elif ppr_index is not None:
            raise TypeError("ppr_index must be an IndexConfig or a "
                            "WalkIndex (or a ShardedWalkIndex), got "
                            f"{type(ppr_index).__name__}")
        self.ingest = ingest
        self.store = store
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.method = method
        self.engine = engine
        explicit = {k: opts.pop(k) for k in _PACK_KEYS if k in opts}
        # tune unless the caller fixed the geometry (be/vb) themselves
        self._tune = opts.pop("tune", not ({"be", "vb"} & set(explicit)))
        self._tune_measure = opts.pop("tune_measure", False)
        self._tune_cache_path = opts.pop("tune_cache_path", None)
        self._frontier_frac = opts.pop("frontier_frac", 0.05)
        self._explicit_pack = explicit
        self._pack_kw = {**KERNEL_PACK_DEFAULTS, **explicit}
        self.kernel_geometry = None   # set at bootstrap (kernel engine)
        self.tune_info = None
        self._delta_budget = opts.pop("delta_budget", None)
        self._shard_kw = {k: opts.pop(k) for k in ("exchange", "wire",
                                                     "halo_capacity")
                          if k in opts}
        use_kernel = opts.pop("use_kernel", "auto")
        if use_kernel not in ("auto", True, False):
            raise ValueError(f"use_kernel must be 'auto', True or False, "
                             f"got {use_kernel!r}")
        if use_kernel is False and graph.device.type == "cuda":
            # on the card every frontier_spmv call launches the kernel
            raise ValueError("use_kernel=False runs the plain version, "
                             "which is for CPU graphs only; on the card "
                             "pass use_kernel='auto' or True")
        self._kernel_kw = dict(opts, use_kernel=use_kernel)
        self._packed = None
        self._sharded = None   # dist.ShardedKernelEngine (kernel + mesh)
        self.static_fallback_frac = static_fallback_frac
        self.pr_kw = pr_kw
        self._clock = clock
        self._graph = graph
        self._ranks: Optional[torch.Tensor] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.mesh = mesh
        # frontier telemetry: None = follow the global tracer, True/False
        # pins it
        self.telemetry = telemetry
        self.last_telemetry: Optional[FrontierTelemetry] = None
        # optional obs.export.JsonlSink receiving one frontier record per
        # batch (assigned by the launch driver behind --trace)
        self.telemetry_sink = None
        # correctness monitor (obs.monitor.CorrectnessMonitor): hooked
        # after bootstrap and after every publish; None = zero overhead
        self.monitor = monitor
        # per-batch iteration cap with frontier carryover
        # (ft.straggler.IterationBudget); an int means max_iter_per_batch
        if isinstance(iteration_budget, int):
            iteration_budget = IterationBudget(iteration_budget)
        self._budget = iteration_budget
        # post-publish hook (snapshot, batch)
        self.on_publish = None
        self._closed = False
        # one-shot debug fault armed by inject_fault(); applied (and
        # cleared) by the step that publishes the chosen generation
        self._fault: Optional[dict] = None
        self.faults_injected = 0

    @property
    def packed(self):
        """The kernel engine's current ``PackedGraph`` (None before
        bootstrap and on the f64 engine)."""
        return self._packed

    # ---- lifecycle -------------------------------------------------------
    @property
    def ppr_index(self):
        """The walk index the engine keeps (None without one, or before
        bootstrap builds it)."""
        return self._ppr

    def bootstrap(self, ranks: Optional[torch.Tensor] = None,
                  last_seq: Optional[int] = None) -> int:
        """Publish generation 0: a cold static f64 solve, or given ranks.
        Builds the walk index if one was asked for."""
        if ranks is None:
            ranks = self._solve("static", self._graph, None, None).ranks
        if self.engine == "kernel" and self.kernel_geometry is None:
            if self._tune:
                geom, self.tune_info = tune_geometry(
                    self._graph, frontier_frac=self._frontier_frac,
                    expected_inserts=max(1024, 64 * self.ingest.capacity),
                    measure=self._tune_measure,
                    use_kernel=self._kernel_kw["use_kernel"],
                    cache_path=self._tune_cache_path)
                # caller-fixed keys still win over the tuned geometry
                self._pack_kw = {**self._pack_kw, **geom.pack_kw(),
                                 **self._explicit_pack}
            self.kernel_geometry = KernelGeometry(
                be=self._pack_kw["be"], vb=self._pack_kw["vb"],
                spill_lanes_per_window=self._pack_kw[
                    "spill_lanes_per_window"])
        if self.engine == "kernel" and self.mesh is not None \
                and self._sharded is None:
            pack_kw = dict(self._pack_kw)
            if "num_entries" not in pack_kw:
                spare = (self._graph.edge_capacity
                         - int(self._graph.num_valid_edges()))
                pack_kw.setdefault("extra_entries",
                                   -(-spare // pack_kw["be"]))
            pack_kw.setdefault(
                "overlay_capacity", max(1024, 64 * self.ingest.capacity))
            kw = dict(self._kernel_kw, **self._shard_kw)
            self._sharded = ShardedKernelEngine(
                self.mesh, self._graph, pack_kw=pack_kw,
                delta_budget=self._delta_budget,
                use_kernel=kw.pop("use_kernel"), **kw)
        if self.engine == "kernel" and self.mesh is None \
                and self._packed is None:
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
            if self.mesh is not None:
                self._ppr = build_sharded_walk_index(
                    self._graph, self._ppr_cfg, mesh=self.mesh)
            else:
                self._ppr = build_walk_index(self._graph, self._ppr_cfg)
        self._ranks = ranks
        seq = self.ingest.start_seq - 1 if last_seq is None else last_seq
        gen = self.store.publish(self._graph, ranks, seq,
                                 ppr_index=self._ppr)
        if self.monitor is not None:
            # bind the recorder's config + capture the bootstrap anchor
            self.monitor.on_bootstrap(self)
        return gen

    # ---- debug fault injection ------------------------------------------
    def inject_fault(self, generation: int, kind: str = "rank",
                     vertex: int = 0, scale: float = 2.0) -> None:
        """DEBUG ONLY: arm a one-shot corruption for ``generation``.

        ``kind="rank"`` multiplies ``ranks[vertex]`` by ``scale`` in a
        copy of the solve's *output*, after convergence but before
        publish — the exact shape of the DF blind spot (a vertex no later
        frontier revisits keeps the corrupt value forever), which is what
        the mass sentinel and shadow verifier exist to catch.  No tensor
        of the graph is written in place (its cached order would go
        stale).  ``kind="event"`` redirects every insertion in that
        generation's coalesced batch to land on ``vertex`` *before* the
        update is applied (or recorded), so the served graph silently
        diverges from the submitted feed.  Used by tests and the smoke's
        incident-replay phase; never call it in production serving.
        """
        if kind not in ("rank", "event"):
            raise ValueError(f"unknown fault kind {kind!r}")
        self._fault = dict(generation=int(generation), kind=str(kind),
                           vertex=int(vertex), scale=float(scale))

    # ---- one micro-batch -------------------------------------------------
    def step(self, force: bool = False) -> bool:
        """Apply one coalesced micro-batch if due; True if work was done."""
        if self._ranks is None:
            raise RuntimeError("bootstrap() before step()")
        tr = obs_trace.get_tracer()
        s0 = tr.now()
        syncs0 = host_sync_count()
        batch = self.ingest.poll(force=force)
        if batch is None:
            return False
        # poll may yield nothing, so the span is recorded after the fact
        # (Chrome-trace nesting is by timestamps, not buffer order)
        tr.record("ingest.coalesce", s0, tr.now() - s0,
                  events=batch.num_events, coalesced=batch.num_coalesced)
        tel = tr.enabled if self.telemetry is None else bool(self.telemetry)
        fault = None
        if self._fault is not None \
                and self.store.generation + 1 == self._fault["generation"]:
            fault, self._fault = self._fault, None
            self.faults_injected += 1
        if fault is not None and fault["kind"] == "event":
            # corrupt the batch BEFORE it is applied or recorded: the
            # flight recorder sees (and replays) the corrupted stream,
            # exactly as a feed bug would present
            upd = batch.update
            batch = batch._replace(update=upd._replace(
                ins_dst=upd.ins_dst.masked_fill(upd.ins_mask,
                                                fault["vertex"])))
        t0 = self._clock()
        r0 = tr.now()
        graph_new = apply_batch(self._graph, batch.update)
        method = self.method
        init_state = build_initial_state(self._graph, graph_new,
                                         batch.update, self._ranks, method)
        if (self._budget is not None and method in DYNAMIC_METHODS
                and self._budget.carried_frontier is not None):
            # a capped previous batch left an unconverged frontier: fold
            # it into this batch's seed set (DF re-marks until Δ ≤ τ); it
            # stays on the device, so no host read
            init_state = (init_state[0],
                          self._budget.seeds_for_batch(init_state[1]))
            self.metrics.record_budget_carryover()
        fallback = False
        if method in ("traversal", "frontier", "frontier_prune"):
            note_host_syncs()
            frac = float(init_state[1].to(torch.float64).mean())
            if frac > self.static_fallback_frac:
                method, fallback = "static", True
                init_state = build_initial_state(
                    self._graph, graph_new, batch.update, self._ranks,
                    "static")
        # the budget caps dynamic solves only: a capped static solve
        # restarts cold every batch and would never converge, while a
        # capped DF/DF-P batch resumes from its carried frontier
        cap = (self._budget.max_iter
               if self._budget is not None and method in DYNAMIC_METHODS
               else None)
        # the fused path folds packed maintenance into the solve
        fuse = (self._packed is not None and not fallback
                and method in DYNAMIC_METHODS)
        if self._sharded is not None:
            try:
                self._sharded.apply_update(batch.update)
            except ShardCapacityError as e:
                # budget/spill/overlay/halo exhaustion on some shards:
                # repack every shard at the pinned shapes.  Only the typed
                # capacity error means "recoverable by repack"
                self._sharded.repack(graph_new)
                self.metrics.record_packed_rebuild(shards=e.shards)
        elif self._packed is not None and not fuse:
            try:
                self._packed = apply_batch_packed(self._packed, batch.update)
            except PackedSpillError:
                # spill/overlay exhaustion: repack at the pinned shapes
                self._packed = self._repack(graph_new)
                self.metrics.record_packed_rebuild()
        # edge-list update + packed maintenance (the fused path defers
        # maintenance into the solve, traced there)
        tr.record("route_update", r0, tr.now() - r0, fused=fuse)
        if fuse:
            kw = dict(KERNEL_FLAGS[method], **self._kernel_kw, **self.pr_kw)
            kw.setdefault("telemetry", tel)
            if cap is not None:
                kw["max_iter"] = cap
            try:
                self._packed, res = fused_hybrid_pagerank(
                    graph_new, self._packed, batch.update, *init_state, **kw)
            except PackedSpillError:
                # overflow: repack at the pinned shapes and re-run with the
                # SAME update (maintenance is then a no-op)
                self._packed = self._repack(graph_new)
                self.metrics.record_packed_rebuild()
                self._packed, res = fused_hybrid_pagerank(
                    graph_new, self._packed, batch.update, *init_state, **kw)
        else:
            with tr.span("solve", method=method, engine=self.engine):
                res = self._solve(method, graph_new, batch.update,
                                  self._ranks, graph_prev=self._graph,
                                  init_state=init_state, telemetry=tel,
                                  max_iter=cap)
                tr.sync(res.ranks)
        if self._budget is not None:
            self._after_budget(cap, res)
        if fault is not None and fault["kind"] == "rank":
            # a copy of the solved ranks: no tensor is written in place
            ranks = res.ranks.clone()
            v = fault["vertex"]
            ranks[v:v + 1].mul_(fault["scale"])
            res = res._replace(ranks=ranks)
        resampled = 0
        if self._ppr is not None:
            # the touched signal that seeds the DF frontier also marks the
            # stale walks; the stale count is the repair's one host read
            touched = touched_vertices_mask(batch.update,
                                            graph_new.num_vertices)
            if isinstance(self._ppr, ShardedWalkIndex):
                self._ppr, resampled = repair_walk_index_sharded(
                    self._ppr, graph_new, touched)
            else:
                self._ppr, resampled = repair_walk_index(
                    self._ppr, graph_new, touched)
        # one read of the batch's counters; it also waits for the device
        note_host_syncs()
        affected, edges, verts = torch.stack([
            res.affected_ever.sum(dtype=torch.int64), res.edges_processed,
            res.vertices_processed]).tolist()
        latency = self._clock() - t0
        self._graph, self._ranks = graph_new, res.ranks
        with tr.span("snapshot.publish"):
            self.store.publish(graph_new, res.ranks, batch.last_seq,
                               ppr_index=self._ppr)
        if self.on_publish is not None:
            self.on_publish(self.store.snapshot(), batch)
        self._observe_batch(tr, batch, res, tel)
        if self.monitor is not None:
            m0 = tr.now()
            self.monitor.on_batch(
                engine=self, batch=batch, graph=graph_new, result=res,
                method=method, fallback=fallback, latency_s=latency,
                affected=affected, fault=fault)
            tr.record("monitor.observe", m0, tr.now() - m0)
            if self.faults_injected:
                self.metrics.set_gauge("faults_injected",
                                       float(self.faults_injected))
        # taken after the monitor, whose reads are part of the batch
        syncs = host_sync_count() - syncs0
        self.metrics.record_batch(
            latency, batch.num_events, batch.num_coalesced,
            affected=affected, iterations=res.iterations, fallback=fallback,
            walks_resampled=resampled,
            edges_processed=edges, vertices_processed=verts,
            comm_bytes=(self._sharded.last_comm_bytes
                        if self._sharded is not None else 0),
            host_syncs=syncs)
        tr.record("serve.step", s0, tr.now() - s0, method=method,
                  events=batch.num_events, fallback=fallback,
                  host_syncs=syncs)
        return True

    def _after_budget(self, cap: Optional[int], res) -> None:
        """Carry the frontier of a capped solve that stopped unconverged
        (the reference's test: it used every iteration of its cap and its
        delta is still above τ).  The delta is read only in that case."""
        if cap is None:
            # a static solve ran uncapped to full convergence
            self._budget.after_batch(True, None)
            return
        converged = res.iterations < cap
        if not converged:
            note_host_syncs()
            tol = float(self.pr_kw.get("tol", pr.TOL))
            converged = float(res.delta) <= tol
        self._budget.after_batch(converged, res.affected_ever)

    def _observe_batch(self, tr, batch, res, tel: bool):
        """Per-batch telemetry capture + engine-attribute gauges."""
        self.last_telemetry = None
        if tel and res.telemetry is not None:
            ft = FrontierTelemetry(res.telemetry)
            self.last_telemetry = ft
            summary = ft.summary()
            self.metrics.record_frontier(summary)
            tr.instant("frontier.telemetry", **summary)
            if self.telemetry_sink is not None:
                self.telemetry_sink.write(
                    dict(seq=int(batch.last_seq), summary=summary,
                         rows=ft.rows()), kind="frontier")
        m = self.metrics
        if self.tune_info is not None:
            m.set_gauge("tune_cache_hit_rate",
                        1.0 if self.tune_info.cache_hit else 0.0)
        if self._sharded is not None and self._sharded.halo is not None:
            m.set_gauge("halo_occupancy", halo_occupancy(self._sharded.halo))
        m.set_gauge("staleness_in_events",
                    max(0, self.ingest.latest_seq - int(batch.last_seq)))

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
               init_state: Optional[tuple] = None, telemetry: bool = False,
               max_iter: Optional[int] = None):
        graph_prev = graph_prev if graph_prev is not None else graph_new
        init_ranks, init_affected = (
            init_state if init_state is not None else build_initial_state(
                graph_prev, graph_new, update, prev_ranks, method))
        # the budget's cap
        capkw = {} if max_iter is None else dict(max_iter=max_iter)
        if self.mesh is not None:
            if self._sharded is not None and method in DYNAMIC_METHODS:
                return self._sharded.solve(graph_new, init_ranks,
                                           init_affected,
                                           telemetry=telemetry,
                                           **KERNEL_FLAGS[method],
                                           **{**self.pr_kw, **capkw})
            # the xla mesh loop reports endpoint scalars only
            return distributed_pagerank(graph_prev, graph_new, update,
                                        prev_ranks, method, self.mesh,
                                        init_state=(init_ranks,
                                                    init_affected),
                                        **{**self.pr_kw, **capkw})
        if self.engine == "kernel" and method in DYNAMIC_METHODS:
            kw = dict(KERNEL_FLAGS[method], **self._kernel_kw, **self.pr_kw,
                      **capkw)
            kw.setdefault("telemetry", telemetry)
            return hybrid_pagerank(graph_new, self._packed, init_ranks,
                                   init_affected, **kw)
        kw = dict(LOOP_FLAGS[method], **self.pr_kw, **capkw)
        kw.setdefault("telemetry", telemetry)
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
        """Full shutdown: stop the step thread (without draining) and close
        the correctness monitor, which joins the shadow-verifier thread
        and flushes its latest-wins mailbox so a pending divergence is
        reported, never dropped.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        self.stop(drain=False)
        if self.monitor is not None:
            self.monitor.close()
