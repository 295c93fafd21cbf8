"""The port's rank service as the system under test: ``ServeEngine`` fed
through its ``IngestQueue`` and read through its ``QueryClient``.

A configuration names this module with ``"system": "serve_engine"``.  It
owns what follows from the configuration: the graph, made from the seed
on the card; the engine built on it as the configuration states, sized
and tuned by the engine itself at bootstrap; the engine's counters read
around the window; and the judgement of what the window produced against
the plain reference (``harness/judge.py``).  This module is the one place
the harness touches ``repro_torch``: it hands the program the generated
inputs and takes back its outputs, spans, counters and geometry.

A traffic loop (``loops/<loop>.py``) drives a ``System`` through
``submit``, ``step`` and ``query``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from harness import inputs, judge


@dataclasses.dataclass
class Answer:
    vertices: list
    values: list
    generation: int


class System:
    # the program's spans a traced run collects
    SPANS = ("ingest.coalesce", "route_update", "fused_update_loop",
             "polish.f64", "solve", "ppr.repair", "snapshot.publish",
             "serve.step")

    def __init__(self, config: dict, mix: dict, seed: int, device,
                 overrides: Optional[dict] = None):
        self.config, self.mix, self.seed = config, mix, int(seed)
        self.device = torch.device(device)
        self.overrides = dict(overrides or {})
        self.graph0 = None
        self._counts: list = []
        self._opened: dict = {}

    # ---- inputs and set-up ----------------------------------------------
    def make_inputs(self, gen: torch.Generator,
                    min_free: int = 0) -> inputs.Graph:
        """The configuration's graph on the card; a copy waits on the
        host for the reference."""
        graph = inputs.rmat_graph(self.config["graph"], gen, self.device,
                                  min_free=min_free)
        self.graph0 = inputs.Graph(graph.src.cpu(), graph.dst.cpu(),
                                   graph.valid.cpu(), graph.num_vertices,
                                   graph.num_edges)
        self._graph = graph
        return graph

    def build(self) -> None:
        from repro_torch.graph.structure import EdgeListGraph
        from repro_torch.ppr import IndexConfig
        from repro_torch.serve import (IngestQueue, QueryClient, RankStore,
                                       ServeEngine, ServeMetrics)
        graph, self._graph = self._graph, None
        dev = self.device
        flush = int(self.mix["batch_events"])
        cfg = self.config
        self.graph = EdgeListGraph(
            src=graph.src, dst=graph.dst, valid=graph.valid,
            num_vertices=graph.num_vertices,
            num_edges=torch.full((), graph.num_edges, dtype=torch.int32,
                                 device=dev))
        ppr = cfg.get("ppr_index")
        index = (None if ppr is None else IndexConfig(
            num_walks=int(ppr["num_walks"]), max_len=int(ppr["max_len"]),
            alpha=float(ppr["alpha"]), seed=self.seed))
        self.ingest = IngestQueue(flush_size=flush, flush_interval=1e9,
                                  max_pending=flush, device=dev)
        self.store = RankStore()
        self.metrics = ServeMetrics()
        # the engine sizes and tunes itself at bootstrap (the tuner's
        # cache is $REPRO_TORCH_TUNE_CACHE); only a control overrides
        self.engine = ServeEngine(
            self.graph, self.ingest, self.store, metrics=self.metrics,
            method=cfg["engine"]["method"], engine=cfg["engine"]["engine"],
            kernel_opts=self.overrides, ppr_index=index,
            **{k: float(cfg["solver"][k])
               for k in ("alpha", "tol", "frontier_tol", "prune_tol")})
        self.client = QueryClient(self.store, self.ingest, self.metrics)

    def bootstrap(self) -> str:
        """Publish generation 0; the graph, and the kernel geometry the
        engine picked, for the log."""
        self.engine.bootstrap()
        g0 = self.graph0
        line = (f"graph: |V|={g0.num_vertices:,} |E|={g0.num_edges:,} "
                f"slots={g0.src.shape[0]:,}; ")
        g, info = self.engine.kernel_geometry, self.engine.tune_info
        if g is None:
            return line + "no kernel geometry"
        return line + (
            f"kernel geometry be={g.be} vb={g.vb}, spill lanes "
            f"{g.spill_lanes_per_window} "
            f"({'fixed' if info is None else info.source}), overlay "
            f"{self.engine.packed.overlay_capacity}")

    # ---- what a loop drives ---------------------------------------------
    def submit(self, dels: list, ins: list) -> None:
        q = self.ingest
        for u, v in dels:
            q.submit_delete(u, v)
        for u, v in ins:
            q.submit_insert(u, v)

    def step(self) -> None:
        m = self.metrics
        before = (m.static_fallbacks, m.packed_rebuilds)
        if not self.engine.step(force=True):
            raise RuntimeError("the engine found no batch to apply")
        self._counts.append((m.static_fallbacks - before[0],
                             m.packed_rebuilds - before[1]))

    def query(self, vertex: int, k: int) -> Answer:
        r = self.client.personalized_top_k([int(vertex)], k, mode="index")
        return Answer(r.vertices.tolist(), r.ranks.tolist(), r.generation)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- around the window ----------------------------------------------
    def tracer(self):
        from repro_torch.obs import trace
        return trace

    def window_opened(self) -> None:
        m = self.metrics
        self._opened = dict(rebuilds=m.packed_rebuilds,
                            walks=m.walks_resampled)

    def window_record(self, result: dict) -> tuple:
        """Each window batch's counters into its record; the record's
        further fields; a line for the log."""
        m = self.metrics
        nb = len(result["batches"])
        first = len(m.update_latency_s) - nb
        for i, b in enumerate(result["batches"]):
            j = first + i
            b.update(fallback=self._counts[j][0], repacks=self._counts[j][1],
                     iterations=m.batch_iterations[j],
                     host_syncs=m.batch_host_syncs[j],
                     affected=m.batch_affected[j])
        rebuilds = m.packed_rebuilds - self._opened["rebuilds"]
        walks = (m.walks_resampled - self._opened["walks"]
                 if self.config.get("ppr_index") else None)
        extra = dict(walks_resampled=walks, repacks=rebuilds)
        affected = [b["affected"] for b in result["batches"]]
        line = (f"{sum(b['fallback'] for b in result['batches'])} static "
                f"fallbacks, mean affected "
                f"{float(np.mean(affected)) if nb else 0:,.0f}, "
                f"packed_rebuilds in the window {rebuilds}, before it "
                f"{self._opened['rebuilds']}")
        return extra, line

    def outputs(self) -> dict:
        """What the window produced, for the judge: the last snapshot's
        graph, ranks and walk index (None without one)."""
        snap = self.store.snapshot()
        index = snap.ppr_index
        return dict(src=snap.graph.src, dst=snap.graph.dst,
                    valid=snap.graph.valid, ranks=snap.ranks,
                    generation=snap.generation,
                    walks=None if index is None else index.steps)

    def close(self) -> None:
        self.engine.close()
        self.engine = self.client = self.store = self.graph = None

    # ---- the judgement --------------------------------------------------
    def judge(self, plan, result: dict, outputs: dict,
              control: str = "") -> dict:
        return judge.judge(self.config, self.mix, self.graph0, plan.feed,
                           result, outputs, self.seed, self.device,
                           control=control)
