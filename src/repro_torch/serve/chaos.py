"""Chaos harness for the replication tier: seeded faults, provable
recovery (twin of ``repro.serve.chaos``).

Three pieces, all deterministic under a seed + logical clock:

* ``FaultyTransport``: the in-process wire between the writer and its
  replicas.  Every message independently risks **drop**, **duplicate**,
  **reorder** (extra random delay) and constant **delay**; nodes can be
  **partitioned** (data-plane messages vanish, control-plane calls raise
  ``LinkDown``) or **down** (process death).  Its draws come from one
  seeded ``np.random.Generator`` in the reference's order, so one seed
  gives the same faults in both packages.

* ``parse_schedule``: declarative fault injection keyed to *event
  offsets*::

      partition:r1@300+200;kill:r0@600+200;kill_writer@900;delay:r1@50+100

  grammar ``kind[:target]@at[+duration]`` with kinds ``kill`` (restarted
  as a late joiner after ``duration``), ``partition`` (healed after
  ``duration``), ``delay`` and ``kill_writer`` (heartbeat failover).

* ``ChaosHarness``: drives a ``ServeEngine`` writer + N ``ReadReplica``s
  over a seeded event feed on a logical clock, applies the schedule,
  fails over through ``FailoverController`` (rewinding the feed cursor to
  the promoted frontier, so no committed event is skipped), and asserts
  writer parity (L∞ ≤ ``parity_tol``) after every recovery point and at
  the end.  ``device=`` places writer and replicas (default: the card);
  engine keywords (``engine="kernel"``, ``iteration_budget=``, ...) pass
  through to the writer's ``ServeEngine``.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import Counter
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, note_host_syncs, resolve_device
from repro_torch.ft.elastic import ReplicaRoster
from repro_torch.graph.generators import rmat_edges
from repro_torch.graph.partition import host_array
from repro_torch.graph.structure import from_coo
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.ingest import IngestQueue
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.replicate import FailoverController, ReadReplica, \
    ReplicationWriter
from repro_torch.serve.state import RankStore

__all__ = ["ChaosAction", "ChaosHarness", "ChaosReport", "FaultyTransport",
           "LinkDown", "LogicalClock", "parse_schedule"]


class LinkDown(RuntimeError):
    """Control-plane call across a partition / to a dead node."""


class LogicalClock:
    """Injected monotone clock: ``clock()`` reads, ``advance`` moves."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t


class FaultyTransport:
    """Seeded fault-injectable in-process message fabric."""

    def __init__(self, seed: int = 0, drop_p: float = 0.0,
                 dup_p: float = 0.0, reorder_p: float = 0.0,
                 reorder_window: float = 0.2, delay: float = 0.0):
        self.rng = np.random.default_rng(seed)
        self.drop_p = float(drop_p)
        self.dup_p = float(dup_p)
        self.reorder_p = float(reorder_p)
        self.reorder_window = float(reorder_window)
        self.delay = float(delay)
        self._inbox: Dict[str, list] = {}   # heap of (due, n, msg)
        self._n = 0
        self.partitioned: set = set()
        self.down: set = set()
        self.extra_delay: Dict[str, float] = {}
        self.writer_obj: Optional[ReplicationWriter] = None
        self.dropped = 0
        self.duplicated = 0
        self.reordered = 0
        self.delivered = 0

    # -- membership --
    def register(self, name: str) -> None:
        self._inbox.setdefault(name, [])

    def unregister(self, name: str) -> None:
        self._inbox.pop(name, None)
        self.down.discard(name)
        self.partitioned.discard(name)

    def set_writer(self, writer: ReplicationWriter) -> None:
        self.writer_obj = writer

    # -- fault controls --
    def partition(self, name: str) -> None:
        self.partitioned.add(name)

    def heal(self, name: str) -> None:
        self.partitioned.discard(name)

    def kill(self, name: str) -> None:
        """Process death: node unreachable AND its inbox is lost."""
        self.down.add(name)
        self._inbox[name] = []

    def revive(self, name: str) -> None:
        self.down.discard(name)

    def link_up(self, a: str, b: str) -> bool:
        return not ({a, b} & self.partitioned or {a, b} & self.down)

    # -- data plane --
    def _push(self, src: str, dst: str, msg, now: float) -> None:
        if not self.link_up(src, dst):
            self.dropped += 1
            return
        copies = 1
        if self.dup_p and self.rng.random() < self.dup_p:
            copies = 2
            self.duplicated += 1
        for _ in range(copies):
            due = now + self.delay + self.extra_delay.get(dst, 0.0) \
                + self.extra_delay.get(src, 0.0)
            if self.drop_p and self.rng.random() < self.drop_p:
                self.dropped += 1
                continue
            if self.reorder_p and self.rng.random() < self.reorder_p:
                due += float(self.rng.uniform(0.0, self.reorder_window))
                self.reordered += 1
            self._n += 1
            heapq.heappush(self._inbox[dst], (due, self._n, msg))

    def broadcast(self, src: str, msg, now: float) -> None:
        for dst in self._inbox:
            if dst != src:
                self._push(src, dst, msg, now)

    def send(self, src: str, dst: str, msg, now: float) -> None:
        if dst in self._inbox:
            self._push(src, dst, msg, now)

    def deliver(self, dst: str, now: float) -> list:
        """Due messages for ``dst``, in due order.  A down node gets
        nothing (its process isn't running)."""
        if dst in self.down:
            return []
        box = self._inbox.get(dst, [])
        out = []
        while box and box[0][0] <= now:
            out.append(heapq.heappop(box)[2])
        self.delivered += len(out)
        return out

    # -- control plane --
    def writer_for(self, caller: str) -> ReplicationWriter:
        """The current writer, as an RPC: raises ``LinkDown`` across a
        partition or when the writer process is dead."""
        w = self.writer_obj
        if w is None or not w.alive:
            raise LinkDown(f"{caller}: writer is down")
        if not self.link_up(caller, w.name):
            raise LinkDown(f"{caller}: link to {w.name} is partitioned")
        return w


# ---- declarative schedule ------------------------------------------------

_KINDS = ("kill", "restart", "partition", "delay", "kill_writer")


class ChaosAction(NamedTuple):
    kind: str                 # one of _KINDS
    target: Optional[str]     # replica name; None for kill_writer
    at: int                   # event offset the fault fires at
    duration: Optional[int]   # offsets until heal/restart; None = forever


def parse_schedule(spec: str) -> List[ChaosAction]:
    """``kind[:target]@at[+duration]`` terms, semicolon-separated."""
    actions = []
    for term in filter(None, (t.strip() for t in spec.split(";"))):
        head, _, when = term.partition("@")
        if not when:
            raise ValueError(f"chaos term {term!r}: missing '@offset'")
        kind, _, target = head.partition(":")
        if kind not in _KINDS:
            raise ValueError(f"chaos term {term!r}: unknown kind {kind!r} "
                             f"(options {_KINDS})")
        if kind == "kill_writer" and target:
            raise ValueError(f"chaos term {term!r}: kill_writer takes no "
                             "target")
        if kind != "kill_writer" and not target:
            raise ValueError(f"chaos term {term!r}: {kind} needs a target")
        at, _, dur = when.partition("+")
        actions.append(ChaosAction(kind, target or None, int(at),
                                   int(dur) if dur else None))
    return sorted(actions, key=lambda a: a.at)


# ---- harness -------------------------------------------------------------

@dataclasses.dataclass
class ChaosReport:
    events_fed: int = 0
    generations: int = 0
    failovers: int = 0
    resyncs: int = 0
    parity_checks: int = 0
    parity_max_linf: float = 0.0
    max_staleness: int = 0
    degraded_spells: int = 0
    incidents: Counter = dataclasses.field(default_factory=Counter)
    transport: dict = dataclasses.field(default_factory=dict)

    def lines(self) -> List[str]:
        out = [f"events_fed={self.events_fed} generations="
               f"{self.generations} failovers={self.failovers} "
               f"resyncs={self.resyncs}",
               f"parity: checks={self.parity_checks} "
               f"max_linf={self.parity_max_linf:.3e}",
               f"staleness: max={self.max_staleness} "
               f"degraded_spells={self.degraded_spells}"]
        for kind, n in sorted(self.incidents.items()):
            out.append(f"incident {kind} x{n}")
        out.append("transport " + " ".join(
            f"{k}={v}" for k, v in sorted(self.transport.items())))
        return out


class ChaosHarness:
    """Deterministic writer + replicas + schedule + parity assertions.

    ``edges``: a prebuilt edge list over ``2**scale`` vertices, unique
    pairs in ``rmat_edges``' order, in place of the harness's own
    ``rmat_edges(scale, edge_factor, seed)`` draw: a caller that already
    holds that draw passes it to skip the host generation and the
    graph's deduplication (minutes of host NumPy at 2**21).  ``writers``
    lists every writer the run had, in epoch order (their hooks'
    timings are kept there).
    """

    def __init__(self, num_replicas: int = 2, events: int = 1200,
                 schedule: str = "", seed: int = 0,
                 scale: int = 9, edge_factor: int = 8,
                 flush_size: int = 16, step_every: int = 16,
                 hb_every: int = 8, dt: float = 0.01,
                 drop_p: float = 0.0, dup_p: float = 0.0,
                 reorder_p: float = 0.0,
                 staleness_slo_events: int = 256,
                 heartbeat_timeout: float = 0.5,
                 anchor_every: int = 8, ckpt_every: int = 8,
                 ckpt_dir: Optional[str] = None,
                 parity_tol: float = 1e-6, method: str = "frontier_prune",
                 slo_windows=((2.0, 2.0),), slo_min_events: int = 8,
                 max_retries: int = 3, backoff_base: float = 0.02,
                 verbose: bool = False, device: DeviceLike = None,
                 edges: Optional[np.ndarray] = None, **engine_kw):
        self.device = resolve_device(device)
        self.clock = LogicalClock()
        self.parity_tol = float(parity_tol)
        self.step_every = step_every
        self.hb_every = hb_every
        self.dt = float(dt)
        self.verbose = verbose
        self.report = ChaosReport()
        rng = np.random.default_rng(seed)
        drawn = edges is None
        if drawn:
            edges, self.n = rmat_edges(scale, edge_factor, seed=seed)
        else:
            self.n = 1 << scale
        cap = len(edges) + 4 * events
        # rmat_edges' pairs are unique and sorted, as from_coo's
        # deduplication leaves them: a given draw skips that sort
        self.base_graph = from_coo(edges[:, 0], edges[:, 1], self.n,
                                   edge_capacity=cap, dedup=drawn,
                                   device=self.device)
        # seeded feed: mostly inserts, some deletes of earlier inserts
        self.events: List[tuple] = []
        live: List[tuple] = []
        while len(self.events) < events:
            if live and rng.random() < 0.15:
                self.events.append(("delete",) + live.pop(
                    int(rng.integers(len(live)))))
            else:
                u, v = (int(x) for x in rng.integers(0, self.n, size=2))
                if u == v:
                    continue
                self.events.append(("insert", u, v))
                live.append((u, v))
        self.transport = FaultyTransport(
            seed=seed + 1, drop_p=drop_p, dup_p=dup_p, reorder_p=reorder_p,
            reorder_window=4 * dt, delay=0.0)
        self.roster = ReplicaRoster(heartbeat_timeout=heartbeat_timeout)
        self._mk_replica = lambda name: ReadReplica(
            name, self.transport, self.n, roster=self.roster,
            staleness_slo_events=staleness_slo_events,
            max_retries=max_retries, backoff_base=backoff_base,
            slo_windows=slo_windows, slo_min_events=slo_min_events,
            seed=seed, clock=self.clock, device=self.device)
        self._engine_kw = dict(method=method, **engine_kw)
        self._flush_size = flush_size
        self._ckpt_dir = ckpt_dir
        self._ckpt_every = ckpt_every
        engine = self._engine_factory(self.base_graph, last_seq=-1,
                                      generation=0)
        engine.bootstrap()
        self.writer = ReplicationWriter(
            engine, self.transport, epoch=0, anchor_every=anchor_every,
            clock=self.clock)
        self.writer.attach()
        self.writers = [self.writer]
        self.transport.set_writer(self.writer)
        self.writer.heartbeat(self.roster)
        self.controller = FailoverController(
            self.transport, self.roster, self._engine_factory,
            ckpt_dir=ckpt_dir, num_vertices=self.n,
            rebuild_graph=self._graph_at, clock=self.clock,
            device=self.device)
        self.replicas: List[ReadReplica] = []
        self.all_replicas: List[ReadReplica] = []
        for i in range(num_replicas):
            r = self._mk_replica(f"r{i}")
            assert r.bootstrap(), "bootstrap against a healthy writer"
            self.replicas.append(r)
            self.all_replicas.append(r)
        self.schedule = parse_schedule(schedule) if schedule else []
        self._fired: set = set()
        # expand durations into an offset -> [op] timeline
        self.timeline: Dict[int, List[tuple]] = {}
        for a in self.schedule:
            self.timeline.setdefault(a.at, []).append(("open", a))
            if a.duration is not None:
                self.timeline.setdefault(a.at + a.duration, []).append(
                    ("close", a))

    # -- construction helpers --
    def _engine_factory(self, graph, last_seq: int,
                        generation: int) -> ServeEngine:
        ingest = IngestQueue(flush_size=self._flush_size,
                             flush_interval=0.0,
                             max_pending=1 << 20,
                             start_seq=last_seq + 1, clock=self.clock,
                             device=self.device)
        store = RankStore(ckpt_dir=self._ckpt_dir,
                          ckpt_every=self._ckpt_every)
        return ServeEngine(graph, ingest, store, metrics=ServeMetrics(),
                           clock=self.clock, **self._engine_kw)

    def _graph_at(self, last_seq: int):
        """Graph with events[0..last_seq] applied (the event feed is the
        graph's log: the checkpoint-ahead failover path), slot for slot
        the reference's: host NumPy and a dict over every live edge."""
        g = self.base_graph
        src = host_array(g.src).copy()
        dst = host_array(g.dst).copy()
        valid = host_array(g.valid).copy()
        n_edges = int(host_array(g.num_edges))
        pos = {}
        for i in range(n_edges):
            if valid[i]:
                pos[(int(src[i]), int(dst[i]))] = i
        for kind, u, v in self.events[: last_seq + 1]:
            if kind == "insert":
                if (u, v) not in pos:
                    src[n_edges], dst[n_edges] = u, v
                    valid[n_edges] = True
                    pos[(u, v)] = n_edges
                    n_edges += 1
            else:
                i = pos.pop((u, v), None)
                if i is not None:
                    valid[i] = False

        def up(a):
            note_host_syncs()              # an upload from pageable memory
            return torch.from_numpy(a).to(self.device)
        return dataclasses.replace(
            g, src=up(src), dst=up(dst), valid=up(valid),
            num_edges=torch.tensor(n_edges, dtype=torch.int32,
                                   device=self.device))

    # -- chaos ops --
    def _apply_ops(self, offset: int) -> bool:
        """Fire due chaos ops; True if a recovery point occurred.  Each op
        fires at most once: a failover rewinds the feed cursor over
        already-passed offsets, and a re-fired fault would model a
        periodic fault, not the scheduled one-shot."""
        recovered = False
        for phase, a in self.timeline.get(offset, ()):  # in spec order
            if (phase, a) in self._fired:
                continue
            self._fired.add((phase, a))
            opening = phase == "open"
            if a.kind == "kill_writer" and opening:
                self.writer.kill()
                self._log(f"@{offset} chaos: kill_writer "
                          f"(epoch {self.writer.epoch})")
            elif a.kind == "partition":
                if opening:
                    self.transport.partition(a.target)
                    self._log(f"@{offset} chaos: partition {a.target}")
                else:
                    self.transport.heal(a.target)
                    self._log(f"@{offset} chaos: heal {a.target}")
                    recovered = True
            elif a.kind == "delay":
                self.transport.extra_delay[a.target] = \
                    8 * self.dt if opening else 0.0
                self._log(f"@{offset} chaos: delay {a.target} "
                          f"{'on' if opening else 'off'}")
                recovered = recovered or not opening
            elif a.kind in ("kill", "restart"):
                if opening and a.kind == "kill":
                    self._kill_replica(a.target)
                    self._log(f"@{offset} chaos: kill {a.target}")
                else:
                    self._restart_replica(a.target)
                    self._log(f"@{offset} chaos: restart {a.target}")
                    recovered = True
        return recovered

    def _kill_replica(self, name: str) -> None:
        self.transport.kill(name)
        for r in self.replicas:
            if r.name == name:
                r.leave()
        self.replicas = [r for r in self.replicas if r.name != name]

    def _restart_replica(self, name: str) -> None:
        self.transport.revive(name)
        r = self._mk_replica(name)     # fresh process: late joiner
        r.bootstrap()
        self.replicas.append(r)
        self.all_replicas.append(r)

    # -- main loop --
    def _maybe_failover(self, cursor: int) -> Optional[int]:
        """Heartbeat + failover check; returns the rewound feed cursor (no
        committed event skipped) when a promotion happened."""
        self.writer.heartbeat(self.roster)
        promoted = self.controller.check(self.writer, self.replicas)
        if promoted is None:
            return None
        new_writer, promoted_replica = promoted
        self._log(f"@{cursor} failover: epoch {self.writer.epoch} -> "
                  f"{new_writer.epoch}, feed resumes at seq "
                  f"{new_writer.engine.ingest.start_seq}")
        if promoted_replica is not None:
            self.replicas = [r for r in self.replicas
                             if r is not promoted_replica]
            self.transport.unregister(promoted_replica.name)
        self.writer = new_writer
        self.writers.append(new_writer)
        self.transport.set_writer(new_writer)
        return new_writer.engine.ingest.start_seq

    def run(self) -> ChaosReport:
        cursor = 0
        since_step = since_hb = 0
        while cursor < len(self.events):
            self.clock.advance(self.dt)
            recovered = self._apply_ops(cursor)
            kind, u, v = self.events[cursor]
            ingest = self.writer.engine.ingest
            assert ingest.submit(kind, u, v) == cursor, \
                "harness feed must map offsets 1:1 onto ingest seqs"
            cursor += 1
            since_step += 1
            since_hb += 1
            if since_step >= self.step_every:
                since_step = 0
                if self.writer.alive:
                    self.writer.engine.step(force=True)
            if since_hb >= self.hb_every:
                since_hb = 0
                rewound = self._maybe_failover(cursor)
                if rewound is not None:
                    cursor = rewound
                    recovered = True
            for r in self.replicas:
                r.pump()
                self.report.max_staleness = max(self.report.max_staleness,
                                                r.staleness)
            if recovered:
                self._converge_and_check_parity()
        # a writer killed inside the last heartbeat interval still fails
        # over (and the feed tail beyond the promoted frontier re-feeds)
        if not self.writer.alive:
            rewound = self._maybe_failover(cursor)
            if rewound is not None and rewound < len(self.events):
                for seq in range(rewound, len(self.events)):
                    kind, u, v = self.events[seq]
                    assert self.writer.engine.ingest.submit(
                        kind, u, v) == seq
        if self.writer.alive:
            self.writer.engine.step(force=True)
        self._converge_and_check_parity()
        return self._finalize()

    # -- parity --
    def _converge_and_check_parity(self, max_rounds: int = 400) -> None:
        """Quiesce the stream, then L∞-compare every alive replica at the
        writer's generation against the writer's ranks (on the device,
        one read a replica)."""
        w = self.writer
        while w.engine.ingest.pending():
            w.engine.step(force=True)
        target = w.next_seq - 1
        for _ in range(max_rounds):
            # advance past any backoff/delay so retries actually fire
            self.clock.advance(max(self.dt, 0.05))
            w.heartbeat(self.roster)
            live = [r for r in self.replicas
                    if r.name not in self.transport.down
                    and r.name not in self.transport.partitioned]
            for r in live:
                r.pump()
            if all(r.epoch == w.epoch and r.applied_seq >= target
                   for r in live):
                break
        else:
            raise AssertionError(
                f"replicas failed to reconverge to seq {target}: "
                + ", ".join(f"{r.name}@{r.epoch}/{r.applied_seq}"
                            for r in self.replicas))
        wr = w.engine.store.snapshot().ranks
        wgen = w.engine.store.generation
        for r in live:
            assert r.generation == wgen, \
                f"{r.name} at gen {r.generation}, writer at {wgen}"
            note_host_syncs()
            linf = (float((r.ranks - wr).abs().max()) if len(wr)
                    else 0.0)
            self.report.parity_max_linf = max(self.report.parity_max_linf,
                                              linf)
            assert linf <= self.parity_tol, \
                f"{r.name} diverged: L∞={linf:.3e} at gen {wgen}"
        self.report.parity_checks += 1
        self._log(f"parity OK at gen {wgen} "
                  f"(checks={self.report.parity_checks}, "
                  f"L∞max={self.report.parity_max_linf:.2e})")

    def _finalize(self) -> ChaosReport:
        rep = self.report
        rep.events_fed = len(self.events)
        rep.generations = self.writer.engine.store.generation
        rep.failovers = self.controller.failovers
        for src in list(self.replicas) + [self.controller]:
            for inc in src.incidents:
                rep.incidents[inc.kind] += 1
        rep.resyncs = sum(r.resyncs for r in self.replicas)
        rep.degraded_spells = rep.incidents.get("replica_degraded", 0)
        rep.transport = dict(
            dropped=self.transport.dropped,
            duplicated=self.transport.duplicated,
            reordered=self.transport.reordered,
            delivered=self.transport.delivered)
        return rep

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(f"[chaos t={self.clock.t:8.2f}] {msg}", flush=True)
