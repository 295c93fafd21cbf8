"""Read-replica replication: one writer, N replicas, bounded staleness
(twin of ``repro.serve.replicate``).

The paper's DF-P property (a batch update perturbs only the affected
vertex set) makes a published generation differ from its predecessor by
a small sparse rank delta, which is what makes this tier cheap: the
writer (a ``ServeEngine``, hooked through ``on_publish``) emits one
generation-stamped ``DeltaMsg`` per publish carrying

  * the exact sparse rank delta: the indices where the new f64 rank
    vector differs from the previous one (``!=``: NaN always differs,
    -0.0 equals 0.0), and the new values;
  * the coalesced ``BatchUpdate`` leaves (host copies), so replicas keep
    their own graph with the same ``apply_batch`` the writer ran;
  * the wire header: ``epoch`` (bumps on writer failover), ``seq``
    (contiguous per epoch from 0), ``generation`` and ``last_seq``.

The wire format is the reference's, field for field and dtype for dtype
(host NumPy: ``rank_idx`` int64, ``rank_val`` f64, the update leaves
int32/bool, anchors in the flight recorder's ``ranks`` + ``graph_*``
layout), so a message of either package applies in the other once it is
wrapped in that package's message type (``DeltaMsg(*msg)``).

On the device: the writer keeps the previous rank vector on the card,
diffs there and copies back only the changed indices and values (two host
syncs: the selection's size and one stacked copy; the update leaves come
back by non-blocking copies behind them).  The hook runs inside
``ServeEngine.step``, so these reads are the batch's and are recorded
with ``device.note_host_syncs``.  An anchor is one stacked device copy of
ranks and graph (one sync).  A replica keeps its ranks on its device and
publishes a new tensor for every delta (clone, then scatter): a snapshot a
reader holds never changes.

PPR replication rides the same stream: walk sampling is a pure function
of (graph, config seed), so a replica configured with the writer's
``IndexConfig`` repairs its index from each delta's touched set and stays
bit-identical to the writer's with no walk data on the wire.  Anchors
carry the writer's index identity (statics + base key, the two threefry
words of ``ppr.threefry.prng_key``, equal to ``jax.random.PRNGKey``'s): a
resyncing replica whose live index matches heals by repairing the walks
that cross the edge slots the anchor graph rewrote, not by a rebuild.

Fault tolerance: gap detection with bounded-retry retransmission
(exponential backoff + deterministic jitter), then an anchor resync;
heartbeat failover (``FailoverController``) promoting the freshest of the
alive replicas and the last committed ``RankStore`` checkpoint; graceful
degradation with an ``obs.slo.SloTracker`` on staleness.  Transport and
clock are injected (``serve.chaos.FaultyTransport``, ``LogicalClock``), so
every retry, backoff and failover decision is deterministic.
"""
from __future__ import annotations

import time
import zlib
from collections import deque
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, note_host_syncs, resolve_device
from repro_torch.ft.elastic import ReplicaRoster, rescale_serving_state
from repro_torch.graph.dynamic import BatchUpdate, apply_batch, \
    touched_vertices_mask
from repro_torch.graph.structure import EdgeListGraph
from repro_torch.obs.recorder import stage_update
from repro_torch.obs.sentinel import WARN, Incident
from repro_torch.obs.slo import SloTracker
from repro_torch.ppr import IndexConfig, build_walk_index, \
    repair_walk_index, threefry
from repro_torch.serve.query import QueryClient, QueryResult
from repro_torch.serve.state import RankStore

__all__ = [
    "AnchorMsg", "DeltaMsg", "FailoverController", "Heartbeat",
    "ReadReplica", "ReplicaDegradedError", "ReplicaQueryClient",
    "ReplicationWriter",
]


# ---- wire format ---------------------------------------------------------

class DeltaMsg(NamedTuple):
    """One publish, as shipped: sparse rank delta + the update itself."""
    epoch: int           # writer incarnation; bumps on failover
    seq: int             # contiguous per epoch, from 0
    generation: int      # snapshot generation this delta produces
    last_seq: int        # newest ingest event folded into `generation`
    rank_idx: np.ndarray  # int64[k] vertices whose rank changed
    rank_val: np.ndarray  # f64[k] their new ranks (exact, bitwise)
    update: Dict[str, np.ndarray]   # BatchUpdate leaves, host copies


class AnchorMsg(NamedTuple):
    """Full state at a generation, flight-recorder anchor format."""
    epoch: int
    seq: int             # deltas <= seq are folded in (-1: none yet)
    generation: int
    last_seq: int
    state: Dict[str, np.ndarray]   # ranks + graph_* (obs/recorder.py)
    # walk-index identity of the writer's index at this generation
    # (num_walks/max_len/alpha/key); None when the writer serves no PPR
    ppr: Optional[Dict] = None


class Heartbeat(NamedTuple):
    epoch: int
    seq: int             # last delta seq emitted this epoch (-1: none)
    generation: int
    latest_seq: int      # writer ingest frontier (staleness reference)
    t: float


_U8 = torch.uint8
# timings kept for the newest this many events (a bounded history)
TIMINGS_KEPT = 1024


def _anchor_state(graph: EdgeListGraph, ranks: torch.Tensor
                  ) -> Dict[str, np.ndarray]:
    """Host anchor, the leaves of ``FlightRecorder.record_anchor``: ranks
    and graph bytes stacked on the device and copied back in one read
    (one host sync), then split into typed views."""
    V, E = ranks.shape[0], graph.src.shape[0]
    parts = [ranks.to(torch.float64), graph.src, graph.dst,
             graph.num_edges.reshape(1), graph.valid]
    note_host_syncs()
    buf = torch.cat([p.contiguous().view(_U8) for p in parts]).cpu().numpy()
    o = [0, 8 * V, 8 * V + 4 * E, 8 * V + 8 * E, 8 * V + 8 * E + 4]
    return dict(
        ranks=buf[o[0]:o[1]].view(np.float64),
        graph_src=buf[o[1]:o[2]].view(np.int32),
        graph_dst=buf[o[2]:o[3]].view(np.int32),
        graph_valid=buf[o[4]:].view(np.bool_),
        graph_num_edges=buf[o[3]:o[4]].view(np.int32).reshape(()),
    )


def _upload(a: np.ndarray, dtype, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``: an upload from pageable
    memory (a recorded host sync)."""
    a = np.asarray(a, dtype=dtype)
    if not a.flags.writeable:      # another framework's read-only buffer
        a = a.copy()
    note_host_syncs()
    return torch.from_numpy(a).to(device)


def _graph_from_anchor(state: Dict[str, np.ndarray], num_vertices: int,
                       device: torch.device) -> EdgeListGraph:
    return EdgeListGraph(
        src=_upload(state["graph_src"], np.int32, device),
        dst=_upload(state["graph_dst"], np.int32, device),
        valid=_upload(state["graph_valid"], np.bool_, device),
        num_vertices=num_vertices,
        num_edges=_upload(state["graph_num_edges"], np.int32, device))


def _update_from_wire(update: Dict[str, np.ndarray],
                      device: torch.device) -> BatchUpdate:
    dtypes = dict(del_mask=np.bool_, ins_mask=np.bool_)
    return BatchUpdate(**{f: _upload(update[f], dtypes.get(f, np.int32),
                                     device)
                          for f in BatchUpdate._fields})


def _ppr_identity(index) -> Optional[Dict]:
    """Wire-format identity of a walk index (``WalkIndex`` or
    ``ShardedWalkIndex``): the statics plus the base PRNG key, everything
    that determines the walks besides the graph."""
    if index is None:
        return None
    return dict(num_walks=int(index.num_walks),
                max_len=int(index.max_len),
                alpha=float(index.alpha),
                key=[int(x) for x in index.key])


def _edge_diff_touched(old: EdgeListGraph, new: EdgeListGraph,
                       num_vertices: int) -> torch.Tensor:
    """bool[V]: src endpoints of every edge slot that differs between the
    two edge lists: a superset of the union of the missed deltas'
    ``touched_vertices_mask``es, which keeps walk repair bitwise equal to
    a fresh rebuild.  An OR by ``amax`` (order-free), no host read."""
    diff = ((old.src != new.src) | (old.dst != new.dst)
            | (old.valid != new.valid))
    m = torch.zeros(num_vertices, dtype=torch.int32, device=new.src.device)
    for g in (old, new):
        hit = diff & g.valid
        m.scatter_reduce_(0, torch.where(hit, g.src, 0).long(),
                          hit.to(torch.int32), "amax")
    return m.bool()


# ---- writer side ---------------------------------------------------------

class ReplicationWriter:
    """Hooks a bootstrapped ``ServeEngine``; emits deltas + anchors.

    ``attach`` assigns ``engine.on_publish`` and keeps the previous rank
    vector (on the engine's device) for the exact diff.  A bounded delta
    log (newest ``log_capacity`` entries) serves retransmit requests and
    late-joiner tails; anything older answers with the newest anchor.
    ``hook_ms``, ``delta_sizes``, ``anchor_ms`` and ``anchor_bytes`` keep
    each publish's host time in the hook, its delta's length and each
    anchor's copy (the newest ``TIMINGS_KEPT``).
    """

    def __init__(self, engine, transport, name: str = "writer",
                 epoch: int = 0, anchor_every: int = 32,
                 log_capacity: int = 512, clock=time.monotonic):
        self.engine = engine
        self.transport = transport
        self.name = name
        self.epoch = int(epoch)
        self.anchor_every = int(anchor_every)
        self.log_capacity = int(log_capacity)
        self._clock = clock
        self._log: Dict[int, DeltaMsg] = {}
        self._anchor: Optional[AnchorMsg] = None
        self._prev: Optional[torch.Tensor] = None
        self.next_seq = 0
        self.alive = True
        self.deltas_emitted = 0
        self.anchors_taken = 0
        self.retransmits = 0
        self.hook_ms: deque = deque(maxlen=TIMINGS_KEPT)
        self.anchor_ms: deque = deque(maxlen=TIMINGS_KEPT)
        self.anchor_bytes: deque = deque(maxlen=TIMINGS_KEPT)
        self.delta_sizes: deque = deque(maxlen=TIMINGS_KEPT)
        transport.register(name)

    # -- lifecycle --
    def attach(self) -> None:
        """Anchor the engine's current snapshot and start emitting."""
        snap = self.engine.store.snapshot()
        self._prev = snap.ranks
        self._anchor = self._take_anchor(self.next_seq - 1, snap,
                                         snap.last_seq)
        self.engine.on_publish = self._on_publish

    def kill(self) -> None:
        """Chaos: the writer process dies mid-flight: no more deltas, no
        more heartbeats, control-plane calls fail."""
        self.alive = False
        self.engine.on_publish = None

    def _take_anchor(self, seq: int, snap, last_seq: int) -> AnchorMsg:
        t0 = time.perf_counter()
        state = _anchor_state(snap.graph, snap.ranks)
        self.anchor_ms.append((time.perf_counter() - t0) * 1e3)
        self.anchor_bytes.append(sum(a.nbytes for a in state.values()))
        self.anchors_taken += 1
        return AnchorMsg(self.epoch, seq, snap.generation, int(last_seq),
                         state, _ppr_identity(snap.ppr_index))

    # -- data plane --
    def _on_publish(self, snap, batch) -> None:
        if not self.alive:
            return
        t0 = time.perf_counter()
        new = snap.ranks
        # non-blocking copies of the update leaves, complete once the
        # reads below have waited for the stream
        staged = stage_update(batch.update)
        note_host_syncs()                  # the selection reads its size
        idx = torch.nonzero(new != self._prev).flatten()
        note_host_syncs()                  # one copy of indices + values
        both = torch.stack([idx, new[idx].to(torch.float64)
                            .view(torch.int64)]).cpu().numpy()
        upd = {f: t.numpy().copy() for f, t in staged.items()}
        msg = DeltaMsg(self.epoch, self.next_seq, snap.generation,
                       int(batch.last_seq), both[0].copy(),
                       both[1].view(np.float64).copy(), upd)
        self._prev = new
        self._log[msg.seq] = msg
        if len(self._log) > self.log_capacity:
            del self._log[min(self._log)]
        self.next_seq += 1
        self.deltas_emitted += 1
        self.delta_sizes.append(len(msg.rank_idx))
        if snap.generation % self.anchor_every == 0:
            self._anchor = self._take_anchor(msg.seq, snap, msg.last_seq)
        self.hook_ms.append((time.perf_counter() - t0) * 1e3)
        self.transport.broadcast(self.name, msg, self._clock())

    def heartbeat(self, roster: Optional[ReplicaRoster] = None) -> None:
        if not self.alive:
            return
        now = self._clock()
        if roster is not None:
            roster.beat(self.name, now)
        self.transport.broadcast(
            self.name,
            Heartbeat(self.epoch, self.next_seq - 1,
                      self.engine.store.generation,
                      self.engine.ingest.latest_seq, now),
            now)

    # -- control plane (replicas reach these through
    #    transport.writer_for; a dead writer or a partition raises there) --
    def retransmit(self, dest: str, seqs: List[int]) -> bool:
        """Re-send the requested deltas to ``dest``; False when any has
        fallen off the log (the replica must anchor-resync instead)."""
        if not all(s in self._log for s in seqs):
            return False
        now = self._clock()
        for s in seqs:
            self.transport.send(self.name, dest, self._log[s], now)
            self.retransmits += 1
        return True

    def newest_anchor(self) -> AnchorMsg:
        assert self._anchor is not None, "attach() before serving anchors"
        return self._anchor

    def delta_tail(self, after_seq: int) -> List[DeltaMsg]:
        """Logged deltas with seq > after_seq, in order (anchor resync and
        late-joiner bootstrap tail)."""
        return [self._log[s] for s in sorted(self._log) if s > after_seq]


# ---- replica side --------------------------------------------------------

class ReplicaDegradedError(RuntimeError):
    """Raised by shed query classes on a degraded replica; carries the
    current ``staleness_events`` so clients can fail over informed."""

    def __init__(self, message: str, staleness_events: int):
        super().__init__(message)
        self.staleness_events = staleness_events


class ReadReplica:
    """Applies the delta stream; answers queries; degrades, never dies.

    Deltas apply strictly in seq order.  Out-of-order arrivals buffer; a
    gap opens the retry state machine: up to ``max_retries`` retransmit
    requests with exponential backoff (``backoff_base`` · 2^attempt +
    deterministic jitter), then an anchor resync.  An epoch bump (new
    writer) always resyncs.  State (graph, ranks, walk index) lives on
    ``device`` (default: the card).  ``apply_ms`` and ``resync_ms`` record
    the host time of each applied delta and each resync, the device
    work included (each ends in a read).
    """

    def __init__(self, name: str, transport, num_vertices: int,
                 roster: Optional[ReplicaRoster] = None,
                 ppr_cfg: Optional[IndexConfig] = None,
                 staleness_slo_events: int = 256,
                 shed_on_degrade: bool = True,
                 max_retries: int = 4, backoff_base: float = 0.05,
                 slo_objective: float = 0.99,
                 slo_windows=((60.0, 14.4), (300.0, 6.0)),
                 slo_min_events: int = 12,
                 seed: int = 0, clock=time.monotonic,
                 device: DeviceLike = None):
        self.name = name
        self.transport = transport
        self.num_vertices = int(num_vertices)
        self.roster = roster
        self.ppr_cfg = ppr_cfg
        self.staleness_slo_events = int(staleness_slo_events)
        self.shed_on_degrade = bool(shed_on_degrade)
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.device = resolve_device(device)
        self._clock = clock
        # deterministic per-replica jitter: seed ⊕ stable name digest
        self._rng = np.random.default_rng(
            np.uint32(seed) ^ np.uint32(zlib.crc32(name.encode())))
        self.store = RankStore()
        self.graph: Optional[EdgeListGraph] = None
        self.ranks: Optional[torch.Tensor] = None
        self.ppr = None
        self.epoch = -1          # resyncs on the first message seen
        self.applied_seq = -1    # newest contiguously-applied wire seq
        self.generation = -1
        self.last_seq = -1
        self.known_latest_seq = -1   # writer ingest frontier, via hb/deltas
        self.degraded = False
        self._buffer: Dict[int, DeltaMsg] = {}
        # gap retry state: None or dict(through, attempt, next_t)
        self._gap: Optional[dict] = None
        self.incidents: List[Incident] = []
        self.slo = SloTracker("replica_staleness", slo_objective,
                              windows=slo_windows,
                              min_events=slo_min_events, clock=clock)
        self._active_alerts: set = set()   # edge-triggered slo_burn
        self.deltas_applied = 0
        self.duplicates = 0
        self.gaps_detected = 0
        self.retries_sent = 0
        self.resyncs = 0
        self.apply_ms: deque = deque(maxlen=TIMINGS_KEPT)
        self.resync_ms: deque = deque(maxlen=TIMINGS_KEPT)
        self.heals_by_repair = 0
        self.index_builds = 0
        transport.register(name)
        if roster is not None:
            roster.join(name, clock())

    # -- bookkeeping --
    @property
    def staleness(self) -> int:
        return max(0, self.known_latest_seq - self.last_seq)

    def _incident(self, kind: str, value: float, threshold: float,
                  message: str) -> None:
        self.incidents.append(Incident(
            kind, WARN, self.generation, self.last_seq, float(value),
            float(threshold), message, self._clock()))

    def _note_frontier(self, latest_seq: int) -> None:
        self.known_latest_seq = max(self.known_latest_seq, int(latest_seq))

    def _check_staleness(self) -> None:
        stale = self.staleness
        self.slo.record(stale <= self.staleness_slo_events)
        firing = self.slo.evaluate()
        keys = {(a.slo, a.long_window_s) for a in firing}
        for alert in firing:   # edge-triggered, like obs.slo.SloSet
            if (alert.slo, alert.long_window_s) in self._active_alerts:
                continue
            self._incident(
                "slo_burn", alert.burn_long, alert.threshold,
                f"replica {self.name} staleness SLO burning at "
                f"{alert.burn_long:.1f}x over {alert.long_window_s:g}s")
        self._active_alerts = keys
        if stale > self.staleness_slo_events and not self.degraded:
            self.degraded = True
            self._incident(
                "replica_degraded", stale, self.staleness_slo_events,
                f"replica {self.name} is {stale} events stale "
                f"(SLO {self.staleness_slo_events}); "
                + ("shedding top-k/PPR, " if self.shed_on_degrade else "")
                + "point queries keep serving with staleness metadata")
        elif stale <= self.staleness_slo_events and self.degraded:
            self.degraded = False
            self._incident(
                "replica_recovered", stale, self.staleness_slo_events,
                f"replica {self.name} back inside its staleness SLO")

    # -- the pump: one call drains the inbox and advances retries --
    def pump(self) -> int:
        """Apply every due message; returns deltas applied this call."""
        now = self._clock()
        if self.roster is not None:
            self.roster.beat(self.name, now)
        applied = 0
        for msg in self.transport.deliver(self.name, now):
            if isinstance(msg, Heartbeat):
                self._on_heartbeat(msg)
            elif isinstance(msg, DeltaMsg):
                applied += self._on_delta(msg)
        applied += self._drain_buffer()
        self._advance_gap(now)
        self._check_staleness()
        return applied

    def _on_heartbeat(self, hb: Heartbeat) -> None:
        if hb.epoch > self.epoch:
            self._resync("new writer epoch")
            return
        if hb.epoch < self.epoch:
            return               # stale incarnation still in the pipe
        self._note_frontier(hb.latest_seq)
        # tail-gap detection: the writer is ahead and nothing newer is in
        # flight for us; the missing deltas were dropped outright
        if hb.seq > self.applied_seq and self._gap is None \
                and not self._buffer:
            self._open_gap(hb.seq)

    def _on_delta(self, msg: DeltaMsg) -> int:
        if msg.epoch > self.epoch:
            self._resync("new writer epoch")
            return 0
        if msg.epoch < self.epoch or msg.seq <= self.applied_seq:
            self.duplicates += 1
            return 0
        if msg.seq == self.applied_seq + 1:
            self._apply(msg)
            return 1
        if msg.seq in self._buffer:
            self.duplicates += 1
            return 0
        self._buffer[msg.seq] = msg
        if self._gap is None:
            self._open_gap(msg.seq - 1)
        return 0

    def _drain_buffer(self) -> int:
        n = 0
        while (self.applied_seq + 1) in self._buffer:
            self._apply(self._buffer.pop(self.applied_seq + 1))
            n += 1
        if not self._buffer and self._gap is not None \
                and self.applied_seq >= self._gap["through"]:
            self._gap = None     # retransmits landed; gap closed
        return n

    def _apply(self, msg: DeltaMsg) -> None:
        t0 = time.perf_counter()
        upd = _update_from_wire(msg.update, self.device)
        self.graph = apply_batch(self.graph, upd)
        # a new tensor a delta: a published snapshot never changes
        ranks = self.ranks.clone()
        ranks[_upload(msg.rank_idx, np.int64, self.device)] = _upload(
            msg.rank_val, np.float64, self.device)
        self.ranks = ranks
        if self.ppr is not None:
            touched = touched_vertices_mask(upd, self.num_vertices)
            self.ppr, _ = repair_walk_index(self.ppr, self.graph, touched)
        self.applied_seq = msg.seq
        self.generation = msg.generation
        self.last_seq = msg.last_seq
        self._note_frontier(msg.last_seq)
        self.deltas_applied += 1
        self._publish()
        self._wait()
        self.apply_ms.append((time.perf_counter() - t0) * 1e3)

    def _wait(self) -> None:
        """Wait for this replica's device work (so the recorded times are
        honest): one read."""
        note_host_syncs()
        self.ranks[:1].cpu()

    def _publish(self) -> None:
        self.store.seed_generation(self.generation)
        self.store.publish(self.graph, self.ranks, self.last_seq,
                           ppr_index=self.ppr)

    # -- gap retry state machine --
    def _open_gap(self, through_seq: int) -> None:
        self.gaps_detected += 1
        self._gap = dict(through=int(through_seq), attempt=0,
                         next_t=self._clock())   # first retry immediate

    def _advance_gap(self, now: float) -> None:
        gap = self._gap
        if gap is None or now < gap["next_t"]:
            return
        if gap["attempt"] >= self.max_retries:
            self._resync(
                f"gap at seq {self.applied_seq + 1} survived "
                f"{self.max_retries} retransmit attempts")
            return
        missing = [s for s in range(self.applied_seq + 1,
                                    gap["through"] + 1)
                   if s not in self._buffer]
        if not missing:
            self._gap = None
            return
        gap["attempt"] += 1
        backoff = (self.backoff_base * (2.0 ** gap["attempt"])
                   + float(self._rng.uniform(0.0, self.backoff_base)))
        gap["next_t"] = now + backoff
        try:
            writer = self.transport.writer_for(self.name)
            self.retries_sent += 1
            if not writer.retransmit(self.name, missing):
                # fell off the writer's delta log: anchors only now
                self._resync("retransmit window expired on the writer")
        except Exception:
            # partitioned or dead writer: the attempt is spent, the
            # backoff stands; failover/heal will unblock us
            pass

    # -- anchor resync + late join --
    def _resync(self, reason: str) -> bool:
        try:
            writer = self.transport.writer_for(self.name)
            anchor = writer.newest_anchor()
            tail = writer.delta_tail(anchor.seq)
        except Exception:
            return False         # unreachable; stay on backoff/heartbeat
        t0 = time.perf_counter()
        self.resyncs += 1
        self._load_anchor(anchor)
        for msg in tail:
            if msg.seq == self.applied_seq + 1:
                self._apply(msg)
        self._gap = None
        self._wait()
        self.resync_ms.append((time.perf_counter() - t0) * 1e3)
        self._incident(
            "replica_resync", self.applied_seq, 0,
            f"replica {self.name} resynced from anchor "
            f"gen={anchor.generation} (epoch {anchor.epoch}): {reason}")
        return True

    def _ppr_identity_matches(self, ident: Optional[Dict]) -> bool:
        """Does our live index share the anchor's PRNG stream + statics?
        If so, repairing it on the anchor graph reproduces the writer's
        index bitwise (same draws, same graph)."""
        if ident is None or self.ppr is None:
            return False
        return _ppr_identity(self.ppr) == dict(
            ident, key=[int(x) for x in ident["key"]])

    def _load_anchor(self, anchor: AnchorMsg) -> None:
        old_graph = self.graph           # pre-resync graph, for the diff
        self.graph = _graph_from_anchor(anchor.state, self.num_vertices,
                                        self.device)
        self.ranks = _upload(anchor.state["ranks"], np.float64, self.device)
        self.epoch = anchor.epoch
        self.applied_seq = anchor.seq
        self.generation = anchor.generation
        self.last_seq = anchor.last_seq
        self._note_frontier(anchor.last_seq)
        self._buffer = {s: m for s, m in self._buffer.items()
                        if m.epoch == self.epoch and s > anchor.seq}
        if self.ppr_cfg is not None:
            ident = anchor.ppr
            if (old_graph is not None
                    and self._ppr_identity_matches(ident)
                    and old_graph.src.shape == self.graph.src.shape):
                # our index is valid for old_graph and on the writer's
                # PRNG stream: repair the walks that cross the edge slots
                # the missed deltas rewrote, an O(|Δ|·R·L) heal
                touched = _edge_diff_touched(old_graph, self.graph,
                                             self.num_vertices)
                self.ppr, _ = repair_walk_index(self.ppr, self.graph,
                                                touched)
                self.heals_by_repair += 1
            else:
                # cold start, config drift, or an anchor without identity:
                # a pure function of (graph, seed), still bit-identical
                self.ppr = build_walk_index(self.graph, self.ppr_cfg)
                self.index_builds += 1
        self._publish()

    def bootstrap(self) -> bool:
        """Late join: newest anchor + replayed delta tail.  False when the
        writer is unreachable (the caller retries on its own cadence)."""
        return self._resync("late joiner bootstrap")

    def leave(self) -> None:
        if self.roster is not None:
            self.roster.leave(self.name)


class ReplicaQueryClient(QueryClient):
    """The query surface over a replica's local snapshot store.

    Staleness comes from the replication stream (writer frontier minus
    applied frontier).  On a degraded replica with ``shed_on_degrade``,
    top-k and PPR raise ``ReplicaDegradedError`` while point lookups keep
    answering: the degradation ladder's floor.
    """

    def __init__(self, replica: ReadReplica, metrics=None, **kw):
        super().__init__(replica.store, ingest=None, metrics=metrics, **kw)
        self.replica = replica

    def _staleness(self, snap) -> int:
        return self.replica.staleness

    def _shed_check(self, what: str) -> None:
        r = self.replica
        if r.degraded and r.shed_on_degrade:
            raise ReplicaDegradedError(
                f"replica {r.name} is degraded ({r.staleness} events "
                f"stale, SLO {r.staleness_slo_events}); {what} is shed — "
                f"point queries (get_ranks) remain available",
                staleness_events=r.staleness)

    def top_k(self, k: int) -> QueryResult:
        self._shed_check("top_k")
        return super().top_k(k)

    def personalized_top_k(self, seeds, k: int, mode: str = "auto",
                           **ppr_kw) -> QueryResult:
        self._shed_check("personalized_top_k")
        return super().personalized_top_k(seeds, k, mode=mode, **ppr_kw)


# ---- failover ------------------------------------------------------------

class FailoverController:
    """Promotes the freshest replica when the writer's heartbeat lapses.

    Candidates are ordered by (generation, last_seq).  The last committed
    ``RankStore`` checkpoint competes too: if every surviving replica is
    behind it, promotion restores the checkpoint ranks (onto ``device``)
    and rebuilds the graph at that frontier through ``rebuild_graph(
    last_seq)``, so a committed generation is never lost to a lagging
    replica pool.  ``failover_ms`` records each promotion's host time,
    the new writer's bootstrap (and its pack, on the kernel engine)
    included (the newest ``TIMINGS_KEPT``).
    """

    def __init__(self, transport, roster: ReplicaRoster,
                 engine_factory, writer_name: str = "writer",
                 ckpt_dir: Optional[str] = None,
                 num_vertices: Optional[int] = None,
                 rebuild_graph=None, clock=time.monotonic,
                 device: DeviceLike = None):
        self.transport = transport
        self.roster = roster
        self.engine_factory = engine_factory
        self.writer_name = writer_name
        self.ckpt_dir = ckpt_dir
        self.num_vertices = num_vertices
        self.rebuild_graph = rebuild_graph
        self.device = resolve_device(device)
        self._clock = clock
        self.failovers = 0
        self.failover_ms: deque = deque(maxlen=TIMINGS_KEPT)
        self.incidents: List[Incident] = []

    def writer_expired(self) -> bool:
        return not self.roster.is_alive(self.writer_name, self._clock())

    def check(self, writer: ReplicationWriter,
              replicas: List[ReadReplica]):
        """(new_writer, promoted_replica_or_None) on failover, else None."""
        if writer.alive and not self.writer_expired():
            return None
        return self.promote(writer, replicas)

    def promote(self, old_writer: ReplicationWriter,
                replicas: List[ReadReplica]):
        t0 = time.perf_counter()
        now = self._clock()
        link_up = getattr(self.transport, "link_up", None)
        alive = [r for r in replicas
                 if self.roster.is_alive(r.name, now)
                 and r.ranks is not None
                 and (link_up is None
                      or link_up(r.name, self.writer_name))]
        best = max(alive, key=lambda r: (r.generation, r.last_seq),
                   default=None)
        ckpt = (rescale_serving_state(self.ckpt_dir, self.num_vertices,
                                      device=self.device)
                if self.ckpt_dir and self.num_vertices else
                (None, None, None))
        use_ckpt = ckpt[0] is not None and (
            best is None or (ckpt[0], ckpt[1]) > (best.generation,
                                                  best.last_seq))
        if use_ckpt:
            if self.rebuild_graph is None:
                raise RuntimeError(
                    "checkpoint is ahead of every surviving replica and "
                    "no rebuild_graph callback was provided — refusing "
                    "to lose committed generation "
                    f"{ckpt[0]} (replicas at "
                    f"{best.generation if best else None})")
            gen, last_seq, ranks = ckpt
            graph = self.rebuild_graph(last_seq)
            promoted = None
            source = f"checkpoint gen={gen}"
        elif best is not None:
            gen, last_seq = best.generation, best.last_seq
            ranks, graph = best.ranks, best.graph
            promoted = best
            source = f"replica {best.name} gen={gen}"
        else:
            raise RuntimeError("no promotion candidate: no checkpoint and "
                               "no alive replica with state")
        engine = self.engine_factory(graph, last_seq=last_seq,
                                     generation=gen)
        if (promoted is not None and promoted.ppr is not None
                and getattr(engine, "_ppr", None) is None
                and getattr(engine, "_ppr_cfg", None) is not None):
            # the promoted replica's index is valid for `graph` and, if
            # on the configured PRNG stream, the new writer adopts it and
            # its bootstrap skips the O(V·R·L) rebuild
            cfg = engine._ppr_cfg
            want = dict(num_walks=int(cfg.num_walks),
                        max_len=int(cfg.max_len), alpha=float(cfg.alpha),
                        key=[int(x) for x in threefry.prng_key(cfg.seed)])
            if _ppr_identity(promoted.ppr) == want:
                engine._ppr = promoted.ppr
        engine.store.seed_generation(gen)
        engine.bootstrap(ranks=ranks.to(device=graph.device,
                                        dtype=torch.float64),
                         last_seq=last_seq)
        writer = ReplicationWriter(
            engine, self.transport, name=self.writer_name,
            epoch=old_writer.epoch + 1,
            anchor_every=old_writer.anchor_every,
            log_capacity=old_writer.log_capacity, clock=self._clock)
        writer.attach()
        writer.heartbeat(self.roster)
        if promoted is not None:
            promoted.leave()
        self.failovers += 1
        self.incidents.append(Incident(
            "writer_failover", WARN, gen, last_seq, old_writer.epoch + 1,
            old_writer.epoch,
            f"writer epoch {old_writer.epoch} expired; promoted {source} "
            f"as epoch {old_writer.epoch + 1} (last_seq={last_seq})", now))
        note_host_syncs()                  # wait for the bootstrap's work
        engine.store.snapshot().ranks[:1].cpu()
        self.failover_ms.append((time.perf_counter() - t0) * 1e3)
        return writer, promoted
