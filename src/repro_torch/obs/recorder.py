"""Flight recorder: bounded batch ring + checkpoint anchors + replay
(twin of ``repro.obs.recorder``, in its bundle format).

When a sentinel or shadow check flags a generation, "what exactly did
the engine do?" must be answerable *after the fact*.  The recorder
keeps, in memory, everything needed to deterministically re-execute
the recent past:

  * a bounded ring of ``BatchRecord``s — per micro-batch: the full
    coalesced ``BatchUpdate`` (host copies of the padded arrays), the
    generation/seq window, the engine's decisions (method, static
    fallback, iteration count), any injected fault, and the published
    snapshot's **rank digest** (obs.sentinel);
  * periodic **anchors** — host copies of the complete engine state
    after a recorded generation: the edge list, the f64 ranks, and (on
    the kernel engine) every ``PackedGraph`` leaf.  Anchors reuse the
    ``ft.checkpoint`` on-disk format when dumped, so a bundle is just
    a checkpoint plus a manifest plus the batch ring.

**Replay determinism contract** (DESIGN.md §12): every sum of the
port has a fixed order (``kernels.pull_contrib``'s chunked pull sums,
``frontier_spmv``'s and the counts' fixed orders, no float atomics), so
the same launches on the same inputs give bit-identical outputs run to
run, on the card as on the CPU.  The engine's per-batch inputs are
exactly (graph, ranks, packed, update, method decision), all of which
the anchor + ring capture, so replaying a window from its anchor
reproduces every published rank vector **bit-for-bit** — verified
digest-by-digest.  The one stateful input, an injected *rank* fault, is
recorded and re-applied; *event* faults corrupt the update before it is
recorded, so the recorded stream already contains them.  A PPR walk
index replays too: the manifest anchors its *identity* (statics + base
PRNG key), and walk sampling is a pure function of (graph, identity),
so the replayed engine rebuilds the index bit-identically from the
anchor graph and repairs it through the window exactly as the live
engine did.  The replayed engine uploads the anchor into new tensors,
so every order, chunk plan and count cached on the live engine's
tensors stays with them: the replay builds its own.  Out of scope: the
sharded mesh path (not ported; ``replay`` refuses a bundle that has it
rather than diverging silently).

Host copies: an anchor reads every state tensor back (one recorded host
sync a leaf, ``device.note_host_syncs``); a batch record's update
leaves are copied without a sync (``stage_update``: non-blocking copies
into pinned memory, complete once the sentinel's one read has waited
for the stream).

``dump()`` writes an **incident bundle** directory::

    <dir>/manifest.json       engine config, record metadata, incident
    <dir>/anchor/step_*/      ft.checkpoint of the anchor state
    <dir>/records.npz         the coalesced update arrays per record

``replay(source)`` accepts a live ``FlightRecorder`` or a bundle path
and returns a ``ReplayReport`` whose per-step rows compare recomputed
digests and decisions against the recorded ones.  The
``repro_torch.launch.replay`` CLI wraps it.  A bundle of either package
loads in the other (same manifest, checkpoint format and arrays).
"""
from __future__ import annotations

import json
import os
from collections import deque
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, note_host_syncs, resolve_device
from repro_torch.ft import checkpoint as ft_checkpoint
from repro_torch.graph.dynamic import BatchUpdate
from repro_torch.obs.sentinel import rank_digest

__all__ = ["BatchRecord", "FlightRecorder", "ReplayReport", "ReplayStep",
           "load_bundle", "replay"]

BUNDLE_VERSION = 1
_MANIFEST = "manifest.json"
_RECORDS = "records.npz"
_ANCHOR_DIR = "anchor"

# PackedGraph array leaves, in dataclass field order
_PACKED_LEAVES = ("src", "dst_rel", "valid", "window", "entry_start",
                  "sorted_key", "sorted_lane", "ovl_key", "ovl_lane")


def _ppr_config(engine) -> Optional[dict]:
    """JSON-serializable identity of the engine's walk index (either
    index type), or None.  Everything that determines the sampled walks
    besides the graph — enough for replay to rebuild bit-identically."""
    idx = getattr(engine, "_ppr", None)
    if idx is None:
        return None
    return dict(num_walks=int(idx.num_walks), max_len=int(idx.max_len),
                alpha=float(idx.alpha),
                key=[int(x) for x in np.asarray(idx.key)])


def _host(x) -> np.ndarray:
    """A host copy of a tensor (one recorded host sync) or an array."""
    if isinstance(x, torch.Tensor):
        note_host_syncs()
        return x.detach().cpu().numpy()
    return np.asarray(x)


def stage_update(update) -> Dict[str, torch.Tensor]:
    """Non-blocking host copies of a ``BatchUpdate``'s leaves (pinned
    memory for a CUDA update): no host sync.  They are complete once the
    host has next waited for the stream (the sentinel's read does);
    ``record_batch(update=...)`` takes them."""
    return {f: getattr(update, f).to("cpu", non_blocking=True)
            for f in BatchUpdate._fields}


class BatchRecord(NamedTuple):
    generation: int
    first_seq: int
    last_seq: int
    num_events: int
    num_coalesced: int
    oldest_t: float
    method: str          # method actually solved with ("static" = fallback)
    fallback: bool
    iterations: int
    digest: int          # rank digest of the published snapshot
    fault: Optional[dict]
    update: Dict[str, np.ndarray]   # BatchUpdate leaves, host copies

    def meta(self) -> dict:
        d = self._asdict()
        d.pop("update")
        return d


class FlightRecorder:
    """In-memory ring of recent batches + state anchors."""

    def __init__(self, capacity: int = 256, anchor_every: int = 64):
        if capacity < 1 or anchor_every < 1:
            raise ValueError("capacity and anchor_every must be >= 1")
        self.capacity = capacity
        self.anchor_every = anchor_every
        self._records: deque = deque(maxlen=capacity)
        # generation -> (state arrays dict, last_seq); state after that
        # generation's publish
        self._anchors: Dict[int, tuple] = {}
        self.config: dict = {}

    # ---- capture ---------------------------------------------------------
    def bind_engine(self, engine) -> None:
        """Snapshot the engine's replay-relevant configuration (static
        for the engine's lifetime, so bound once at bootstrap)."""
        scal = (int, float, bool, str)
        cfg = dict(
            method=engine.method,
            engine=engine.engine,
            static_fallback_frac=float(engine.static_fallback_frac),
            num_vertices=int(engine._graph.num_vertices),
            edge_capacity=int(engine._graph.edge_capacity),
            ingest_capacity=int(getattr(engine.ingest, "capacity", 8)),
            mesh=engine.mesh is not None,
            ppr=_ppr_config(engine),
            pr_kw={k: v for k, v in engine.pr_kw.items()
                   if isinstance(v, scal)},
            kernel_kw={k: v for k, v in engine._kernel_kw.items()
                       if isinstance(v, scal)},
        )
        if engine._packed is not None:
            p = engine._packed
            cfg["pack_kw"] = {k: v for k, v in engine._pack_kw.items()
                              if isinstance(v, (int, float))}
            cfg["packed_statics"] = dict(
                num_vertices=p.num_vertices, vb=p.vb, be=p.be,
                max_entries_per_window=p.max_entries_per_window)
        self.config = cfg

    def record_anchor(self, generation: int, graph, ranks, packed=None,
                      last_seq: int = -1) -> None:
        state = dict(
            ranks=_host(ranks),
            graph_src=_host(graph.src),
            graph_dst=_host(graph.dst),
            graph_valid=_host(graph.valid),
            graph_num_edges=_host(graph.num_edges),
        )
        if packed is not None:
            for name in _PACKED_LEAVES:
                state[f"packed_{name}"] = _host(getattr(packed, name))
        self._anchors[int(generation)] = (state, int(last_seq))

    def record_batch(self, *, generation: int, batch, graph, ranks,
                     method: str, fallback: bool, iterations: int,
                     digest: int, packed=None,
                     fault: Optional[dict] = None,
                     update: Optional[dict] = None) -> None:
        """``update``: the leaves from ``stage_update`` (else they are
        read here, a recorded host sync each)."""
        if update is None:
            update = {f: getattr(batch.update, f)
                      for f in BatchUpdate._fields}
        upd = {f: (np.array(v.numpy()) if isinstance(v, torch.Tensor)
                   and v.device.type == "cpu" else _host(v))
               for f, v in update.items()}
        self._records.append(BatchRecord(
            int(generation), int(batch.first_seq), int(batch.last_seq),
            int(batch.num_events), int(batch.num_coalesced),
            float(batch.oldest_t), str(method), bool(fallback),
            int(iterations), int(digest),
            dict(fault) if fault else None, upd))
        if generation % self.anchor_every == 0:
            self.record_anchor(generation, graph, ranks, packed=packed,
                               last_seq=int(batch.last_seq))
        self._gc_anchors()

    def _gc_anchors(self) -> None:
        """Drop anchors that can no longer seed a replay: keep the newest
        anchor at-or-before the oldest record's predecessor, and all
        newer ones."""
        if not self._records:
            return
        need = self._records[0].generation - 1
        covering = [g for g in self._anchors if g <= need]
        if covering:
            keep_min = max(covering)
            for g in [g for g in self._anchors if g < keep_min]:
                del self._anchors[g]

    # ---- reading ---------------------------------------------------------
    @property
    def records(self) -> List[BatchRecord]:
        return list(self._records)

    @property
    def anchor_generations(self) -> List[int]:
        return sorted(self._anchors)

    def _covering_anchor(self, first_gen: int) -> int:
        """Newest anchor generation <= first_gen - 1."""
        covering = [g for g in self._anchors if g <= first_gen - 1]
        if not covering:
            raise ValueError(
                f"no anchor covers generation {first_gen}; anchors at "
                f"{sorted(self._anchors)}")
        return max(covering)

    def window(self, end_gen: Optional[int] = None):
        """(anchor_gen, anchor_state, anchor_last_seq, records) for the
        replayable window ending at ``end_gen`` (default: newest)."""
        recs = [r for r in self._records
                if end_gen is None or r.generation <= end_gen]
        if not recs:
            raise ValueError("flight recorder has no records in range")
        a = self._covering_anchor(recs[0].generation)
        recs = [r for r in recs if r.generation > a]
        state, last_seq = self._anchors[a]
        return a, state, last_seq, recs

    # ---- bundle I/O ------------------------------------------------------
    def dump(self, directory: str, end_gen: Optional[int] = None,
             incident: Optional[dict] = None) -> str:
        """Write an incident bundle; returns the bundle directory."""
        a, state, a_seq, recs = self.window(end_gen)
        os.makedirs(directory, exist_ok=True)
        ft_checkpoint.save(os.path.join(directory, _ANCHOR_DIR),
                           step=a, state=state, keep_last=1)
        arrays = {f"u{i:05d}_{k}": v
                  for i, r in enumerate(recs) for k, v in r.update.items()}
        np.savez_compressed(os.path.join(directory, _RECORDS), **arrays)
        manifest = dict(
            version=BUNDLE_VERSION,
            config=self.config,
            incident=incident,
            anchor=dict(generation=a, last_seq=a_seq),
            records=[r.meta() for r in recs],
        )
        with open(os.path.join(directory, _MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1, default=_jsonable)
        return directory

    def __len__(self) -> int:
        return len(self._records)


def _jsonable(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    return str(v)


def _load_ckpt_arrays(step_dir: str) -> Dict[str, np.ndarray]:
    """Read an ft.checkpoint step directory back into a flat dict (the
    keystr of a flat dict leaf is ``['name']``)."""
    with open(os.path.join(step_dir, _MANIFEST)) as f:
        man = json.load(f)
    out = {}
    for rec in man["leaves"]:
        key = rec["key"].strip("[]'\"")
        out[key] = np.load(os.path.join(step_dir, rec["file"]))
    return out


def load_bundle(directory: str):
    """(config, anchor_gen, anchor_state, anchor_last_seq, records)."""
    with open(os.path.join(directory, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("version") != BUNDLE_VERSION:
        raise ValueError(
            f"bundle version {manifest.get('version')} != "
            f"{BUNDLE_VERSION}")
    a = int(manifest["anchor"]["generation"])
    step_dir = os.path.join(directory, _ANCHOR_DIR, f"step_{a:010d}")
    state = _load_ckpt_arrays(step_dir)
    npz = np.load(os.path.join(directory, _RECORDS))
    records = []
    for i, meta in enumerate(manifest["records"]):
        upd = {f: npz[f"u{i:05d}_{f}"] for f in BatchUpdate._fields}
        records.append(BatchRecord(
            int(meta["generation"]), int(meta["first_seq"]),
            int(meta["last_seq"]), int(meta["num_events"]),
            int(meta["num_coalesced"]), float(meta["oldest_t"]),
            str(meta["method"]), bool(meta["fallback"]),
            int(meta["iterations"]), int(meta["digest"]),
            meta.get("fault"), upd))
    return (manifest["config"], a, state,
            int(manifest["anchor"]["last_seq"]), records,
            manifest.get("incident"))


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------

class ReplayStep(NamedTuple):
    generation: int
    method: str
    fallback: bool
    digest: int
    want_digest: int
    bitwise: bool        # digest == want_digest
    decisions_match: bool  # method + fallback agree with the record

    @property
    def ok(self) -> bool:
        return self.bitwise and self.decisions_match


class ReplayReport(NamedTuple):
    anchor_generation: int
    steps: List[ReplayStep]

    @property
    def ok(self) -> bool:
        return bool(self.steps) and all(s.ok for s in self.steps)

    @property
    def num_bitwise(self) -> int:
        return sum(s.bitwise for s in self.steps)

    def describe(self) -> str:
        lines = [f"replay from anchor generation "
                 f"{self.anchor_generation}: {len(self.steps)} batches"]
        for s in self.steps:
            verdict = "BITWISE" if s.bitwise else "MISMATCH"
            note = "" if s.decisions_match else " (decision diverged)"
            lines.append(
                f"  gen {s.generation:6d} {s.method:>14s}"
                f"{' [fallback]' if s.fallback else ''} "
                f"digest {s.digest & 0xFFFFFFFFFFFFFFFF:016x} vs "
                f"{s.want_digest & 0xFFFFFFFFFFFFFFFF:016x} "
                f"{verdict}{note}")
        lines.append(f"  => {self.num_bitwise}/{len(self.steps)} "
                     f"bit-for-bit"
                     + ("" if self.ok else "  ** REPLAY DIVERGED **"))
        return "\n".join(lines)


class _ReplayFeed:
    """IngestQueue stand-in serving the recorded batches verbatim."""

    def __init__(self, batches, capacity: int, start_seq: int):
        self._batches = list(batches)
        self.capacity = capacity
        self.start_seq = start_seq
        self.flush_size = max(1, capacity)
        self.latest_seq = (self._batches[-1].last_seq if self._batches
                           else start_seq - 1)

    def poll(self, force: bool = False):
        return self._batches.pop(0) if self._batches else None

    def pending(self) -> int:
        return len(self._batches)


def replay(source, end_gen: Optional[int] = None,
           device: DeviceLike = None) -> ReplayReport:
    """Re-execute a recorded window and diff it against the record.

    ``source`` is a live ``FlightRecorder`` or an incident-bundle
    directory written by ``dump()`` (by either package).  The replayed
    engine runs on ``device`` (default: the CUDA card).  Raises
    ``NotImplementedError`` for configurations whose device state is not
    anchored (the sharded mesh path, and legacy bundles that recorded
    only that a PPR index existed without its identity) — see the
    module docstring.
    """
    device = resolve_device(device)
    if isinstance(source, (str, os.PathLike)):
        cfg, a, state, a_seq, recs, _ = load_bundle(os.fspath(source))
        if end_gen is not None:
            recs = [r for r in recs if r.generation <= end_gen]
    else:
        cfg = source.config
        a, state, a_seq, recs = source.window(end_gen)
    if not cfg:
        raise ValueError("recorder was never bound to an engine "
                         "(no config); cannot replay")
    if cfg.get("mesh"):
        raise NotImplementedError(
            "replay of the sharded mesh path is not supported: per-shard "
            "packed state is not anchored (DESIGN.md §12)")
    pcfg = cfg.get("ppr")
    if pcfg is True:
        # pre-identity bundle: we know an index existed but not its key,
        # so it cannot be reconstructed — the old blanket refusal stands
        raise NotImplementedError(
            "replay with a live PPR walk index needs the index identity "
            "in the bundle config; this legacy bundle predates it "
            "(DESIGN.md §12)")
    if not recs:
        raise ValueError("no records to replay in the requested window")

    # deferred: repro_torch.serve (and through repro_torch.ppr,
    # repro_torch.convert) import repro_torch.obs
    from repro_torch import convert
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.ingest import CoalescedBatch
    from repro_torch.serve.state import RankStore

    # new tensors: nothing cached on the live engine's tensors is reused
    graph = convert.edge_list_from_numpy(
        state["graph_src"], state["graph_dst"], state["graph_valid"],
        int(cfg["num_vertices"]), int(state["graph_num_edges"]),
        device=device)
    batches = [CoalescedBatch(
        update=convert.batch_update_from_numpy(
            *(r.update[f] for f in BatchUpdate._fields), device=device),
        num_events=r.num_events, num_coalesced=r.num_coalesced,
        first_seq=r.first_seq, last_seq=r.last_seq,
        oldest_t=r.oldest_t) for r in recs]
    feed = _ReplayFeed(batches, int(cfg.get("ingest_capacity", 8)), a_seq)
    store = RankStore()
    store.seed_generation(a)

    kernel_opts = None
    if cfg["engine"] == "kernel":
        kernel_opts = dict(cfg.get("kernel_kw", {}))
        pk = dict(cfg.get("pack_kw", {}))
        pk.pop("max_entries_per_window", None)
        kernel_opts.update(pk)   # every shape pinned as the live engine's
    engine = ServeEngine(graph, feed, store, method=cfg["method"],
                         engine=cfg["engine"], kernel_opts=kernel_opts,
                         static_fallback_frac=cfg["static_fallback_frac"],
                         telemetry=False, **cfg.get("pr_kw", {}))
    if cfg["engine"] == "kernel":
        ps = cfg["packed_statics"]
        engine._packed = convert.packed_from_numpy(
            *(state[f"packed_{n}"] for n in _PACKED_LEAVES),
            num_vertices=int(ps["num_vertices"]), vb=int(ps["vb"]),
            be=int(ps["be"]),
            max_entries_per_window=int(ps["max_entries_per_window"]),
            device=device)
        engine._pack_kw["max_entries_per_window"] = \
            int(ps["max_entries_per_window"])
    if pcfg:
        # rebuild the walk index on the anchor graph from its recorded
        # identity — bitwise what the live engine held at the anchor
        # (sampling is a pure function of (graph, identity)), so the
        # per-batch repairs re-run inside engine.step just as they did
        from repro_torch.ppr.walks import WalkIndex, _build_steps
        key = tuple(int(x) for x in pcfg["key"])
        csr = graph.to_device_csr()
        engine._ppr = WalkIndex(
            steps=_build_steps(csr, key, int(cfg["num_vertices"]),
                               int(pcfg["num_walks"]),
                               int(pcfg["max_len"]),
                               float(pcfg["alpha"])),
            csr=csr, key=key, num_walks=int(pcfg["num_walks"]),
            max_len=int(pcfg["max_len"]), alpha=float(pcfg["alpha"]))
    engine.bootstrap(ranks=convert.ranks_from_numpy(state["ranks"], device),
                     last_seq=a_seq)

    steps: List[ReplayStep] = []
    for rec in recs:
        if rec.fault and rec.fault.get("kind") == "rank":
            engine.inject_fault(**rec.fault)
        fb_before = engine.metrics.static_fallbacks
        if not engine.step(force=True):
            raise RuntimeError(
                f"replay feed exhausted before generation "
                f"{rec.generation}")
        snap = store.snapshot()
        fallback = engine.metrics.static_fallbacks > fb_before
        method = "static" if fallback else cfg["method"]
        digest = rank_digest(snap.ranks)
        steps.append(ReplayStep(
            generation=snap.generation, method=method, fallback=fallback,
            digest=digest, want_digest=rec.digest,
            bitwise=digest == rec.digest,
            decisions_match=(snap.generation == rec.generation
                             and fallback == rec.fallback
                             and method == rec.method)))
    return ReplayReport(anchor_generation=a, steps=steps)
