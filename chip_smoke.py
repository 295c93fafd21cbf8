#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py [--batches 5] [--out FILE] [--profile]

It exits non-zero on the first failed check; no failure is passed over.

1. Build   — compiles every CUDA kernel of the serve path from this
             checkout's sources.
2. Device  — prints the card's name and ``nvidia-smi`` name/power limit.
3. Kernels — holds frontier_spmv against its plain PyTorch version on
             the card, at the serve engine's own packed shapes: active-
             window fractions 0, ~5 % and 100 %, f32 and bf16 ranks, and the
             empty graph; times kernel, plain version and one library call
             (a cuSPARSE CSR product through ``torch.sparse``, with values
             in the ranks' type) with CUDA events, and computes the bytes
             bound.
4. Serve   — the paper's §5.2.2 regime at the size of sx-stackoverflow: an
             R-MAT graph of 2**21 vertices and ~30 M edges, random
             80 % insert / 20 % delete batches.  ``ServeEngine(engine=
             "kernel", method="frontier_prune")`` bootstraps with the static
             f64 solve, then serves ``--batches`` micro-batches of
             1024 events through ``IngestQueue``, answering a point
             query and a top-10 query after each.  The same feed then runs
             through ``engine="xla"`` (the plain f64 loop).  Checks: the
             kernel launched during the kernel run; the two final snapshots
             agree to L∞ ≤ 1e-6 and, relative to the largest rank, to
             ≤ REL_LINF_LIMIT; both are within L1 ≤ 1e-4 of a static f64
             solve of the final graph.
5. PPR     — the same graph and feed through ``ServeEngine(engine=
             "kernel", ppr_index=IndexConfig(num_walks=64, max_len=16))``:
             a 2**21 x 64 x 16 int32 walk index (8.6 GB) built at bootstrap
             and repaired per batch by the walk_repair kernel.  Prints the
             build time, per batch the latency, stale walks, repair and
             kernel device time (CUDA events, no added host sync) and host
             syncs, index-mode personalized top-10 latency for 4 seeds of
             out-degree >= 8, the exact PPR solve time and precision@10
             against it, and the peak memory.  Checks: walk_repair
             launched; its outputs on the last batch equal its plain
             version bit for bit; ``walks_resampled`` equals the summed
             stale counts; the served index equals a fresh build on the
             final graph bit for bit.
6. Summary — one JSON line ``{"kernels": [...]}`` with each kernel's
             launches on its serve path, max error and times; then, last,
             ``{"ok": true, "device": {...}}``.

frontier_spmv is not deterministic (float atomics), so every comparison
with its plain version is a tolerance: rtol 1e-4 / atol 1e-6 on f32 sums.
walk_repair has no atomics and no float sums: it is compared bit for bit.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# the configuration: R-MAT scale 21, edge factor 16 (the size class of
# sx-stackoverflow, paper Table 1), micro-batches of 1024 events (§5.2.2)
SCALE, EDGE_FACTOR, FLUSH, SEED = 21, 16, 1024, 0

H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12           # f32 outside the tensor cores
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-6
# a bf16 library product rounds its output to bf16 (8-bit mantissa)
BF16_RTOL, BF16_ATOL = 1e-2, 1e-2
# the walk index of the PPR phase: the reference benchmark's defaults
PPR_WALKS, PPR_LEN, PPR_SEEDS, PPR_MIN_DEG = 64, 16, 4, 8
# kernel engine vs xla engine, L∞ over the largest rank (PERF.md, Findings)
REL_LINF_LIMIT = 1e-6


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)
    print(f"  ok: {what}", flush=True)


def phase(name: str) -> None:
    print(f"\n=== {name}", flush=True)


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``reps`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def spmv_bound(torch, packed, rsc, awin):
    """(bound_ms, bound_by, detail) for one gated SpMV on these inputs:
    each input byte the call needs read once, the output written once."""
    ne, be = packed.src.shape
    nw, vb = packed.num_windows, packed.vb
    entry_active = awin[packed.window.long()]
    n_act = int(entry_active.sum())
    live = (packed.valid > 0) & entry_active[:, None]
    n_live = int(live.sum())
    n_src = int(torch.unique(packed.src[live]).numel()) if n_live else 0
    nbytes = (4 * be * n_act             # valid of every active-entry lane
              + 8 * n_live               # src, dst_rel of live lanes only
              + 4 * ne + nw              # window, active_window
              + rsc.element_size() * n_src   # rsc entries gathered
              + 4 * nw * vb)             # output
    flops = 2 * n_live
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, dict(bytes=nbytes, flops=flops,
                                         active_entries=n_act,
                                         live_lanes=n_live)


def library_spmv(torch, packed, awin, dtype):
    """The same gated product as one cuSPARSE CSR call: a matrix of the
    active entries' live lanes (rows: dst, columns: src), values in
    ``dtype``.  With no window active the matrix has no entries."""
    vb = packed.vb
    live = (packed.valid > 0) & awin[packed.window.long()][:, None]
    rows = (packed.window.long()[:, None] * vb + packed.dst_rel.long())[live]
    cols = packed.src.long()[live]
    n_rows = packed.num_windows * vb
    a = torch.sparse_coo_tensor(torch.stack([rows, cols]),
                                torch.ones_like(rows, dtype=dtype),
                                (n_rows, n_rows)).coalesce().to_sparse_csr()
    return lambda rsc: (a @ rsc.unsqueeze(1)).squeeze(1)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def build_kernels():
    phase("1. build")
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    out = build.build()                   # one nvcc per source, together
    for name, info in out.items():
        print(f"  {name}: {info['path'].name} built in "
              f"{info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"    ptxas: {line.strip()}")
    print(f"  build wall {time.perf_counter() - t0:.2f} s")
    return out


def device_info(torch):
    phase("2. device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} count {torch.cuda.device_count()}")
    print(f"nvidia-smi: {smi}", flush=True)
    return name, smi


def make_graph(torch, dev):
    from repro_torch.graph.generators import rmat_edges
    from repro_torch.graph.structure import from_coo
    t0 = time.perf_counter()
    edges, n = rmat_edges(SCALE, EDGE_FACTOR, seed=SEED)
    t1 = time.perf_counter()
    # rmat_edges already dedups; capacity 1.5x leaves stream headroom
    graph = from_coo(edges[:, 0], edges[:, 1], n, dedup=False, device=dev)
    torch.cuda.synchronize()
    print(f"  graph: rmat({SCALE},{EDGE_FACTOR}) |V|={n:,} "
          f"|E|={len(edges):,} capacity={graph.edge_capacity:,} "
          f"(generate {t1 - t0:.1f} s, to card "
          f"{time.perf_counter() - t1:.1f} s)")
    return edges, n, graph


def kernel_checks(torch, dev, graph):
    """Phase 3: frontier_spmv against its plain version on the card."""
    phase("3. kernels vs plain versions (frontier_spmv)")
    import numpy as np
    from repro_torch.kernels.pagerank_spmv import pagerank_spmv as spmv
    from repro_torch.kernels.pagerank_spmv.ref import frontier_spmv_ref_padded
    from repro_torch.serve import IngestQueue, RankStore, ServeEngine
    # the serve engine's own bootstrap pack, at the engine's geometry
    eng = ServeEngine(graph, IngestQueue(flush_size=FLUSH, device=dev),
                      RankStore(), engine="kernel")
    t0 = time.perf_counter()
    n = graph.num_vertices
    eng.bootstrap(ranks=torch.full((n,), 1.0 / n, dtype=torch.float64,
                                   device=dev))
    packed = eng.packed
    torch.cuda.synchronize()
    ne, be = packed.src.shape
    nw, vb = packed.num_windows, packed.vb
    print(f"  packed: NE={ne:,} BE={be} NW={nw:,} VB={vb} "
          f"lanes={ne * be:,} (pack {time.perf_counter() - t0:.1f} s)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rsc32 = torch.rand(nw * vb, generator=gen, device=dev)
    cases, max_err = [], 0.0

    def plain(rsc, awin):
        return frontier_spmv_ref_padded(packed.src, packed.dst_rel,
                                        packed.valid, packed.window, rsc,
                                        awin, vb)

    for frac in (0.0, 0.05, 1.0):
        awin = torch.rand(nw, generator=gen, device=dev) < frac
        for dtype in (torch.float32, torch.bfloat16):
            rsc = rsc32.to(dtype)
            ref = plain(rsc, awin)
            out = spmv.frontier_spmv_padded(packed, rsc, awin)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            max_err = max(max_err, err)
            tag = f"frac={frac:g} {str(dtype)[6:]}"
            check(bool(torch.allclose(out, ref, rtol=KERNEL_RTOL,
                                      atol=KERNEL_ATOL)),
                  f"{tag}: kernel == plain (max abs err {err:.3e})")
            inactive = ~awin.repeat_interleave(vb)
            check(bool((out[inactive] == 0).all()),
                  f"{tag}: inactive windows exactly 0")
            ms = time_ms(torch, lambda: spmv.frontier_spmv_padded(
                packed, rsc, awin))
            plain_ms = time_ms(torch, lambda: plain(rsc, awin))
            bound_ms, bound_by, detail = spmv_bound(torch, packed, rsc,
                                                    awin)
            library_ms, library_note = library_case(torch, packed, awin,
                                                    rsc, ref, tag)
            case = dict(frac=frac, dtype=str(dtype)[6:],
                        active_windows=int(awin.sum()), max_abs_err=err,
                        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=library_ms,
                        library_note=library_note, **detail)
            cases.append(case)
            print(f"  {tag}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={bound_ms:.4f} ({bound_by}) library_ms="
                  f"{'-' if library_ms is None else f'{library_ms:.4f}'} "
                  f"active_entries={detail['active_entries']:,}",
                  flush=True)
    # the empty graph: every window active, nothing to sum
    none = np.zeros(0, np.int32)
    empty = spmv.pack_blocks(none, none, none.astype(bool), 4096, be=be,
                             vb=vb, device=dev)
    out = spmv.frontier_spmv_padded(
        empty, torch.ones(4096, device=dev),
        torch.ones(empty.num_windows, dtype=torch.bool, device=dev))
    torch.cuda.synchronize()
    check(float(out.abs().max()) == 0.0, "empty graph: output exactly 0")
    del eng, packed
    torch.cuda.empty_cache()
    return cases, max_err


def library_case(torch, packed, awin, rsc, ref, tag):
    """(library_ms, note): the cuSPARSE CSR product in the ranks' type,
    checked against the plain version and timed.  A type this torch's
    sparse product refuses gives no time and the refusal as the note: the
    library is only a yardstick, never part of the port."""
    bf16 = rsc.dtype == torch.bfloat16
    try:
        lib = library_spmv(torch, packed, awin, rsc.dtype)
        lib_out = lib(rsc)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        note = f"torch.sparse CSR product refused {rsc.dtype}: {e}"
        print(f"  {tag}: no library time ({note.splitlines()[0]})")
        return None, note.splitlines()[0]
    if not bf16:
        check(bool(torch.allclose(lib_out, ref, rtol=KERNEL_RTOL,
                                  atol=KERNEL_ATOL)),
              f"{tag}: library CSR product == plain")
        return time_ms(torch, lambda: lib(rsc)), "cuSPARSE CSR"
    err = float((lib_out.float() - ref).abs().max())
    if not bool(torch.allclose(lib_out.float(), ref, rtol=BF16_RTOL,
                               atol=BF16_ATOL)):
        note = (f"torch.sparse bf16 CSR product disagrees with the plain "
                f"version beyond bf16 rounding (max abs err {err:.3e})")
        print(f"  {tag}: no library time ({note})")
        return None, note
    print(f"  ok: {tag}: library CSR product == plain within bf16 output "
          f"rounding (max abs err {err:.3e})")
    return time_ms(torch, lambda: lib(rsc)), \
        "cuSPARSE CSR, bf16 values and output"


def serve_run(args, torch, dev, graph, feed, engine_name):
    """Drive ServeEngine over ``feed`` (a list of event batches)."""
    import numpy as np
    from repro_torch.kernels.pagerank_spmv.pagerank_spmv import LAUNCH_COUNTS
    from repro_torch.serve import IngestQueue, QueryClient, RankStore, \
        ServeEngine, ServeMetrics
    ingest = IngestQueue(flush_size=FLUSH, flush_interval=1e9,
                         device=dev)
    store, metrics = RankStore(), ServeMetrics()
    eng = ServeEngine(graph, ingest, store, metrics=metrics,
                      method="frontier_prune", engine=engine_name)
    client = QueryClient(store, ingest, metrics)
    rng = np.random.default_rng(SEED)
    LAUNCH_COUNTS.clear()                     # counts of this run only
    t0 = time.perf_counter()
    eng.bootstrap()
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    print(f"  [{engine_name}] bootstrap (static f64 solve"
          f"{' + pack' if engine_name == 'kernel' else ''}) {boot_s:.2f} s")
    rows = []
    for b, events in enumerate(feed):
        for kind, u, v in events:
            ingest.submit(kind, u, v)
        before = LAUNCH_COUNTS["frontier_spmv"]
        profile = args.profile and b == len(feed) - 1
        with profiled(torch, profile, f"{engine_name}_batch{b}", args):
            check(eng.step(force=True), f"[{engine_name}] batch {b} served")
        launches = LAUNCH_COUNTS["frontier_spmv"] - before
        m = metrics
        row = dict(batch=b, events=m.batch_events[-1],
                   latency_ms=m.update_latency_s[-1] * 1e3,
                   iterations=m.batch_iterations[-1],
                   affected=m.batch_affected[-1], launches=launches,
                   host_syncs=m.batch_host_syncs[-1],
                   fallback=m.static_fallbacks)
        pt = client.get_ranks(rng.integers(0, graph.num_vertices, size=8))
        top = client.top_k(10)
        check(bool(np.all(np.isfinite(pt.ranks)))
              and top.generation == b + 1 and len(top.vertices) == 10,
              f"[{engine_name}] batch {b}: queries answered at generation "
              f"{top.generation}")
        rows.append(row)
        print(f"  [{engine_name}] batch {b}: events={row['events']} "
              f"latency_ms={row['latency_ms']:.2f} "
              f"iterations={row['iterations']} affected={row['affected']:,} "
              f"launches={launches} host_syncs={row['host_syncs']} "
              f"top1={top.vertices[0]}", flush=True)
    launches = dict(LAUNCH_COUNTS)            # read right after the run
    snap = store.snapshot()
    return dict(boot_s=boot_s, rows=rows, launches=launches,
                metrics=metrics.as_dict(),
                packed_rebuilds=metrics.packed_rebuilds), snap


@contextlib.contextmanager
def profiled(torch, enabled: bool, tag: str, args):
    """``--profile``: trace one serve step with torch.profiler and print
    device time by operator and the device's busy share of the step."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):        # first session starts the tracer
        torch.zeros(1, device="cuda").add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        yield
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    # device time attributed to host-side operators (kernel rows would
    # count it twice)
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CPU)
    print(f"  profile {tag}: step wall {wall_us / 1e3:.2f} ms (profiled), "
          f"device busy {dev_us / 1e3:.2f} ms "
          f"({100 * dev_us / wall_us:.1f} %)")
    table = events.table(sort_by="self_device_time_total", row_limit=25)
    print(table)
    if args.out:
        out_dir = os.path.dirname(os.path.abspath(args.out))
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"profile_{tag}.txt"), "w") as f:
            f.write(table + "\n\n")
            f.write(events.table(sort_by="self_cpu_time_total",
                                 row_limit=40))


def make_feed(args, edges, n):
    """--batches lists of ~FLUSH (kind, u, v) events, 80 % inserts."""
    from repro_torch.graph.generators import random_batch_update
    feed = []
    for b in range(args.batches):
        dele, ins = random_batch_update(edges, n, FLUSH, seed=SEED + 1 + b)
        ev = ([("delete", int(u), int(v)) for u, v in dele]
              + [("insert", int(u), int(v)) for u, v in ins])
        feed.append(ev)
    return feed


def serve_checks(args, torch, dev, edges, n, graph):
    phase("4. serve path at scale (frontier_prune)")
    from repro_torch.core.pagerank import static_pagerank
    feed = make_feed(args, edges, n)
    kernel, snap_k = serve_run(args, torch, dev, graph, feed, "kernel")
    check(kernel["launches"].get("frontier_spmv", 0) > 0,
          f"frontier_spmv launched on the kernel run "
          f"({kernel['launches'].get('frontier_spmv', 0)} launches)")
    xla, snap_x = serve_run(args, torch, dev, graph, feed, "xla")
    check(xla["launches"].get("frontier_spmv", 0) == 0,
          "the xla run launched no kernel")
    rk, rx = snap_k.ranks, snap_x.ranks
    check(rk.shape == (n,) and rk.dtype == torch.float64
          and bool(torch.isfinite(rk).all()),
          "kernel snapshot: finite f64 ranks of shape [V]")
    linf = float((rk - rx).abs().max())
    check(linf <= 1e-6, f"kernel vs xla final snapshot L_inf {linf:.3e} "
          "<= 1e-6")
    # at 2**21 vertices the mean rank is ~5e-7, so the absolute limit above
    # would pass almost any ranks: hold the difference to the largest rank
    rel = linf / float(rx.abs().max())
    check(rel <= REL_LINF_LIMIT, f"kernel vs xla L_inf / max rank {rel:.3e} "
          f"<= {REL_LINF_LIMIT:g}")
    t0 = time.perf_counter()
    static = static_pagerank(snap_k.graph)
    torch.cuda.synchronize()
    l1_k = float((rk - static.ranks).abs().sum())
    l1_x = float((rx - static.ranks).abs().sum())
    print(f"  static f64 solve of the final graph: {static.iterations} "
          f"iterations, {time.perf_counter() - t0:.2f} s")
    check(l1_k <= 1e-4, f"kernel snapshot L1 vs static {l1_k:.3e} <= 1e-4")
    check(l1_x <= 1e-4, f"xla snapshot L1 vs static {l1_x:.3e} <= 1e-4")
    return dict(kernel=kernel, xla=xla, linf_kernel_vs_xla=linf,
                rel_linf_kernel_vs_xla=rel,
                l1_kernel_vs_static=l1_k, l1_xla_vs_static=l1_x,
                static_iterations=static.iterations)


def walk_repair_bound(torch, csr, rows, t0, u, out):
    """(bound_ms, bound_by, detail) for one walk_repair launch on these
    inputs: the bytes this run's walks need, each read once, over the
    card's memory rate.  Needed: the kept prefix slots rows[0..t0], t0, a
    continue draw for every hop from an occupied slot, a choice draw and
    deg/indptr of the current vertex for every hop taken past t0, the
    indices entry of every such hop off the self-loop (deg, indptr and
    indices counted once per distinct entry), and the output."""
    C, L = rows.shape
    E = csr.indices.shape[0]
    hop = torch.arange(1, L, device=rows.device)
    prev, nxt = out[:, :-1], out[:, 1:]
    n_cont = int((prev >= 0).sum())
    taken = (hop[None, :] > t0[:, None]) & (nxt >= 0)
    cur = prev[taken].long()
    d = csr.deg[cur]
    j = torch.minimum((u[:, :, 1][taken] * (d + 1).to(torch.float32))
                      .to(torch.int32), d)
    edge = j < d
    idx = (csr.indptr[cur][edge] + j[edge]).clamp(0, E - 1)
    n_taken = int(cur.numel())
    n_cur = int(torch.unique(cur).numel())
    n_idx = int(torch.unique(idx).numel())
    nbytes = (4 * int((t0.long() + 1).sum())    # kept prefix of rows
              + 4 * C                            # t0
              + 4 * (n_cont + n_taken)           # u: continue, choice
              + 8 * n_cur + 4 * n_idx            # deg + indptr, indices
              + 4 * C * L)                       # output
    flops = n_taken                              # one f32 multiply a hop
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, dict(bytes=nbytes, flops=flops,
                                         walks=C, hops_taken=n_taken,
                                         distinct_vertices=n_cur,
                                         distinct_edges=n_idx)


def cuda_events(torch):
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def ppr_checks(args, torch, dev, edges, n, graph):
    """Phase 5: the serve path with the walk index, on the kernel engine."""
    phase("5. PPR walk index at scale (walk_repair)")
    import numpy as np
    from repro_torch.core.extensions import personalized_pagerank
    from repro_torch.kernels.pagerank_spmv.pagerank_spmv import \
        LAUNCH_COUNTS as SPMV_COUNTS
    from repro_torch.kernels.walk_repair import walk_repair as wr
    from repro_torch.kernels.walk_repair.ref import resample_rows_ref
    from repro_torch.ppr import IndexConfig, build_walk_index, \
        precision_at_k, stale_walks
    from repro_torch.ppr import repair as ppr_repair
    from repro_torch.serve import IngestQueue, QueryClient, RankStore, \
        ServeEngine, ServeMetrics
    from repro_torch.serve import engine as serve_engine

    cfg = IndexConfig(num_walks=PPR_WALKS, max_len=PPR_LEN, seed=SEED)
    feed = make_feed(args, edges, n)
    deg = graph.out_degree(include_self_loop=False).cpu().numpy()
    rng = np.random.default_rng(SEED)
    seeds = sorted(int(v) for v in rng.choice(
        np.flatnonzero(deg >= PPR_MIN_DEG), PPR_SEEDS, replace=False))
    print(f"  index: R={cfg.num_walks} L={cfg.max_len} "
          f"({n * cfg.num_walks * cfg.max_len * 4 / 1e9:.2f} GB int32); "
          f"query seeds {seeds} (out-degree "
          f"{[int(deg[v]) for v in seeds]})")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # CUDA events around the repair and around each kernel launch give
    # device time without adding a host sync; the current batch's launches
    # keep their inputs and outputs for the bitwise check
    rec = dict(build_s=None, repair=[], launches=[], calls=[])
    real = (serve_engine.build_walk_index, serve_engine.repair_walk_index,
            ppr_repair.resample_rows)

    def timed_build(graph_, config):
        torch.cuda.synchronize()
        t = time.perf_counter()
        index = real[0](graph_, config)
        torch.cuda.synchronize()
        rec["build_s"] = time.perf_counter() - t
        return index

    def timed_repair(index, graph_new, touched):
        start, stop = cuda_events(torch)
        start.record()
        out = real[1](index, graph_new, touched)
        stop.record()
        rec["repair"].append((start, stop, index, touched))
        return out

    def timed_resample(csr, rows, t0, u, *, alpha):
        start, stop = cuda_events(torch)
        start.record()
        out = real[2](csr, rows, t0, u, alpha=alpha)
        stop.record()
        rec["launches"].append((start, stop))
        rec["calls"].append((csr, rows, t0, u, alpha, out))
        return out

    ingest = IngestQueue(flush_size=FLUSH, flush_interval=1e9, device=dev)
    store, metrics = RankStore(), ServeMetrics()
    eng = ServeEngine(graph, ingest, store, metrics=metrics,
                      method="frontier_prune", engine="kernel",
                      ppr_index=cfg)
    client = QueryClient(store, ingest, metrics)
    rows, stale_total = [], 0
    serve_engine.build_walk_index, serve_engine.repair_walk_index, \
        ppr_repair.resample_rows = timed_build, timed_repair, timed_resample
    try:
        SPMV_COUNTS.clear()                   # counts of this run only
        wr.LAUNCH_COUNTS.clear()
        t0 = time.perf_counter()
        eng.bootstrap()
        torch.cuda.synchronize()
        boot_s = time.perf_counter() - t0
        print(f"  bootstrap {boot_s:.2f} s, of which index build "
              f"{rec['build_s']:.2f} s")
        for b, events in enumerate(feed):
            for kind, u, v in events:
                ingest.submit(kind, u, v)
            for k in ("repair", "launches", "calls"):
                rec[k].clear()
            before = wr.LAUNCH_COUNTS["walk_repair"]
            profile = args.profile and b == len(feed) - 1
            with profiled(torch, profile, f"ppr_batch{b}", args):
                check(eng.step(force=True), f"[ppr] batch {b} served")
            launches = wr.LAUNCH_COUNTS["walk_repair"] - before
            (start, stop, old, touched), = rec["repair"]
            stop.synchronize()
            repair_ms = start.elapsed_time(stop)
            kernel_ms = sum(a.elapsed_time(z) for a, z in rec["launches"])
            stale = int(stale_walks(old.steps, touched)[0].sum())
            rec["repair"].clear()
            del old, touched
            stale_total += stale
            q_ms = []
            for sd in seeds:
                t = time.perf_counter()
                r = client.personalized_top_k([sd], 10, mode="index")
                q_ms.append((time.perf_counter() - t) * 1e3)
                check(r.generation == b + 1 and len(r.vertices) == 10
                      and bool(np.all(np.isfinite(r.ranks))),
                      f"[ppr] batch {b}: index top-10 of seed {sd} at "
                      f"generation {r.generation}")
            row = dict(batch=b, latency_ms=metrics.update_latency_s[-1] * 1e3,
                       stale_walks=stale, repair_ms=repair_ms,
                       kernel_ms=kernel_ms,
                       launches=launches,
                       host_syncs=metrics.batch_host_syncs[-1],
                       iterations=metrics.batch_iterations[-1],
                       query_ms=q_ms)
            rows.append(row)
            print(f"  [ppr] batch {b}: latency_ms={row['latency_ms']:.2f} "
                  f"stale_walks={stale:,} repair_ms={repair_ms:.2f} "
                  f"kernel_ms={kernel_ms:.3f} launches={launches} "
                  f"host_syncs={row['host_syncs']} "
                  f"iterations={row['iterations']} index_top10_ms="
                  f"{', '.join(f'{x:.2f}' for x in q_ms)}", flush=True)
        launches = dict(walk_repair=wr.LAUNCH_COUNTS["walk_repair"],
                        frontier_spmv=SPMV_COUNTS["frontier_spmv"])
        stream_peak = torch.cuda.max_memory_allocated()
    finally:
        serve_engine.build_walk_index, serve_engine.repair_walk_index, \
            ppr_repair.resample_rows = real
    check(launches["walk_repair"] > 0,
          f"walk_repair launched on the PPR serve path "
          f"({launches['walk_repair']} launches; frontier_spmv "
          f"{launches['frontier_spmv']})")
    check(metrics.walks_resampled == stale_total,
          f"walks_resampled {metrics.walks_resampled:,} == summed stale "
          f"counts {stale_total:,}")

    # the kernel on the serve path against its plain version, bit for bit
    calls = list(rec["calls"])
    rec["calls"].clear()
    check(len(calls) > 0, f"the last batch launched walk_repair "
          f"({len(calls)} launches)")
    max_err = 0
    for csr, r_, t_, u_, alpha, out in calls:
        ref = resample_rows_ref(csr, r_, t_, u_, alpha=alpha)
        max_err = max(max_err, int((out - ref).abs().max()))
        check(torch.equal(out, ref), f"last batch, {r_.shape[0]:,} walks: "
              "kernel == plain, bit for bit")
    csr, r_, t_, u_, alpha, out = max(calls, key=lambda c: c[1].shape[0])
    ms = time_ms(torch, lambda: wr.resample_rows(csr, r_, t_, u_,
                                                 alpha=alpha))
    plain_ms = time_ms(torch, lambda: resample_rows_ref(csr, r_, t_, u_,
                                                        alpha=alpha),
                       reps=5, warmup=1)
    bound_ms, bound_by, detail = walk_repair_bound(torch, csr, r_, t_, u_,
                                                   out)
    print(f"  walk_repair at {r_.shape[0]:,} walks x L={r_.shape[1]}: "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}) {detail}", flush=True)
    del calls, csr, r_, t_, u_, out

    # the served index against a fresh build on the final graph
    snap = store.snapshot()
    t = time.perf_counter()
    fresh = build_walk_index(snap.graph, cfg)
    torch.cuda.synchronize()
    fresh_s = time.perf_counter() - t
    check(torch.equal(snap.ppr_index.steps, fresh.steps),
          f"served index == fresh build on the final graph, bit for bit "
          f"(rebuild {fresh_s:.2f} s)")
    del fresh

    # the exact solve for each seed, and the index's precision@10 against it
    exact = []
    for sd in seeds:
        mask = torch.zeros(n, dtype=torch.bool, device=dev)
        mask[sd] = True
        t = time.perf_counter()
        res = personalized_pagerank(snap.graph, mask)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t
        ranks = res.ranks.cpu().numpy()
        check(ranks.shape == (n,) and bool(np.all(np.isfinite(ranks))),
              f"seed {sd}: exact PPR finite, {res.iterations} iterations")
        top = client.personalized_top_k([sd], 10, mode="index")
        p10 = precision_at_k(top.vertices, ranks, 10)
        exact.append(dict(seed=sd, solve_s=solve_s,
                          iterations=res.iterations, precision_at_10=p10))
        print(f"  seed {sd}: exact solve {solve_s:.2f} s "
              f"({res.iterations} iterations), index precision@10 "
              f"{p10:.2f}")
    peak = torch.cuda.max_memory_allocated()
    print(f"  peak device memory: {stream_peak / 2**30:.2f} GiB in the "
          f"stream, {peak / 2**30:.2f} GiB in the phase")
    return dict(boot_s=boot_s, build_s=rec["build_s"], rows=rows,
                launches=launches, stale_total=stale_total,
                metrics=metrics.as_dict(), kernel=dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, max_abs_err=float(max_err), **detail),
                fresh_build_s=fresh_s, exact=exact,
                peak_bytes_stream=stream_peak, peak_bytes=peak)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--out", default=None,
                    help="also write every measurement as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="trace the last serve step of each engine and of "
                         "the PPR phase with torch.profiler (its latency "
                         "then includes the tracing)")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on "
              "the card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    builds = build_kernels()
    name, smi = device_info(torch)
    phase("setup: graph")
    edges, n, graph = make_graph(torch, dev)
    cases, max_err = kernel_checks(torch, dev, graph)
    serve = serve_checks(args, torch, dev, edges, n, graph)
    torch.cuda.empty_cache()              # phase 4's engines are gone
    ppr = ppr_checks(args, torch, dev, edges, n, graph)

    phase("6. summary")
    main_case = next(c for c in cases
                     if c["frac"] == 0.05 and c["dtype"] == "float32")
    kernels = [dict(
        name="frontier_spmv", route="cuda",
        source="src/repro_torch/kernels/pagerank_spmv/csrc/frontier_spmv.cu",
        replaces="src/repro/kernels/pagerank_spmv/pagerank_spmv.py:239",
        launches=serve["kernel"]["launches"].get("frontier_spmv", 0),
        max_abs_err=max_err, ms=main_case["ms"],
        plain_ms=main_case["plain_ms"], bound_ms=main_case["bound_ms"],
        bound_by=main_case["bound_by"],
        library_ms=main_case["library_ms"]), dict(
        name="walk_repair", route="cuda",
        source="src/repro_torch/kernels/walk_repair/csrc/walk_repair.cu",
        replaces="src/repro/kernels/walk_repair/walk_repair.py:72",
        launches=ppr["launches"]["walk_repair"],
        max_abs_err=ppr["kernel"]["max_abs_err"], ms=ppr["kernel"]["ms"],
        plain_ms=ppr["kernel"]["plain_ms"],
        bound_ms=ppr["kernel"]["bound_ms"],
        bound_by=ppr["kernel"]["bound_by"], library_ms=None)]
    wall = time.perf_counter() - t_start
    print(f"  wall {wall:.1f} s; card: {smi}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(device=name, nvidia_smi=smi, args=vars(args),
                           build={k: dict(seconds=v["seconds"],
                                          log=v["log"])
                                  for k, v in builds.items()},
                           spmv_cases=cases, serve=serve, ppr=ppr,
                           kernels=kernels,
                           wall_s=wall), f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
