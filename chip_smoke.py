#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py [--batches 5] [--out FILE] [--profile]

It exits non-zero on the first failed check; no failure is passed over.

1. Build   — compiles every CUDA kernel of the serve path from this
             checkout's sources.
2. Device  — prints the card's name and ``nvidia-smi`` name/power limit.
3. Kernels — holds each kernel against its plain PyTorch version on the
             card, at the serve engine's own packed shapes: active-window
             fractions 0, ~5 % and 100 %, f32 and bf16 ranks, and the
             empty graph; times kernel, plain version and one library call
             (a cuSPARSE CSR product through ``torch.sparse``) with CUDA
             events, and computes the bytes bound.
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
5. Summary — one JSON line ``{"kernels": [...]}`` with each kernel's
             launches on the serve path, max error and times; then, last,
             ``{"ok": true, "device": {...}}``.

The kernel is not deterministic (float atomics), so every comparison with
the plain version is a tolerance: rtol 1e-4 / atol 1e-6 on f32 sums.
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


def library_spmv(torch, packed, awin):
    """The same gated product as one cuSPARSE CSR call: a matrix of the
    active entries' live lanes (rows: dst, columns: src)."""
    vb = packed.vb
    live = (packed.valid > 0) & awin[packed.window.long()][:, None]
    rows = (packed.window.long()[:, None] * vb + packed.dst_rel.long())[live]
    cols = packed.src.long()[live]
    n_rows = packed.num_windows * vb
    a = torch.sparse_coo_tensor(torch.stack([rows, cols]),
                                torch.ones_like(rows, dtype=torch.float32),
                                (n_rows, n_rows)).coalesce().to_sparse_csr()
    return lambda rsc: (a @ rsc.unsqueeze(1)).squeeze(1)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def build_kernels():
    phase("1. build")
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    out = {name: build.build(name) for name in build.SOURCES}
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
        lib = library_spmv(torch, packed, awin) if frac > 0 else None
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
            library_ms = None
            if lib is not None and dtype == torch.float32:
                lib_out = lib(rsc)
                check(bool(torch.allclose(lib_out, ref, rtol=KERNEL_RTOL,
                                          atol=KERNEL_ATOL)),
                      f"{tag}: library CSR product == plain")
                library_ms = time_ms(torch, lambda: lib(rsc))
            case = dict(frac=frac, dtype=str(dtype)[6:],
                        active_windows=int(awin.sum()), max_abs_err=err,
                        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=library_ms, **detail)
            cases.append(case)
            print(f"  {tag}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={bound_ms:.4f} ({bound_by}) library_ms="
                  f"{'-' if library_ms is None else f'{library_ms:.4f}'} "
                  f"active_entries={detail['active_entries']:,}",
                  flush=True)
        del lib
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
        with open(os.path.join(os.path.dirname(os.path.abspath(args.out)),
                               f"profile_{tag}.txt"), "w") as f:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--out", default=None,
                    help="also write every measurement as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="trace each engine's last serve step with "
                         "torch.profiler (its latency then includes the "
                         "tracing)")
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

    phase("5. summary")
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
        library_ms=main_case["library_ms"])]
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
                           spmv_cases=cases, serve=serve, kernels=kernels,
                           wall_s=wall), f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
