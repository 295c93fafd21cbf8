#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py [--batches 5] [--out FILE] [--profile]
    python3 chip_smoke.py --spmv-kernels-only [--out FILE]
    python3 chip_smoke.py --gnn-kernels-only [--out FILE]
    python3 chip_smoke.py --replicas-only [--out FILE]
    python3 chip_smoke.py --mesh-only [--out FILE]
    python3 chip_smoke.py --ppr-mesh-only [--out FILE]
    python3 chip_smoke.py --train-only [--out FILE]
    python3 chip_smoke.py --lm-only [--out FILE]
    python3 chip_smoke.py --recsys-only [--out FILE]
    python3 chip_smoke.py --dryrun-only [--out FILE]

The second form runs only the set-up (build, device, graph) and phase 3's
frontier_spmv and phase 3b's pull_contrib, slot_count, segment_bounds
and segment_or kernel cases;
the third only the set-up and phase 6's kernel cases: pull_rows's on the
set-up graph, gated_spmm's on the first batch's packed graph; the fourth
only the set-up and phase 9, the fifth only the set-up and phase 10, the
sixth phase 11 and the seventh phase 12; the eighth runs the build, the
device and phase 13 alone, with no R-MAT set-up, the ninth phase 14 so,
and the tenth phase 15 so.  None prints a summary: they are the quick loops for work on one
kernel or phase.

The kernel engine tunes its pack geometry at bootstrap
(``kernels/pagerank_spmv/tune.py``); the run keeps the tuner's cache in
a temporary directory of its own.  Phase 3 checks and times the kernel
at the tuner's pick, the geometry the main path serves at; phase 4 also
serves at the fixed geometry of earlier runs (BE 512, VB 256), and
phase 9 (c)/(d) pin it; every other engine serves at the tuner's pick.

It exits non-zero on the first failed check; no failure is passed over.

1. Build   — compiles every CUDA kernel of the serve path from this
             checkout's sources.
2. Device  — prints the card's name and ``nvidia-smi`` name/power limit.
3. Kernels — holds frontier_spmv against its plain PyTorch version on
             the card, at the serve engine's own packed shapes (the
             tuner's geometry, as the engine's bootstrap picks it): active-
             window fractions 0, ~5 % and 100 %, f32 and bf16 ranks; only
             the last window (``tail``: it owns the capacity tail) and only
             the widest other window (``hub``), f32; and the empty graph.
             Every case is also checked bitwise equal run to run.  Prints
             the kernel's K, plan, grid, shared memory, blocks a SM and
             registers; times kernel, plain version and one library call
             (a cuSPARSE CSR product through ``torch.sparse``, with values
             in the ranks' type) with CUDA events, the host's time a call
             of each, and the kernel's own device time (torch.profiler),
             and computes the bytes bound.
3b. Pull   — holds pull_contrib (the f64 loop's fixed-order pull sum, the
             port's own kernel: chunks of at most K = PULL_CHUNK slots,
             each added in slot order, then the chunks in order) on the
             smoke's graph bit for bit against its plain version run on
             the CPU, within PULL_RTOL against the plain version on the
             card (atomics), and bitwise run to run; the same for the
             longest segment alone (``hub``), and the weighted sum
             (per-slot weights, as weighted PageRank has them); times
             kernel, plain version and ``index_add_`` of the products,
             with its bound.  Prints K, the chunk plan's chunks, partials
             and split vertices and its build time (apart from the call),
             the call's device time by launch (terms pass, chunks, split
             vertices), and a sweep of K (128 to 2048) on ``all`` and
             ``hub``, each checked against the plain version at that K.
             Then the edge-slot counts: the old ``_count`` (an int32
             ``index_add_``) timed over every slot, the live slots only
             and the free slots only (all of them vertex 0); the order's
             sort; segment_bounds on its keys (== searchsorted, == the
             cumsum of the atomic in-degree count); slot_count on
             ``in_degree``'s old call (by dst) and ``out_degree``'s (by
             src); segment_or (``push_or``) at a 1 %, a ~50 % and a 100 %
             frontier beside the old route (slot_count gathered > 0).
             Each kernel equal to its plain version on the card and on
             the CPU, exactly, and timed beside it and one library call
             (searchsorted, ``index_add_``) with its bytes bound.
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
             solve of the final graph; frontier_spmv and pull_contrib
             launched (pull_contrib on the xla run too).  Then the feed
             runs once more on the kernel engine: the two kernel runs'
             final snapshots must be bitwise equal, with equal per-batch
             iteration and affected counts.  Then once at the fixed
             geometry (BE 512, VB 256): L∞ <= 1e-6 of the tuned run, and
             each run's latency a batch printed side by side.  Every batch's
             ``batch_host_syncs`` must equal the synchronizing calls
             ``torch.cuda.set_sync_debug_mode("warn")`` reports for it,
             and every batch must build one order (one segment_bounds)
             and one out-degree count (one slot_count); it prints the
             segment_or launches (one a ``push_or``), the cudaMalloc
             calls and peak memory.  Last, the feed once more on the
             kernel engine from a released allocator cache, with the
             allocator's history recorded (untimed): where each batch's
             cudaMalloc calls come from, and a bitwise equal snapshot.
5. PPR     — the same graph and feed through ``ServeEngine(engine=
             "kernel", ppr_index=IndexConfig(num_walks=64, max_len=16))``:
             a 2**21 x 64 x 16 int32 walk index (8.6 GB) built at bootstrap
             and repaired per batch by the walk_repair kernel, which makes
             its own threefry draws.  Prints the build time, per batch the
             latency, stale walks, the repair's device time split into
             stale scan, draws + kernel, index copy + row gather +
             scatter, and CSR build + stale-id compaction (CUDA events, no
             added host sync), host syncs (reported and measured),
             index-mode personalized top-10 latency for 4 seeds of
             out-degree >= 8, the exact PPR solve time and precision@10
             against it, and the peak memory; the kernel's time (events,
             host, profiler), registers, shared memory and blocks a SM.
             Checks: walk_repair, frontier_spmv and pull_contrib
             launched; every last-batch launch equals its keyed plain
             version bit for bit; reported host syncs equal measured ones;
             ``walks_resampled`` equals the summed stale counts; the
             served index equals a fresh build on the final graph bit for
             bit.
6. GNN     — incremental GraphSAGE embedding refresh on the same graph
             and the first 3 batches of its feed, at the full width of
             ``graphsage-reddit`` (d_in 602, d_hidden 128, 41 classes, 2
             layers; random features and parameters from the seed, 5.05 GB
             of features).  Per batch:
             ``apply_batch``, ``apply_batch_packed``,
             ``touched_vertices_mask``, ``incremental_refresh`` with
             ``sage_forward``, then ``aggregate_features`` (the gated_spmm
             kernel) on ``touched | push_or(touched)``; prints latency, its
             device split, the kernel's time, nodes recomputed, the share
             of active windows, host syncs and cudaMalloc calls.
             Checks: (a) the kernel ==
             its plain version; (b) its active rows == ``sage_forward``'s
             layer-1 neighbour sum; (c) the refreshed embeddings == a full
             forward on ``affected_ever``; (d) inactive windows exactly 0;
             (e) one launch per batch; (f) ``pull_rows`` (the forward's
             fixed-order neighbour-row sum, the port's own kernel)
             launched once a layer of each refresh.  Then ``pull_rows``
             at d = 602 and 128: twice, bitwise equal; within the GNN
             tolerance of its plain version; timed beside it and one
             cuSPARSE SpMM, with its bytes bound and its device time by
             launch (the fill of the rows of no in-edge, tag, rows, splits,
             release; the graph's empty rows counted); its row path (float2,
             float4 or scalar loads), its hot set (sources, bytes, share
             of the live slots, build time apart from the call) and a
             sweep of the hot set's budget (0 to 40 MB), every budget
             bitwise equal to budget 0 and run to run.  Then kernel cases at
             0 %, ~5 %,
             100 %, the batch's own active windows, only the widest
             window (``hub``) and all but it (``rest``): kernel, plain and
             cuSPARSE times, bytes bound, bitwise equality run to run;
             and the kernel's K, scratch, shared memory, blocks a SM and
             registers.
7. Paper   — the paper's five methods (Static, ND, DT, DF, DF-P) on
             both engines (``xla``, the f64 loop; ``kernel``, the f32
             frontier_spmv iterations and f64 polish) through the
             streaming driver's loop (``launch.pagerank.run_batches``)
             on the set-up graph: 3 random batches (80 % insertions) of
             1024 edges and 3 of 10^-3 |E|, each batch's latency,
             iterations, ``affected_ever``, host syncs, cudaMalloc
             calls, orders built and slot_count, segment_bounds and
             segment_or launches (one
             order and one out-degree count a batch, checked) and L1
             against a static f64 solve of its graph (<= 1e-4).
             Then restart: 3 batches of DF-P uninterrupted, against 2
             with a checkpoint every 2 and a restart from it
             (``restore_stream``): final ranks bitwise equal.  Then the
             driver's command line on the card, ``--batches 3`` and
             ``--batches 5`` on one ``--ckpt-dir``: the second prints
             ``restored at batch 2``.
8. Observ. — phase 4's graph and feed through the kernel engine four
             ways: plain, ``telemetry=True``, with a ``CorrectnessMonitor``
             (shadow every 2 batches on its own thread and stream, an
             anchor every 2), and with both and the span tracer on (the
             shadow synchronous, so that ``batch_host_syncs`` is held to
             the debug mode's count every batch).  Checks: every
             batch's snapshot digest equals phase 4's unmonitored run's;
             no incident; shadow L1 <= 1e-4 and L∞ <= 1e-5; a batch's
             telemetry rows equal its iterations and the first row's
             affected its initial affected set; the Chrome trace loads
             and each ``serve.step`` span holds a ``fused_update_loop``;
             a Prometheus scrape holds the sentinel and shadow gauges.
             Prints a batch's update latency in the four runs, the step's
             wall time, the extra syncs, the anchors' bytes and the
             shadow solves' ms.  Then a rank fault on the largest rank
             at a mid generation (scale printed): a ``rank_mass`` error
             incident there, a bundle dumped (bytes, seconds), replayed by
             ``python -m repro_torch.launch.replay --strict`` in a
             subprocess on the card (exit 0, every step bitwise, every
             decision matching), then deleted; a clean monitored run on
             the xla engine, replayed in-process bit for bit; and the
             card's ``rank_digest`` of phase 4's final ranks equal to the
             CPU's.
9. Replicas — (a) ``ChaosHarness(engine="kernel")`` at full width (the
             set-up's R-MAT draw): a writer and 2 read replicas over a
             lossy transport (2 % drops, duplicates, reorders), 8,192
             events in 1024-event batches, a heartbeat every 256, an
             anchor every 2 generations, and the schedule
             ``partition:r1@1024+1024;kill:r0@3072+1024;kill_writer@5120``.
             Checks: writer-to-replica L∞ exactly 0.0 at every parity
             check, one failover (epoch 1), a resync, drops, every
             writer batch's ``batch_host_syncs`` equal to the debug
             mode's count, the rank kernels launched.  Prints the rank
             delta a publish, the writer hook's ms beside the step's
             wall, anchor bytes and ms, replica apply, resync and
             failover ms.  (c) Phase 4's graph and feed on the kernel
             engine with ``iteration_budget=2``, then the cap lifted
             until the carried frontier drains: the cap holds (f32 phase
             and polish each), a carry-over, syncs reported = measured on
             every batch, L1 vs a static f64 solve <= 1e-4.  (b) A
             PPR writer (phase 5's index) and a replica that bootstraps
             cold from the anchor; deltas through a lossy transport; a
             partition past a one-entry log forces an anchor resync that
             heals by repair, not by a rebuild; walk steps bitwise equal
             after the bootstrap, the heal and at the end; walk_repair
             launched.  Prints the heal's ms beside the cold build's.
             (d) Block-Gauss-Seidel on (c)'s bootstrap pack (BE 512, VB
             256): at tol 1e-7 no more sweeps than Jacobi iterations
             and bitwise run to run; at tol 1e-8 the same and L1 vs a
             static f64 solve <= 1e-4 (PERF.md §6, PR 23: at tol 1e-7
             the stopping rule alone leaves ~1e-4).  Prints sweeps, ms a
             sweep and both L1s.
10. Shards — (a) the tuner at full width: the model's ranking of the
             grid at frontier fractions 0.05 and 1.0; its top 3 at 0.05,
             the fixed (512, 256) and its last pick, each packed (host
             time printed) and timed with CUDA events at ~5 % and 100 %
             active (the first f·|V| vertices, as the tuner's measured
             search), predicted beside measured; the pick no slower than
             the fixed geometry by more than 5 % at ~5 %; a cache miss,
             then a hit keyed by the card's name.  Each geometry's output
             is held to the plain version (rtol 1e-4 / atol 1e-6).
             (b) The first MESH_BATCHES of phase 4's feed through
             ``ServeEngine(engine="kernel", mesh=)`` on a (1, 4) mesh that
             repeats the card (four shards; the halo exchange, again for
             bitwise, then psum) and ``engine="xla"`` on the 2 x 2 test
             mesh (twice): L∞ <= 1e-6 against the f64 engine every
             batch, L1 <= 1e-4 against a static f64 solve, snapshots
             bitwise run to run, every batch's ``batch_host_syncs`` equal
             to the debug mode's count, ``frontier_spmv`` launched once a
             shard an f32 iteration; a routed budget of FLUSH / 16 rows a
             shard forces a per-shard repack.  Each shard's frontier_spmv
             of the bootstrap pack is held to its plain version on the
             card, on an rsc spanning every vertex (all set, and only the
             shard's range and halo set) at ~5 % and 100 % of its
             windows.  Prints latency a batch
             (median, max), comm bytes, halo occupancy and repacks by
             shard.  The kernel runs after the first start from its
             bootstrap pack (as phase 9 reuses one).  The four shards
             share one card: the phase measures the sharded code path and
             its wire accounting, not scaling across cards.
             (c) ``update_pagerank(mesh=)`` once on the 2 x 2 mesh (L∞
             <= 1e-6 against the f64 engine),
             ``rescale_pagerank_state`` from the 4-shard run onto the 2 x
             2 mesh (ranks bitwise, the new mesh's partition), and
             ``launch.serve --mesh test --engine kernel --ppr-walks 8`` (a
             range-sharded walk index) in a subprocess
             (exit 0).
11. PPR mesh — the walk index of phase 5 (R=64, L=16, 8.6 GB) range-
             sharded over a (1, 4) mesh that repeats the card: (a) the
             sharded build (each shard its start-vertex range, global
             walk ids) bitwise the unsharded build; (b)
             ``ServeEngine(engine="kernel", mesh=, ppr_index=)`` over
             phase 4's first MESH_BATCHES batches: the bootstrap's
             sharded index, each batch's index bitwise the unsharded
             repair of the same batch, walk_repair launched once a shard
             with stale walks, ``batch_host_syncs`` equal to the debug
             mode's count, the seeds' top-10 equal to the unsharded
             index's and estimates within 1e-12; prints the repair's ms
             (a shard's resample: median, max) beside the unsharded
             repair of the same batch and phase 5's; (c) a tight
             ``capacity`` raises ``ShardCapacityError`` naming the shards
             and ``check=False`` drops the overflow; (d) ``engine="xla"``
             on the 2 x 2 mesh with the index, one batch, its two shards
             bitwise (b)'s.  The serve driver with a range-sharded index
             runs in phase 10 (c).
12. Train  — the GNN family's training step at full width: each of
             TRAIN_CELLS at its full config, inputs from the ported
             ``build_inputs(concrete=True, smoke=False, seed=1)``, 3 AdamW
             steps (``make_gnn_train_step``); graphsage-reddit's
             minibatch_lg once more on blocks the ported
             ``NeighborSampler`` draws from the set-up graph's CSR (host
             ms printed).  Checks: step 0's loss finite (PNA's later
             steps are NaN, as the reference's: its std aggregator's
             gradient at zero variance); loss, gradients and the updated
             parameters bitwise run to run; every ``pull_rows`` call of a
             step, forward and backward, within GNN_RTOL / GNN_ATOL of
             ``pull_rows_ref`` on the card; ``pull_rows`` launched in the
             forward and (but for sampled blocks, whose sums' backward is
             a gather) the backward; on full_graph_sm and molecule the
             same steps on the CPU, losses rtol 1e-5 and parameters rtol
             1e-4 / atol 1e-5·max.  Prints ms a step, peak memory, host
             syncs a step and ``pull_rows`` launches forward and
             backward; the cells not run, with the bytes of those one
             card cannot hold; and ``pull_rows`` at d = 512 over
             graphcast minibatch_lg's slots by dst beside its plain
             version and cuSPARSE, with its bound.
13. LM     — the LM family at full width: each LM_CELLS cell
             of the five architectures, its depth and batch cut to fit
             one 80 GB card and the phase's time (each cut printed), bf16
             weights drawn from the seed, inputs from the ported
             ``build_inputs(concrete=True, seed=1)``.  Train cells:
             LM_STEPS AdamW steps (``make_lm_train_step`` with the
             arch's MICROBATCHES, moment and accumulator dtypes); on
             qwen2.5-3b, whole (36 layers, batch 4 x 4,096), a
             microbatch's loss and gradients twice and the steps again
             from the seed, bitwise; every ``pull_rows`` call of a
             microbatch (the embedding's and the MoE's row sums, forward
             and backward) within GNN_RTOL / GNN_ATOL of
             ``pull_rows_ref`` on the card.  arctic-480b's train_4k is
             sized and printed as not run.  Prefill cells (2 x 32,768):
             one ``make_lm_prefill`` call, last-position logits finite.
             Decode cells: LM_DECODE_STEPS greedy steps into a full-size
             cache drawn on the card, from ctx - 16 to ctx.  Then
             qwen2.5-3b (2 layers) and qwen3-moe (1 layer) at full width
             in f32 against the CPU: the MoE's routing equal first, the
             loss rtol 1e-5, gradients and the parameters and moments
             after one AdamW update rtol 1e-4 / atol 1e-5·max (the
             parameters where the two gradients agree to rtol 1e-4: the
             first update moves an element by ~lr·sign(g), the rest are
             counted); decode against prefill's last logits (rtol / atol
             2e-3).  Prints ms
             a step (first and later) and tokens/s, prefill ms and
             tokens/s, decode ms a step, peak GiB a cell, host syncs a
             train and a decode step (``set_sync_debug_mode``), and
             ``pull_rows`` launches forward and backward; last, the
             attention yardstick: one qwen2.5-3b layer's
             ``chunked_causal_attention`` at 2 x 32,768 beside
             ``F.scaled_dot_product_attention(is_causal=True)`` (printed,
             no part of the port) and the FLOP bound.
14. RecSys — DeepFM at its full config (39 fields of 10^6 rows,
             embed_dim 10, MLP 400-400-400; 1.72 GB of parameters drawn
             from the seed), inputs from the ported ``build_inputs(
             concrete=True, seed=1)``, the four ``recsys_shapes`` cells
             through the ported step makers: train_batch (65,536)
             RECSYS_STEPS AdamW steps, its loss and gradients twice and
             its first step again from the seed, bitwise, 0 host syncs,
             and every ``pull_rows`` call of the gradients (the tables'
             d = 10 and d = 1) within GNN_RTOL / GNN_ATOL of
             ``pull_rows_ref`` on the card; serve_p99 (512)
             RECSYS_SERVE_CALLS calls, p50 and p99 ms (host clock, each
             ending in a sync); serve_bulk (262,144) and retrieval_cand
             (1 query, 10^6 candidates) in ms.  Each cell beside its
             bound from the ported roofline (``roofline/analysis.py``:
             FLOPs at f32's rate, bytes at HBM's).  The step's split:
             gradients, the order and plan, each ``pull_rows``, the rest
             AdamW.  Then the card against the CPU at full widths on
             RECSYS_CPU_VOCAB rows a field: loss rtol 1e-5, gradients and
             (after one AdamW update) parameters and moments rtol 1e-4 /
             atol 1e-5·max (parameters whose two gradients differ by more
             than rtol 1e-4 counted, not held), serve and retrieval rtol
             1e-5 / atol 1e-6·max.  Last, ``pull_rows`` at d = 10 and 1
             on the train step's slot order (its live-segment plan: a
             chunk a live row of the 39 M, the empty rows filled; packed
             paths of 8 and 1 lanes a chunk): within the GNN tolerance of
             its plain version on the card, bitwise its plain version on
             the CPU and run to run; timed beside the plain version and
             ``index_add_``, with its bound and its device time by launch
             (packed rows, fill, splits).
15. Dry-run — (a) ``launch.dryrun`` over all 44 cells of
             ``all_cells(include_pagerank=True)`` on the production (16, 16)
             mesh and the reference test's four cells
             (DRYRUN_MULTI_CELLS) on (2, 16, 16), all of ``meta``
             positions (no device touched), in ``launch.dryrun.MAX_JOBS``
             worker processes: every cell OK, or SKIP where its ``skip`` says,
             none FAIL; ``roofline.build_table`` reads the records and its
             table is printed (MODEL/HLO a cell, the collective term n/a);
             the sweep's seconds.  (b) The LM's counting mode against its
             production mode on the card, full width in f32
             (COUNTING_LAYERS: qwen2.5-3b at 2 layers, qwen3-moe at 1; 1 x
             1,024 tokens): loss rtol 1e-5, gradients rtol 1e-4 / atol
             1e-5·max, prefill logits and 4 decode steps rtol 1e-4 / atol
             1e-5·max; the embedding's backward a ``pull_rows`` launch in
             both modes.  (c) The dry-run on a (1, 1) meta mesh against
             one step on the card (DRYRUN_PEAK_BOUNDS): DeepFM
             train_batch and serve_bulk at the full config, predicted peak
             over ``max_memory_allocated`` (over what was allocated before
             the step's arguments) within [0.95, 1.05]; qwen2.5-3b
             train_4k at phase 13's cut within the same; the predicted
             FLOPs over the step's time as TFLOP/s; each beside
             ``nvidia-smi``'s name and power limit.
16. Summary — one JSON line ``{"kernels": [...]}`` with each kernel's
             launches on its paths (phases 9's to 15's added; pull_rows at
             d = 10 and d = 1 also on lines of their own, phase 14's),
             max error (frontier_spmv's over phases 3 and 10) and
             times; then, last, ``{"ok": true, "device": {...}}``.
             Each phase prints its peak of allocated device memory.

frontier_spmv sums in a fixed order (bitwise equal run to run), but not
the plain version's: rtol 1e-4 / atol 1e-6 on f32 sums.  walk_repair has
no atomics and no float sums: it is compared bit for bit.  pull_contrib
adds in its plain version's order on the CPU: bit for bit against it
there, rtol PULL_RTOL against its atomic form on the card.
gated_spmm sums in a fixed order, but not the plain version's: rtol 1e-4 /
atol 1e-5 relative to the output's largest magnitude; pull_rows adds in
its plain version's order, which on the card adds with atomics: the same
tolerance.  slot_count, segment_bounds and segment_or give integers and
booleans: exactly equal.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
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
H100_F64_FLOPS = 34e12           # f64 outside the tensor cores (data sheet)
# INT32 operations a second: 132 SMs x 64 INT32 lanes (Hopper architecture
# white paper) x 1.98 GHz, the H100 SXM's highest SM clock
H100_INT32_OPS = 132 * 64 * 1.98e9
# pull_contrib against its plain version on the card, which adds with
# atomics in another order: f64 summation-order error
PULL_RTOL = 1e-12
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-6
# a bf16 library product rounds its output to bf16 (8-bit mantissa)
BF16_RTOL, BF16_ATOL = 1e-2, 1e-2
# the walk index of the PPR phase: the reference benchmark's defaults
PPR_WALKS, PPR_LEN, PPR_SEEDS, PPR_MIN_DEG = 64, 16, 4, 8
# kernel engine vs xla engine, L∞ over the largest rank (PERF.md, Findings)
REL_LINF_LIMIT = 1e-6
# the GNN phase: gated_spmm and the refresh against their plain versions,
# the tolerance of tests/test_kernels.py held relative to the largest output
GNN_RTOL, GNN_ATOL = 1e-4, 1e-5
GNN_BATCHES = 3          # the GNN phase's batches (fewer if --batches is)
# the paper-methods phase: random batches of FLUSH edges and of this share
# of |E| (paper §5.2.2's 10^-3), 3 of each (fewer if --batches is)
PAPER_BATCH_FRAC, PAPER_BATCHES = 1e-3, 3


# what torch.cuda.set_sync_debug_mode("warn") says of a synchronizing call
SYNC_WARNING = "called a synchronizing CUDA operation"


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


def host_ms(torch, fn, reps: int = 20) -> float:
    """Mean host time of one ``fn()`` call over ``reps`` calls issued back
    to back with no synchronisation (the device may still be running):
    what a call costs the host.  When it exceeds the device time,
    ``time_ms`` reads the host too."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e3


def device_ms(torch, fn, names, reps: int = 20):
    """Mean device time a call of the kernels whose names hold one of
    ``names``, from a torch.profiler trace of ``reps`` calls: the card's
    own time, without the host's.  None where the trace shows none."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):        # first session starts the tracer
        fn()
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if any(n in e.key for n in names))
    return us / reps / 1e3 if us > 0 else None


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
    from repro_torch.kernels import work
    flops, nbytes = work.frontier_spmv_work(ne, be, nw, vb, n_act, n_live,
                                            n_src, rsc.element_size())
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
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
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


def spmv_info(torch, packed):
    """Prints and returns what frontier_spmv takes on the card at this
    shape: K, the plan's slots and real chunks, the grid of each pass,
    shared memory a block, blocks a SM, registers."""
    from repro_torch.kernels.pagerank_spmv import pagerank_spmv as spmv
    from repro_torch.kernels.segment_ops.plan import cached_plan
    info = spmv.kernel_info(packed)
    plan = cached_plan(packed.entry_start, packed.num_entries,
                       info["chunk_entries"])
    real = plan.window < packed.num_windows
    last = plan.window == packed.num_windows - 1
    info.update(real_chunks=int(real.sum()),
                real_partials=int(((plan.part >= 0) & real).sum()),
                last_window_chunks=int(last.sum()))
    print(f"  frontier_spmv: K={info['chunk_entries']} entries a chunk; "
          f"plan {info['chunk_slots']:,} chunk slots ({info['real_chunks']:,}"
          f" real, {info['last_window_chunks']:,} of them the last "
          f"window's), {info['partial_slots']:,} partial slots "
          f"({info['real_partials']:,} real), {info['split_slots']:,} split "
          f"slots; grid {info['grid']:,} blocks (chunk pass) + "
          f"{info['reduce_grid']:,} (second pass) of 256 threads; shared "
          f"memory {info['smem_per_block']:,} B dynamic + "
          f"{info['static_smem_per_block']:,} B static a block; "
          f"{info['blocks_per_sm']} blocks a SM on {info['sms']} SMs; "
          f"{info['registers']} registers a thread ({info['reduce_registers']}"
          f" in the second pass); scratch {info['scratch_bytes']:,} B",
          flush=True)
    return info


def kernel_checks(torch, dev, graph):
    """Phase 3: frontier_spmv against its plain version on the card."""
    phase("3. kernels vs plain versions (frontier_spmv)")
    import numpy as np
    from repro_torch.kernels.pagerank_spmv import pagerank_spmv as spmv
    from repro_torch.kernels.pagerank_spmv.ref import frontier_spmv_ref_padded
    from repro_torch.serve import IngestQueue, RankStore, ServeEngine
    # the serve engine's bootstrap pack at the geometry the main path
    # serves at: the tuner's pick (phase 4's engines hit its cache; phase
    # 10 times the pick beside the fixed BE 512 / VB 256 of PRs 11-23)
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
    owned = packed.entry_start[1:] - packed.entry_start[:-1]
    hub = int(torch.argmax(owned[:-1]))       # the widest but the last
    geometry = eng.kernel_geometry.describe()
    print(f"  geometry {geometry} (tune {eng.tune_info.source}, "
          f"{eng.tune_info.tune_time_s:.2f} s)")
    print(f"  packed: NE={ne:,} BE={be} NW={nw:,} VB={vb} "
          f"lanes={ne * be:,} (pack {time.perf_counter() - t0:.1f} s); "
          f"last window owns {int(owned[-1]):,} entries, window {hub} "
          f"(hub) {int(owned[hub]):,}")
    info = spmv_info(torch, packed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rsc32 = torch.rand(nw * vb, generator=gen, device=dev)
    cases, max_err = [], 0.0

    def plain(rsc, awin):
        return frontier_spmv_ref_padded(packed.src, packed.dst_rel,
                                        packed.valid, packed.window, rsc,
                                        awin, vb)

    runs = []
    for name, frac in (("0 %", 0.0), ("~5 %", 0.05), ("100 %", 1.0)):
        awin = torch.rand(nw, generator=gen, device=dev) < frac
        runs += [(name, frac, awin, dtype)
                 for dtype in (torch.float32, torch.bfloat16)]
    windows = torch.arange(nw, device=dev)
    runs += [("tail", None, windows == nw - 1, torch.float32),
             ("hub", None, windows == hub, torch.float32)]
    for name, frac, awin, dtype in runs:
        tag = f"{name} {str(dtype)[6:]}"
        rsc = rsc32.to(dtype)
        ref = plain(rsc, awin)
        out = spmv.frontier_spmv_padded(packed, rsc, awin)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        max_err = max(max_err, err)
        check(bool(torch.allclose(out, ref, rtol=KERNEL_RTOL,
                                  atol=KERNEL_ATOL)),
              f"{tag}: kernel == plain (max abs err {err:.3e})")
        inactive = ~awin.repeat_interleave(vb)
        check(bool((out[inactive] == 0).all()),
              f"{tag}: inactive windows exactly 0")
        check(all(torch.equal(spmv.frontier_spmv_padded(packed, rsc, awin),
                              out) for _ in range(3)),
              f"{tag}: bitwise equal run to run (3 more calls)")
        call = lambda: spmv.frontier_spmv_padded(packed, rsc, awin)
        ms, kernel_host_ms = time_ms(torch, call), host_ms(torch, call)
        kernel_device_ms = device_ms(torch, call,
                                     ("spmv_chunks", "spmv_partials"))
        plain_ms = time_ms(torch, lambda: plain(rsc, awin))
        bound_ms, bound_by, detail = spmv_bound(torch, packed, rsc, awin)
        library_ms, library_note, library_host_ms = library_case(
            torch, packed, awin, rsc, ref, tag)
        case = dict(case=name, frac=frac, dtype=str(dtype)[6:],
                    geometry=geometry,
                    active_windows=int(awin.sum()), max_abs_err=err, ms=ms,
                    host_ms=kernel_host_ms, device_ms=kernel_device_ms,
                    plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=library_ms, library_host_ms=library_host_ms,
                    library_note=library_note, **detail)
        cases.append(case)
        dev_txt = ("not measured" if kernel_device_ms is None
                   else f"{kernel_device_ms:.4f}")
        lib_txt = ("-" if library_ms is None else
                   f"{library_ms:.4f} (host {library_host_ms:.4f})")
        print(f"  {tag}: kernel_ms={ms:.4f} (host {kernel_host_ms:.4f}, "
              f"device {dev_txt}) "
              f"plain_ms={plain_ms:.4f} "
              f"bound_ms={bound_ms:.4f} ({bound_by}) library_ms={lib_txt} "
              f"active_entries={detail['active_entries']:,} "
              f"live_lanes={detail['live_lanes']:,} "
              f"bytes={detail['bytes']:,}", flush=True)
    # the empty graph: every window active, nothing to sum
    none = np.zeros(0, np.int32)
    empty = spmv.pack_blocks(none, none, none.astype(bool), 4096, be=be,
                             vb=vb, extra_entries=64, device=dev)
    out = spmv.frontier_spmv_padded(
        empty, torch.ones(4096, device=dev),
        torch.ones(empty.num_windows, dtype=torch.bool, device=dev))
    torch.cuda.synchronize()
    check(float(out.abs().max()) == 0.0, "empty graph: output exactly 0")
    del eng, packed
    torch.cuda.empty_cache()
    return cases, max_err, info


def pull_contrib_bound(torch, order, ranks, weighted=False):
    """(bound_ms, bound_by, detail) for one pull sum on these inputs: ptr,
    the live slots' src (and weights), ranks and inv_deg once per distinct
    source, the f64 output; a multiply and an add a live slot (and a
    multiply more with weights)."""
    V = ranks.shape[0]
    n_live = int(order.ptr[-1])
    n_src = int(torch.unique(order.src[:n_live]).numel()) if n_live else 0
    from repro_torch.kernels import work
    flops, nbytes = work.pull_contrib_work(V, n_live, n_src, weighted)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F64_FLOPS * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, dict(bytes=nbytes, flops=flops,
                                         live_slots=n_live,
                                         distinct_sources=n_src)


def contrib_checks(torch, dev, graph):
    """Phase 3b: pull_contrib (the f64 loop's fixed-order pull sum) against
    its plain version, on the smoke's graph: bit for bit against the CPU's
    sum, run to run, and within f64 summation-order error against the
    plain version on the card; the longest segment alone (``hub``)."""
    phase("3b. kernels vs plain versions (pull_contrib)")
    from repro_torch.kernels.pull_contrib import pull_contrib as pc
    from repro_torch.kernels.pull_contrib.ref import PullOrder, \
        pull_contrib_ref, slot_vertex
    from repro_torch.kernels.segment_ops.plan import cached_plan, chunk_plan
    n = graph.num_vertices
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    order = pc.pull_order(graph.src, graph.dst, graph.valid, n)
    torch.cuda.synchronize()
    order_ms = (time.perf_counter() - t0) * 1e3
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    ranks = torch.rand(n, generator=gen, device=dev,
                       dtype=torch.float64) / n
    inv = 1.0 / graph.out_degree(include_self_loop=True).to(torch.float64)
    seg = (order.ptr[1:] - order.ptr[:-1]).long()
    hub = int(torch.argmax(seg))
    info = pc.kernel_info()
    K = pc.PULL_CHUNK
    plan = cached_plan(order.ptr, order.src.shape[0], K)
    n_split = int((seg > K).sum())
    plan_ms = time_ms(torch, lambda: chunk_plan(order.ptr,
                                                order.src.shape[0], K),
                      reps=5, warmup=1)
    print(f"  pull_contrib: chunk kernel {info['registers']} registers a "
          f"thread, {info['blocks_per_sm']} blocks of "
          f"{info['threads_per_block']} a SM on {info['sms']} SMs; weighted "
          f"{info['weighted_registers']} registers, "
          f"{info['weighted_blocks_per_sm']} blocks; split kernel "
          f"{info['split_registers']} registers; order (one stable sort of "
          f"{graph.edge_capacity:,} slots and segment_bounds) "
          f"{order_ms:.2f} ms; longest "
          f"segment: vertex {hub}, {int(seg[hub]):,} in-edges", flush=True)
    print(f"  plan: K={K}, {plan.window.shape[0]:,} chunks, "
          f"{plan.num_partials:,} partial slots "
          f"({plan.num_partials * 8 / 2**20:.2f} MiB), "
          f"{plan.split_window.shape[0]:,} split slots for {n_split:,} "
          f"vertices of more than K in-edges; build {plan_ms:.4f} ms "
          f"(once a solve)", flush=True)
    # only the hub's segment left: what its chunks and their chain cost
    ptr_hub = torch.where(torch.arange(n + 1, device=dev) <= hub,
                          order.ptr[hub], order.ptr[hub + 1])
    # the weighted sums' per-slot weights (weighted PageRank's edge weights
    # in the pull order)
    weight = torch.rand(order.src.shape[0], generator=gen, device=dev,
                        dtype=torch.float64) + 0.5
    cases, max_err = [], 0.0
    for name, o, w in (("all", order, None),
                       ("hub", order._replace(ptr=ptr_hub), None),
                       ("weighted", order, weight)):
        out = pc.pull_contrib(o, ranks, inv, w)
        plain = pull_contrib_ref(o, ranks, inv, w)
        torch.cuda.synchronize()
        err = float((out - plain).abs().max())
        max_err = max(max_err, err)
        check(bool(torch.allclose(out, plain, rtol=PULL_RTOL, atol=0)),
              f"{name}: kernel == plain on the card within rtol "
              f"{PULL_RTOL:g} (max abs err {err:.3e})")
        cpu = pull_contrib_ref(PullOrder(*(t.cpu() for t in o)),
                               ranks.cpu(), inv.cpu(),
                               None if w is None else w.cpu())
        check(torch.equal(out.cpu(), cpu),
              f"{name}: kernel == the CPU's sum, bit for bit")
        check(all(torch.equal(pc.pull_contrib(o, ranks, inv, w), out)
                  for _ in range(3)),
              f"{name}: bitwise equal run to run (3 more calls)")
        call = lambda: pc.pull_contrib(o, ranks, inv, w)
        ms, call_host_ms = time_ms(torch, call), host_ms(torch, call)
        call_device_ms = device_ms(torch, call, ("pull_contrib",))
        plain_ms = time_ms(torch, lambda: pull_contrib_ref(o, ranks, inv, w))
        # one library call for the sum: index_add_ over the products
        src = o.src.long()
        prod = (ranks[src] * inv[src] if w is None
                else ranks[src] * w * inv[src])
        dst = slot_vertex(o.ptr, src.shape[0])
        buf = torch.zeros(n + 1, dtype=torch.float64, device=dev)
        library_ms = time_ms(torch,
                             lambda: buf.zero_().index_add_(0, dst, prod))
        del src, prod, dst, buf
        bound_ms, bound_by, detail = pull_contrib_bound(torch, o, ranks,
                                                        w is not None)
        cases.append(dict(case=name, max_abs_err=err, ms=ms,
                          host_ms=call_host_ms, device_ms=call_device_ms,
                          plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by, **detail))
        dev_txt = ("not measured" if call_device_ms is None
                   else f"{call_device_ms:.4f}")
        print(f"  {name}: kernel_ms={ms:.4f} (host {call_host_ms:.4f}, "
              f"device {dev_txt}) plain_ms={plain_ms:.4f} "
              f"bound_ms={bound_ms:.4f} ({bound_by}) library_ms="
              f"{library_ms:.4f} (index_add_ of the products) "
              f"live_slots={detail['live_slots']:,}", flush=True)
    # where a call's device time goes: the terms pass, the chunks, the
    # split vertices' chunk-order adds
    call = lambda: pc.pull_contrib(order, ranks, inv)
    split = {k: device_ms(torch, call, (f"pull_contrib_{k}",))
             for k in ("terms", "chunks", "splits")}
    print("  all, device ms by launch: " + ", ".join(
        f"{k} {'not measured' if v is None else f'{v:.4f}'}"
        for k, v in split.items()), flush=True)
    # the chunk length K: the whole graph and the hub alone
    sweep = []
    for k in (128, 256, 512, 1024, 2048):
        row = dict(chunk_slots=k)
        for name, o in (("all", order), ("hub", order._replace(ptr=ptr_hub))):
            out = pc.pull_contrib(o, ranks, inv, chunk_slots=k)
            plain = pull_contrib_ref(o, ranks, inv, chunk_slots=k)
            check(bool(torch.allclose(out, plain, rtol=PULL_RTOL, atol=0))
                  and torch.equal(pc.pull_contrib(o, ranks, inv,
                                                  chunk_slots=k), out),
                  f"K={k} {name}: kernel == plain on the card within rtol "
                  f"{PULL_RTOL:g}, bitwise run to run")
            row[f"{name}_ms"] = time_ms(
                torch, lambda: pc.pull_contrib(o, ranks, inv, chunk_slots=k))
            del out, plain
        sweep.append(row)
        print(f"  K={k}: all {row['all_ms']:.4f} ms, hub "
              f"{row['hub_ms']:.4f} ms", flush=True)
    del order, ptr_hub, weight
    torch.cuda.empty_cache()
    return dict(cases=cases, max_abs_err=max_err, order_ms=order_ms,
                hub_vertex=hub, hub_in_edges=int(seg[hub]), info=info,
                chunk_slots=K, plan_chunks=plan.window.shape[0],
                plan_partials=plan.num_partials,
                plan_splits=plan.split_window.shape[0],
                split_vertices=n_split, plan_ms=plan_ms,
                device_split=split, sweep=sweep)


def int32_sectors(torch, mask):
    """32-byte sectors of an int32 per-slot array that the slots of
    ``mask`` fall in: the least a read of only those slots moves."""
    pos = torch.nonzero(mask).squeeze(1)
    return int(torch.unique_consecutive(pos // 8).numel())


def slot_count_bound(torch, live, counted, gathered, n):
    """(bound_ms, bound_by, detail) for one edge-slot count: every slot's
    bool weight read once; the int32 index of a counted slot only (its
    32-byte sectors); with a gather also the int32 gather index of a live
    slot (its sectors) and the bool flags once; the int32 output written
    once; an add a counted slot."""
    E = live.shape[0]
    n_live, n_counted = int(live.sum()), int(counted.sum())
    index_bytes = 32 * int32_sectors(torch, counted)
    gather_bytes = 32 * int32_sectors(torch, live) if gathered else 0
    from repro_torch.kernels import work
    ops, nbytes = work.slot_count_work(E, n, n_counted, index_bytes,
                                       gather_bytes, gathered)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_INT32_OPS * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, dict(bytes=nbytes, slots=E,
                                         live_slots=n_live,
                                         index_bytes=index_bytes,
                                         gather_bytes=gather_bytes)


def segment_bounds_bound(torch, n_live, n):
    """(bound_ms, bound_by, detail) for one segment_bounds call: the live
    sorted int32 keys read once and the int32 ptr[n + 1] written once; a
    compare a live key."""
    from repro_torch.kernels import work
    ops, nbytes = work.segment_bounds_work(n_live, n)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_INT32_OPS * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, dict(bytes=nbytes, live_slots=n_live)


def segment_or_bound(torch, order, flags, n):
    """(bound_ms, bound_by, detail) for one segment_or call, by
    ``slot_count_bound``'s convention, over the lesser of the two byte
    counts that compute it: the int32 src of every live sorted slot (its
    32-byte sectors), the bool flags read once and the bool output written
    once, and either the int32 sorted dst of a live slot whose flag is set
    (its sectors; ``dst_route_bytes``, the shipped design's) or the int32
    ptr[n + 1] (``ptr_only_bytes``, a design that reads each segment's
    ends); a test a live slot."""
    E = order.src.shape[0]
    n_live = int(order.ptr[n])
    live = torch.arange(E, device=order.src.device) < n_live
    hit = live & flags[torch.where(live, order.src, 0).long()]
    src_bytes = 32 * int32_sectors(torch, live)
    dst_bytes = 32 * int32_sectors(torch, hit)
    dst_route = src_bytes + dst_bytes + 2 * n
    ptr_only = src_bytes + 4 * (n + 1) + 2 * n
    from repro_torch.kernels import work
    ops, nbytes = work.segment_or_work(n_live, n, src_bytes, dst_bytes)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_INT32_OPS * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, dict(
        bytes=nbytes, live_slots=n_live, set_slots=int(hit.sum()),
        src_bytes=src_bytes, dst_bytes=dst_bytes,
        dst_route_bytes=dst_route, ptr_only_bytes=ptr_only,
        dst_route_bound_ms=dst_route / H100_BYTES_PER_S * 1e3,
        ptr_only_bound_ms=ptr_only / H100_BYTES_PER_S * 1e3)


def count_checks(torch, dev, graph):
    """Phase 3b, the edge-slot counts: first the old ``_count`` (the int32
    ``index_add_`` that is slot_count's plain version) over every slot,
    over the live slots only and over the free ones only, timed; then, on
    the graph's dst-sorted order, ``segment_bounds`` (its ptr) and
    ``segment_or`` (``push_or``) at a 1 %, a ~50 % and a 100 % frontier,
    beside the old route (``slot_count`` gathered, its atomic count by
    dst) and ``index_add_``; and ``slot_count`` on ``in_degree``'s old
    call (by dst) and ``out_degree``'s (by src, the only count the rank
    path still makes).  Every kernel equal to its plain version on the
    card and on the CPU, exactly; each timed with its bytes bound."""
    from repro_torch.kernels.pull_contrib import pull_contrib as pc
    from repro_torch.kernels.slot_count import slot_count as sc
    from repro_torch.kernels.slot_count.ref import segment_bounds_ref, \
        segment_or_ref, slot_count_ref
    n = graph.num_vertices
    live = graph.valid
    n_live = int(live.sum())
    dst_live, dst_free = graph.dst[live], graph.dst[~live]
    old = {tag: time_ms(torch, lambda: slot_count_ref(idx, w, n), reps=10)
           for tag, idx, w in (
               ("all", graph.dst, live),
               ("live", dst_live, torch.ones_like(dst_live, dtype=torch.bool)),
               ("free", dst_free,
                torch.zeros_like(dst_free, dtype=torch.bool)))}
    hub = int(torch.bincount(dst_free.long()).argmax()) if len(dst_free) \
        else -1
    print(f"  old _count (int32 index_add_): all {graph.edge_capacity:,} "
          f"slots {old['all']:.4f} ms, live {n_live:,} slots "
          f"{old['live']:.4f} ms, free {len(dst_free):,} slots (dst "
          f"{hub}) {old['free']:.4f} ms", flush=True)
    del dst_live, dst_free
    cases = []

    def report(case, note=""):
        cases.append(case)
        dev_txt = ("not measured" if case["device_ms"] is None
                   else f"{case['device_ms']:.4f}")
        lib_txt = ("-" if case["library_ms"] is None
                   else f"{case['library_ms']:.4f}")
        print(f"  {case['kernel']} {case['case']}: kernel_ms="
              f"{case['ms']:.4f} (host {case['host_ms']:.4f}, device "
              f"{dev_txt}) plain_ms={case['plain_ms']:.4f} bound_ms="
              f"{case['bound_ms']:.4f} ({case['bound_by']}, "
              f"{case['bytes']:,} B) library_ms={lib_txt}{note}",
              flush=True)

    def timed(call, names):
        return (time_ms(torch, call), host_ms(torch, call),
                device_ms(torch, call, names))

    # the order: one stable sort of the slots by dst, then its ptr
    key = torch.where(live, graph.dst, torch.full_like(graph.dst, n))
    sort_ms = time_ms(torch, lambda: torch.sort(key, stable=True), reps=5)
    order = pc.pull_order(graph.src, graph.dst, graph.valid, n)
    del key
    print(f"  the order's sort: {graph.edge_capacity:,} slots "
          f"{sort_ms:.4f} ms (torch.sort, stable, keys and permutation)",
          flush=True)
    # segment_bounds on the sorted keys
    ptr = sc.segment_bounds(order.dst, n)
    check(torch.equal(ptr, segment_bounds_ref(order.dst, n)),
          "segment_bounds: kernel == plain (searchsorted) on the card, "
          "exactly")
    check(torch.equal(ptr.cpu(), segment_bounds_ref(order.dst.cpu(), n)),
          "segment_bounds: kernel == the CPU's plain version, exactly")
    in_deg = sc.slot_count(graph.dst, live, n)
    check(torch.equal(ptr[1:].long(), torch.cumsum(in_deg.long(), 0))
          and int(ptr[0]) == 0,
          "segment_bounds: ptr == the cumsum of the atomic in-degree "
          "count, exactly")
    check(all(torch.equal(sc.segment_bounds(order.dst, n), ptr)
              for _ in range(3)), "segment_bounds: equal run to run")
    call = lambda: sc.segment_bounds(order.dst, n)
    ms, h_ms, d_ms = timed(call, ("segment_bounds",))
    vs = torch.arange(n + 1, dtype=torch.int32, device=dev)
    library_ms = time_ms(torch, lambda: torch.searchsorted(order.dst, vs))
    bound_ms, bound_by, detail = segment_bounds_bound(torch, n_live, n)
    report(dict(kernel="segment_bounds", case="order", max_abs_err=0.0,
                ms=ms, host_ms=h_ms, device_ms=d_ms,
                plain_ms=time_ms(torch,
                                 lambda: segment_bounds_ref(order.dst, n)),
                library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, **detail),
           " (torch.searchsorted)")
    del vs
    # slot_count: in_degree's old call (by dst), out_degree's (by src)
    for tag, index in (("in_degree", graph.dst), ("out_degree", graph.src)):
        out = sc.slot_count(index, live, n)
        check(torch.equal(out, slot_count_ref(index, live, n)),
              f"slot_count {tag}: kernel == plain (index_add_) on the card, "
              f"exactly")
        check(torch.equal(out.cpu(), slot_count_ref(index.cpu(),
                                                     live.cpu(), n)),
              f"slot_count {tag}: kernel == the CPU's index_add_, exactly")
        call = lambda: sc.slot_count(index, live, n)
        ms, h_ms, d_ms = timed(call, ("slot_count",))
        idx, w = index.long(), live.to(torch.int32)
        buf = torch.zeros(n, dtype=torch.int32, device=dev)
        library_ms = time_ms(torch,
                             lambda: buf.zero_().index_add_(0, idx, w))
        bound_ms, bound_by, detail = slot_count_bound(torch, live, live,
                                                      False, n)
        report(dict(kernel="slot_count", case=tag, max_abs_err=0.0, ms=ms,
                    host_ms=h_ms, device_ms=d_ms,
                    plain_ms=time_ms(torch,
                                     lambda: slot_count_ref(index, live, n)),
                    library_ms=library_ms, bound_ms=bound_ms,
                    bound_by=bound_by, counted_slots=n_live, **detail),
               " (index_add_)")
        del idx, w, buf
    # push_or: segment_or over the order against the old gathered count
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    for tag, frac in (("1 %", 0.01), ("~50 %", 0.5), ("100 %", 1.0)):
        flags = torch.rand(n, generator=gen, device=dev) < frac
        args = (order.ptr, order.src, order.dst, flags)
        out = sc.segment_or(*args)
        check(torch.equal(out, segment_or_ref(*args)),
              f"segment_or {tag}: kernel == plain on the card, exactly")
        check(torch.equal(out.cpu(), segment_or_ref(*(t.cpu()
                                                      for t in args))),
              f"segment_or {tag}: kernel == the CPU's plain version, "
              f"exactly")
        old_args = (graph.dst, live, n, graph.src, flags)
        check(torch.equal(out, sc.slot_count(*old_args) > 0),
              f"segment_or {tag}: == the old route (slot_count gathered "
              f"> 0), exactly")
        call = lambda: sc.segment_or(*args)
        ms, h_ms, d_ms = timed(call, ("segment_or", "pack_flags"))
        old_call = lambda: sc.slot_count(*old_args) > 0
        old_ms, old_h_ms, old_d_ms = timed(old_call, ("slot_count",))
        hit = live & flags[graph.src.long()]
        idx, w = graph.dst.long(), hit.to(torch.int32)
        buf = torch.zeros(n, dtype=torch.int32, device=dev)
        library_ms = time_ms(torch,
                             lambda: buf.zero_().index_add_(0, idx, w))
        old_bound, _, old_detail = slot_count_bound(torch, live, hit, True,
                                                    n)
        del idx, w, buf, hit
        bound_ms, bound_by, detail = segment_or_bound(torch, order, flags,
                                                      n)
        old_dev = ("not measured" if old_d_ms is None
                   else f"{old_d_ms:.4f}")
        report(dict(kernel="segment_or", case=tag, frac=frac,
                    max_abs_err=0.0, ms=ms, host_ms=h_ms, device_ms=d_ms,
                    plain_ms=time_ms(torch,
                                     lambda: segment_or_ref(*args)),
                    library_ms=library_ms, bound_ms=bound_ms,
                    bound_by=bound_by, old_route_ms=old_ms,
                    old_route_host_ms=old_h_ms,
                    old_route_device_ms=old_d_ms,
                    old_route_bound_ms=old_bound,
                    old_route_bytes=old_detail["bytes"], **detail),
               f" (index_add_ of the hits); old route (slot_count "
               f"gathered > 0) {old_ms:.4f} ms (host {old_h_ms:.4f}, "
               f"device {old_dev}, bound {old_bound:.4f}); set slots "
               f"{detail['set_slots']:,}; bounds: ptr-only "
               f"{detail['ptr_only_bound_ms']:.4f} ms, flagged dst "
               f"{detail['dst_route_bound_ms']:.4f} ms")
    del order, ptr, in_deg
    torch.cuda.empty_cache()
    return dict(old_ms=old, free_hub=hub, sort_ms=sort_ms, cases=cases)


def library_case(torch, packed, awin, rsc, ref, tag):
    """(library_ms, note, host_ms): the cuSPARSE CSR product in the ranks'
    type, checked against the plain version and timed (device and host).
    A type this torch's sparse product refuses gives no time and the
    refusal as the note: the library is only a yardstick, never part of
    the port."""
    bf16 = rsc.dtype == torch.bfloat16
    try:
        lib = library_spmv(torch, packed, awin, rsc.dtype)
        lib_out = lib(rsc)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        note = f"torch.sparse CSR product refused {rsc.dtype}: {e}"
        print(f"  {tag}: no library time ({note.splitlines()[0]})")
        return None, note.splitlines()[0], None
    call = lambda: lib(rsc)
    if not bf16:
        check(bool(torch.allclose(lib_out, ref, rtol=KERNEL_RTOL,
                                  atol=KERNEL_ATOL)),
              f"{tag}: library CSR product == plain")
        return time_ms(torch, call), "cuSPARSE CSR", host_ms(torch, call)
    err = float((lib_out.float() - ref).abs().max())
    if not bool(torch.allclose(lib_out.float(), ref, rtol=BF16_RTOL,
                               atol=BF16_ATOL)):
        note = (f"torch.sparse bf16 CSR product disagrees with the plain "
                f"version beyond bf16 rounding (max abs err {err:.3e})")
        print(f"  {tag}: no library time ({note})")
        return None, note, None
    print(f"  ok: {tag}: library CSR product == plain within bf16 output "
          f"rounding (max abs err {err:.3e})")
    return (time_ms(torch, call), "cuSPARSE CSR, bf16 values and output",
            host_ms(torch, call))


def count_marks(torch, builds, counts) -> dict:
    """The counters a batch's counts are read from: orders and out-degree
    counts built (``graph.structure.CACHE_BUILDS``), the launches of the
    count kernels (``slot_count.LAUNCH_COUNTS``) and the caching
    allocator's cudaMalloc calls."""
    return dict(orders=builds["pull_order"],
                out_degrees=builds["out_degree"],
                slot_count=counts["slot_count"],
                segment_bounds=counts["segment_bounds"],
                segment_or=counts["segment_or"],
                cuda_mallocs=cuda_mallocs(torch))


def count_text(c) -> str:
    return (f"orders built {c['orders']}, slot_count {c['slot_count']}, "
            f"segment_bounds {c['segment_bounds']}, segment_or "
            f"{c['segment_or']}, cudaMalloc {c['cuda_mallocs']}")


def cuda_mallocs(torch) -> int:
    """cudaMalloc calls the caching allocator has made (segments it asked
    the driver for, this process)."""
    return torch.cuda.memory_stats().get("segment.all.allocated", 0)


def malloc_sites(torch, seen: int):
    """(trace length, [(bytes, site)]): the cudaMalloc calls recorded in
    the allocator's history (``torch.cuda.memory._record_memory_history``)
    past its first ``seen`` entries, each with the innermost frames of
    ``src/repro_torch`` that asked for the memory."""
    trace = torch.cuda.memory._snapshot()["device_traces"][0]
    out = []
    for ev in trace[seen:]:
        if ev["action"] != "segment_alloc":
            continue
        frames = [f for f in ev.get("frames", [])
                  if "repro_torch" in f["filename"]]
        site = " < ".join(
            f"{f['filename'].split('repro_torch/')[-1]}:{f['line']} "
            f"{f['name']}" for f in frames[:3]) or "outside the port"
        out.append((ev["size"], site))
    return len(trace), out


def serve_run(args, torch, dev, graph, feed, engine_name, sites=False,
              kernel_opts=None, label=None):
    """Drive ServeEngine over ``feed`` (a list of event batches).
    ``sites``: record the allocator's history and print where each
    batch's cudaMalloc calls come from (slows the run; not timed).
    ``kernel_opts`` go to the engine; ``label`` names the run in the
    printed lines (default: the engine's name)."""
    import numpy as np
    from repro_torch.kernels.pagerank_spmv.pagerank_spmv import LAUNCH_COUNTS
    from repro_torch.graph.structure import CACHE_BUILDS
    from repro_torch.kernels.pull_contrib.pull_contrib import \
        LAUNCH_COUNTS as PULL_COUNTS
    from repro_torch.kernels.slot_count.slot_count import \
        LAUNCH_COUNTS as COUNT_COUNTS
    from repro_torch.obs import rank_digest
    from repro_torch.serve import IngestQueue, QueryClient, RankStore, \
        ServeEngine, ServeMetrics
    ingest = IngestQueue(flush_size=FLUSH, flush_interval=1e9,
                         device=dev)
    store, metrics = RankStore(), ServeMetrics()
    eng = ServeEngine(graph, ingest, store, metrics=metrics,
                      method="frontier_prune", engine=engine_name,
                      kernel_opts=kernel_opts)
    client = QueryClient(store, ingest, metrics)
    engine_name = label or engine_name
    rng = np.random.default_rng(SEED)
    for c in (LAUNCH_COUNTS, PULL_COUNTS, COUNT_COUNTS):
        c.clear()                             # counts of this run only
    if sites:
        torch.cuda.memory._record_memory_history(
            enabled="all", context="alloc", stacks="python",
            max_entries=1 << 22)
        seen = malloc_sites(torch, 0)[0]
    t0 = time.perf_counter()
    eng.bootstrap()
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    geometry = (None if eng.kernel_geometry is None
                else eng.kernel_geometry.describe())
    print(f"  [{engine_name}] bootstrap (static f64 solve"
          f"{'' if geometry is None else ' + pack at ' + geometry}) "
          f"{boot_s:.2f} s")
    if sites:
        seen, made = malloc_sites(torch, seen)
        print(f"  [{engine_name}, allocator history] bootstrap: "
              f"{len(made)} cudaMalloc, "
              f"{sum(m[0] for m in made) / 2**20:.1f} MiB")
    rows = []
    for b, events in enumerate(feed):
        for kind, u, v in events:
            ingest.submit(kind, u, v)
        before = LAUNCH_COUNTS["frontier_spmv"]
        counts0 = count_marks(torch, CACHE_BUILDS, COUNT_COUNTS)
        retries = alloc_retries(torch)
        profile = args.profile and not sites and b == len(feed) - 1
        with profiled(torch, profile, f"{engine_name}_batch{b}", args):
            with recording_syncs(torch) as syncs:
                check(eng.step(force=True),
                      f"[{engine_name}] batch {b} served")
        launches = LAUNCH_COUNTS["frontier_spmv"] - before
        counted = {k: v - counts0[k] for k, v in
                   count_marks(torch, CACHE_BUILDS, COUNT_COUNTS).items()}
        m = metrics
        row = dict(batch=b, events=m.batch_events[-1],
                   latency_ms=m.update_latency_s[-1] * 1e3,
                   iterations=m.batch_iterations[-1],
                   affected=m.batch_affected[-1], launches=launches,
                   host_syncs=m.batch_host_syncs[-1],
                   measured_syncs=len(syncs),
                   alloc_retries=alloc_retries(torch) - retries,
                   fallback=m.static_fallbacks, **counted)
        if row["host_syncs"] != row["measured_syncs"]:
            print(f"  [{engine_name}] batch {b}: synchronizing calls by "
                  f"site {sync_sites(syncs)}")
        check(row["host_syncs"] == row["measured_syncs"],
              f"[{engine_name}] batch {b}: host_syncs {row['host_syncs']} "
              f"== {len(syncs)} synchronizing calls (set_sync_debug_mode)")
        pt = client.get_ranks(rng.integers(0, graph.num_vertices, size=8))
        top = client.top_k(10)
        check(bool(np.all(np.isfinite(pt.ranks)))
              and top.generation == b + 1 and len(top.vertices) == 10,
              f"[{engine_name}] batch {b}: queries answered at generation "
              f"{top.generation}")
        row["digest"] = rank_digest(store.snapshot().ranks)
        rows.append(row)
        print(f"  [{engine_name}] batch {b}: events={row['events']} "
              f"latency_ms={row['latency_ms']:.2f} "
              f"iterations={row['iterations']} affected={row['affected']:,} "
              f"launches={launches} host_syncs={row['host_syncs']} "
              f"(measured {row['measured_syncs']}) "
              f"alloc_retries={row['alloc_retries']} "
              f"top1={top.vertices[0]}; {count_text(counted)}; peak "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        check(counted["orders"] == 1 and counted["slot_count"] == 1
              and counted["segment_bounds"] == 1
              and counted["out_degrees"] == 1,
              f"[{engine_name}] batch {b}: one order built (one "
              f"segment_bounds), one out-degree count (one slot_count), "
              f"{counted['segment_or']} push_or, each one segment_or")
        if sites:
            seen, made = malloc_sites(torch, seen)
            row["malloc_sites"] = made
            print(f"  [{engine_name}, allocator history] batch {b}: "
                  f"{len(made)} cudaMalloc, "
                  f"{sum(m[0] for m in made) / 2**20:.1f} MiB"
                  + "".join(f"\n    {m[0] / 2**20:.1f} MiB at {m[1]}"
                            for m in made), flush=True)
    if sites:
        torch.cuda.memory._record_memory_history(enabled=None)
    # read right after the run
    launches = dict(LAUNCH_COUNTS, pull_contrib=PULL_COUNTS["pull_contrib"],
                    **COUNT_COUNTS)
    snap = store.snapshot()
    return dict(boot_s=boot_s, rows=rows, launches=launches,
                metrics=metrics.as_dict(), geometry=geometry,
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
    table = events.table(sort_by="self_device_time_total", row_limit=40)
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
    check(kernel["launches"].get("frontier_spmv", 0) > 0
          and kernel["launches"]["pull_contrib"] > 0,
          f"frontier_spmv and pull_contrib launched on the kernel run "
          f"({kernel['launches'].get('frontier_spmv', 0)} and "
          f"{kernel['launches']['pull_contrib']} launches)")
    xla, snap_x = serve_run(args, torch, dev, graph, feed, "xla")
    check(xla["launches"].get("frontier_spmv", 0) == 0
          and xla["launches"]["pull_contrib"] > 0,
          f"the xla run launched no frontier_spmv, and pull_contrib "
          f"{xla['launches']['pull_contrib']} times")
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
    # the same feed again on the kernel engine: served ranks must be the
    # same bit for bit from run to run
    again, snap_k2 = serve_run(args, torch, dev, graph, feed, "kernel")
    repeat = dict(
        snapshot_bitwise=bool(torch.equal(snap_k2.ranks, rk)),
        linf=float((snap_k2.ranks - rk).abs().max()),
        iterations_equal=[a["iterations"] for a in again["rows"]]
        == [a["iterations"] for a in kernel["rows"]],
        affected_equal=[a["affected"] for a in again["rows"]]
        == [a["affected"] for a in kernel["rows"]])
    check(repeat["iterations_equal"] and repeat["affected_equal"],
          "kernel engine run twice on one feed: per-batch iterations and "
          "affected counts equal")
    check(repeat["snapshot_bitwise"],
          f"kernel engine run twice on one feed: final snapshots bitwise "
          f"equal (L_inf {repeat['linf']:.3e})")
    # the same feed at the fixed geometry of PRs 11-23 (BE 512, VB 256):
    # the tuned geometry's latencies beside it, in this run
    fixed, snap_f = serve_run(args, torch, dev, graph, feed, "kernel",
                              kernel_opts=dict(be=512, vb=256),
                              label="kernel (512, 256)")
    linf_f = float((snap_f.ranks - rk).abs().max())
    check(linf_f <= 1e-6, f"kernel engine at (512, 256) vs the tuned "
          f"geometry: final snapshot L_inf {linf_f:.3e} <= 1e-6")
    del snap_f
    geometry_ab = {}
    for tag, r in (("tuned", kernel), ("tuned again", again),
                   ("fixed (512, 256)", fixed)):
        lat = [row["latency_ms"] for row in r["rows"]]
        geometry_ab[tag] = dict(
            geometry=r["geometry"], latency_ms=lat,
            median_ms=sorted(lat)[len(lat) // 2], max_ms=max(lat),
            max_batch=lat.index(max(lat)),
            cuda_mallocs=[row["cuda_mallocs"] for row in r["rows"]])
        g = geometry_ab[tag]
        print(f"  [geometry] {tag} {g['geometry']}: latency a batch "
              f"median {g['median_ms']:.2f} ms, max {g['max_ms']:.2f} ms "
              f"(batch {g['max_batch']}); every batch "
              f"{[round(x, 2) for x in lat]} ms; cudaMalloc a batch "
              f"{g['cuda_mallocs']}", flush=True)
    # where the kernel engine's cudaMalloc calls come from: the feed once
    # more from a released cache, as the first run began, with the
    # allocator's history recorded (not timed)
    torch.cuda.empty_cache()
    traced, snap_t = serve_run(args, torch, dev, graph, feed, "kernel",
                               sites=True)
    check(torch.equal(snap_t.ranks, rk), "kernel engine with the "
          "allocator's history recorded: final snapshot bitwise equal")
    del snap_t
    return dict(kernel=kernel, xla=xla, kernel_again=again,
                kernel_fixed=fixed, geometry_ab=geometry_ab,
                linf_fixed_vs_tuned=linf_f,
                kernel_traced=traced, kernel_repeat=repeat,
                final_ranks=rk,
                linf_kernel_vs_xla=linf,
                rel_linf_kernel_vs_xla=rel,
                l1_kernel_vs_static=l1_k, l1_xla_vs_static=l1_x,
                static_iterations=static.iterations)


def walk_repair_bound(torch, csr, rows, t0, key, ids, out):
    """(bound_ms, bound_by, detail) for one walk_repair launch on these
    inputs: the larger of the bytes this run's walks need over the card's
    memory rate and the threefry calls they need over its INT32 rate.

    Bytes, each read once: the kept prefix slots rows[0..t0], t0, the
    walk ids, deg/indptr of the current vertex for every hop taken past
    t0 and the indices entry of every such hop off the self-loop (each
    counted once per distinct entry), and the output.  Threefry calls: a
    walk key for each walk with a hop to draw, a hop key and a continue
    draw for every hop from an occupied slot, and a choice draw for every
    hop taken past t0 (a slot is -1 exactly when the walk has stopped,
    as in an index's rows); ``kernels.work.THREEFRY_OPS`` integer operations
    each."""
    from repro_torch.kernels.walk_repair.threefry import walk_uniforms
    C, L = rows.shape
    E = csr.indices.shape[0]
    hop = torch.arange(1, L, device=rows.device)
    drawn = (rows[:, 0] >= 0) & (t0 < L - 1)       # walks that draw at all
    prev, nxt = out[:, :-1], out[:, 1:]
    n_keys = int(drawn.sum())
    n_cont = int(((prev >= 0) & drawn[:, None]).sum())
    taken = (hop[None, :] > t0[:, None]) & (nxt >= 0)
    cur = prev[taken].long()
    d = csr.deg[cur]
    u = walk_uniforms(key, ids, L)
    j = torch.minimum((u[:, :, 1][taken] * (d + 1).to(torch.float32))
                      .to(torch.int32), d)
    del u
    edge = j < d
    idx = (csr.indptr[cur][edge] + j[edge]).clamp(0, E - 1)
    n_taken = int(cur.numel())
    n_cur = int(torch.unique(cur).numel())
    n_idx = int(torch.unique(idx).numel())
    calls = n_keys + 2 * n_cont + n_taken
    from repro_torch.kernels import work
    int_ops, nbytes = work.walk_repair_work(C, L, int((t0.long() + 1).sum()),
                                            n_cur, n_idx, calls)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = int_ops / H100_INT32_OPS * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, dict(bytes=nbytes, int_ops=int_ops,
                                         threefry_calls=calls,
                                         bytes_ms=t_bytes, ops_ms=t_ops,
                                         walks=C, hops_evaluated=n_cont,
                                         hops_taken=n_taken,
                                         distinct_vertices=n_cur,
                                         distinct_edges=n_idx)


def alloc_retries(torch) -> int:
    """Times the caching allocator found no free block, released its cache
    and asked the driver again (a device-wide synchronization each)."""
    return torch.cuda.memory_stats().get("num_alloc_retries", 0)


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
    from repro_torch.kernels.pull_contrib.pull_contrib import \
        LAUNCH_COUNTS as PULL_COUNTS
    from repro_torch.kernels.walk_repair import walk_repair as wr
    from repro_torch.kernels.walk_repair.ref import resample_rows_keyed_ref
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

    # CUDA events around the repair, its stale scan, its resample and
    # each kernel launch give device time without adding a host sync; the
    # current batch's launches keep their inputs and outputs for the
    # bitwise check
    rec = dict(build_s=None, repair=[], scan=[], resample=[], kernel=[],
               calls=[])
    real = dict(build=serve_engine.build_walk_index,
                repair=serve_engine.repair_walk_index,
                scan=ppr_repair.stale_walks, resample=ppr_repair._resample,
                kernel=ppr_repair.resample_rows)

    def timed_build(graph_, config):
        torch.cuda.synchronize()
        t = time.perf_counter()
        index = real["build"](graph_, config)
        torch.cuda.synchronize()
        rec["build_s"] = time.perf_counter() - t
        return index

    def timed(name, keep=None):
        def call(*a, **kw):
            start, stop = cuda_events(torch)
            start.record()
            out = real[name](*a, **kw)
            stop.record()
            rec[name].append((start, stop))
            if keep is not None:
                rec[keep].append((a, kw, out))
            return out
        return call

    def timed_repair(index, graph_new, touched):
        rec["old"] = (index, touched)
        return timed("repair")(index, graph_new, touched)

    def elapsed(name):
        return sum(a.elapsed_time(z) for a, z in rec[name])

    ingest = IngestQueue(flush_size=FLUSH, flush_interval=1e9, device=dev)
    store, metrics = RankStore(), ServeMetrics()
    eng = ServeEngine(graph, ingest, store, metrics=metrics,
                      method="frontier_prune", engine="kernel",
                      ppr_index=cfg)
    client = QueryClient(store, ingest, metrics)
    rows, stale_total = [], 0
    serve_engine.build_walk_index = timed_build
    serve_engine.repair_walk_index = timed_repair
    ppr_repair.stale_walks = timed("scan")
    ppr_repair._resample = timed("resample")
    ppr_repair.resample_rows = timed("kernel", keep="calls")
    try:
        SPMV_COUNTS.clear()                   # counts of this run only
        PULL_COUNTS.clear()
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
            for k in ("repair", "scan", "resample", "kernel", "calls"):
                rec[k].clear()
            before = wr.LAUNCH_COUNTS["walk_repair"]
            retries = alloc_retries(torch)
            profile = args.profile and b == len(feed) - 1
            with profiled(torch, profile, f"ppr_batch{b}", args):
                with recording_syncs(torch) as syncs:
                    check(eng.step(force=True), f"[ppr] batch {b} served")
            launches = wr.LAUNCH_COUNTS["walk_repair"] - before
            rec["repair"][-1][1].synchronize()
            repair_ms, scan_ms = elapsed("repair"), elapsed("scan")
            resample_ms, kernel_ms = elapsed("resample"), elapsed("kernel")
            old, touched = rec.pop("old")
            stale = int(real["scan"](old.steps, touched)[0].sum())
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
                       scan_ms=scan_ms, kernel_ms=kernel_ms,
                       copy_gather_scatter_ms=resample_ms - kernel_ms,
                       csr_and_compaction_ms=(repair_ms - scan_ms
                                              - resample_ms),
                       launches=launches,
                       host_syncs=metrics.batch_host_syncs[-1],
                       measured_syncs=len(syncs),
                       alloc_retries=alloc_retries(torch) - retries,
                       iterations=metrics.batch_iterations[-1],
                       query_ms=q_ms)
            rows.append(row)
            print(f"  [ppr] batch {b}: latency_ms={row['latency_ms']:.2f} "
                  f"stale_walks={stale:,} repair_ms={repair_ms:.2f} (stale "
                  f"scan {scan_ms:.2f}, draws + kernel {kernel_ms:.3f}, "
                  f"index copy + row gather + scatter "
                  f"{row['copy_gather_scatter_ms']:.2f}, CSR build + stale-id "
                  f"compaction {row['csr_and_compaction_ms']:.2f}) "
                  f"launches={launches} host_syncs={row['host_syncs']} "
                  f"(measured {len(syncs)}) alloc_retries="
                  f"{row['alloc_retries']} iterations={row['iterations']} "
                  f"index_top10_ms={', '.join(f'{x:.2f}' for x in q_ms)}",
                  flush=True)
            if row["host_syncs"] != len(syncs):
                print(f"  [ppr] batch {b}: synchronizing calls by site "
                      f"{sync_sites(syncs)}")
            check(row["host_syncs"] == len(syncs),
                  f"[ppr] batch {b}: host_syncs {row['host_syncs']} == "
                  f"{len(syncs)} synchronizing calls (set_sync_debug_mode)")
        launches = dict(walk_repair=wr.LAUNCH_COUNTS["walk_repair"],
                        frontier_spmv=SPMV_COUNTS["frontier_spmv"],
                        pull_contrib=PULL_COUNTS["pull_contrib"])
        stream_peak = torch.cuda.max_memory_allocated()
    finally:
        serve_engine.build_walk_index = real["build"]
        serve_engine.repair_walk_index = real["repair"]
        ppr_repair.stale_walks = real["scan"]
        ppr_repair._resample = real["resample"]
        ppr_repair.resample_rows = real["kernel"]
    check(all(v > 0 for v in launches.values()),
          f"walk_repair, frontier_spmv and pull_contrib launched on the PPR "
          f"serve path ({launches})")
    check(metrics.walks_resampled == stale_total,
          f"walks_resampled {metrics.walks_resampled:,} == summed stale "
          f"counts {stale_total:,}")

    # the kernel on the serve path against its plain version, bit for bit
    calls = list(rec["calls"])
    rec["calls"].clear()
    check(len(calls) > 0, f"the last batch launched walk_repair "
          f"({len(calls)} launches)")
    max_err = 0
    for (csr, r_, t_, key, ids), kw, out in calls:
        ref = resample_rows_keyed_ref(csr, r_, t_, key, ids, **kw)
        max_err = max(max_err, int((out - ref).abs().max()))
        check(torch.equal(out, ref), f"last batch, {r_.shape[0]:,} walks: "
              "kernel == plain, bit for bit")
        del ref
    (csr, r_, t_, key, ids), kw, out = max(calls,
                                            key=lambda c: c[0][1].shape[0])
    call = lambda: wr.resample_rows(csr, r_, t_, key, ids, **kw)
    ms, call_host_ms = time_ms(torch, call), host_ms(torch, call)
    call_device_ms = device_ms(torch, call, ("walk_repair",))
    plain_ms = time_ms(torch, lambda: resample_rows_keyed_ref(
        csr, r_, t_, key, ids, **kw), reps=3, warmup=1)
    bound_ms, bound_by, detail = walk_repair_bound(torch, csr, r_, t_, key,
                                                   ids, out)
    info = wr.kernel_info(r_.shape[1])
    dev_txt = ("not measured" if call_device_ms is None
               else f"{call_device_ms:.4f}")
    print(f"  walk_repair at {r_.shape[0]:,} walks x L={r_.shape[1]}: "
          f"kernel_ms={ms:.4f} (host {call_host_ms:.4f}, device {dev_txt}) "
          f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) "
          f"{detail}", flush=True)
    print(f"  walk_repair: {info['registers']} registers a thread, "
          f"{info['smem_per_block']:,} B of shared memory a block "
          f"({info['walks_per_block']} walks), {info['blocks_per_sm']} "
          f"blocks of 128 threads a SM on {info['sms']} SMs", flush=True)
    del calls, csr, r_, t_, ids, out

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
                    ms=ms, host_ms=call_host_ms, device_ms=call_device_ms,
                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                    max_abs_err=float(max_err), info=info, **detail),
                fresh_build_s=fresh_s, exact=exact,
                peak_bytes_stream=stream_peak, peak_bytes=peak)


@contextlib.contextmanager
def recording_syncs(torch):
    """Yields a list that, after the block, holds one warning for each
    synchronizing CUDA call torch made inside it
    (``torch.cuda.set_sync_debug_mode("warn")``).  Only the warning that
    names such a call counts: the first switch into the mode also warns,
    once a process, that the mode is a prototype."""
    import warnings
    syncs = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield syncs
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs.extend(w for w in caught if SYNC_WARNING in str(w.message))


def sync_sites(syncs) -> dict:
    """{"file:line": count} of recorded synchronizing calls."""
    return dict(collections.Counter(
        f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
        for w in syncs).most_common())


def compare_rows(out, ref, rows=None, chunk=1 << 18):
    """(max abs err, largest |ref|, elements out of tolerance) of ``out``
    against ``ref`` on the rows where ``rows`` holds (all rows if None):
    |out - ref| <= GNN_ATOL * largest |ref| + GNN_RTOL * |ref|.  Taken
    ``chunk`` rows at a time, so no full-size temporary is made."""
    def parts():
        for s in range(0, ref.shape[0], chunk):
            a, b = out[s:s + chunk], ref[s:s + chunk]
            if rows is not None:
                a, b = a[rows[s:s + chunk]], b[rows[s:s + chunk]]
            if b.numel():
                yield a, b
    big = max((float(b.abs().max()) for _, b in parts()), default=0.0)
    err, bad = 0.0, 0
    for a, b in parts():
        diff = (a - b).abs()
        err = max(err, float(diff.max()))
        bad += int((diff > GNN_ATOL * big + GNN_RTOL * b.abs()).sum())
    return err, big, bad


def zero_rows(out, rows, chunk=1 << 18) -> bool:
    """True iff ``out`` is exactly 0 on the rows where ``rows`` holds."""
    return all(bool((out[s:s + chunk][rows[s:s + chunk]] == 0).all())
               for s in range(0, out.shape[0], chunk))


def spmm_bound(torch, packed, awin, d):
    """(bound_ms, bound_by, detail) for one gated segment-SpMM on these
    inputs: 8 B of src/dst_rel for each live lane of an active entry, 4 B
    of valid for each lane of an active entry, 4*D B for each distinct
    source row those lanes read, entry_start and active_window once, and
    the f32 [num_vertices, D] output written once."""
    ne, be = packed.src.shape
    nw, n = packed.num_windows, packed.num_vertices
    entry_active = awin[packed.window.long()]
    n_act = int(entry_active.sum())
    live = (packed.valid > 0) & entry_active[:, None]
    n_live = int(live.sum())
    n_src = int(torch.unique(packed.src[live]).numel()) if n_live else 0
    from repro_torch.kernels import work
    flops, nbytes = work.gated_spmm_work(be, nw, n, d, n_act, n_live, n_src)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, dict(bytes=nbytes, flops=flops,
                                         active_entries=n_act,
                                         live_lanes=n_live,
                                         distinct_sources=n_src,
                                         gathered_bytes=4 * d * n_live)


def library_spmm(torch, packed, awin):
    """The same gated aggregation as one cuSPARSE call: a CSR matrix of the
    active entries' live lanes (rows: dst, columns: src, values 1) times
    X, built here, outside any timed region."""
    vb, n = packed.vb, packed.num_vertices
    live = (packed.valid > 0) & awin[packed.window.long()][:, None]
    rows = (packed.window.long()[:, None] * vb + packed.dst_rel.long())[live]
    cols = packed.src.long()[live]
    a = torch.sparse_coo_tensor(torch.stack([rows, cols]),
                                torch.ones_like(rows, dtype=torch.float32),
                                (n, n)).coalesce().to_sparse_csr()
    return lambda x: torch.sparse.mm(a, x)


def widest_window(torch, packed):
    """(window id, entries, live lanes) of the window owning most entries."""
    owned = packed.entry_start[1:] - packed.entry_start[:-1]
    hub = int(torch.argmax(owned))
    e0, e1 = int(packed.entry_start[hub]), int(packed.entry_start[hub + 1])
    return hub, e1 - e0, int((packed.valid[e0:e1] > 0).sum())


def spmm_info(packed, d):
    """Prints and returns what gated_spmm holds on the card at this shape:
    K, the scratch bytes (allocated and used), shared memory a block,
    blocks a SM, registers."""
    from repro_torch.kernels.segment_ops import segment_matmul as sm
    info = sm.kernel_info(packed, d)
    print(f"  gated_spmm: K={info['chunk_entries']} entries a chunk, scratch "
          f"{info['scratch_bytes']:,} B ({info['scratch_bytes_used']:,} B "
          f"used by the split windows), shared memory "
          f"{info['smem_per_block']:,} B a block, {info['blocks_per_sm']} "
          f"blocks a SM, {info['registers']} registers a thread, "
          f"{info['lanes_in_flight']} lanes in flight a warp, up to "
          f"{info['inflight_bytes_per_sm']:,} B of X in flight a SM",
          flush=True)
    return info


def spmm_cases(torch, packed, feats, gen, batch_awin, plain):
    """gated_spmm at this shape, as phase 3 has frontier_spmv: windows
    active at random at 0 %, ~5 % and 100 %, the last batch's own
    ``batch_awin``, only the widest window (``hub``) and every window but
    it (``rest``).  Each case is checked against the plain version
    (``plain(packed, active_window)``), for exact zeros and for bitwise
    equality run to run, then timed beside the plain version and one
    cuSPARSE call, with its bytes bound."""
    from repro_torch.kernels.segment_ops import segment_matmul as sm
    n, d, nw = packed.num_vertices, feats.shape[1], packed.num_windows
    hub, _, _ = widest_window(torch, packed)
    only_hub = torch.arange(nw, device=feats.device) == hub
    cases = []
    for tag, frac in (("0 %", 0.0), ("~5 %", 0.05), ("100 %", 1.0),
                      ("batch", None), ("hub", None), ("rest", None)):
        aw = {"batch": batch_awin, "hub": only_hub,
              "rest": ~only_hub}.get(tag)
        if aw is None:
            aw = torch.rand(nw, generator=gen, device=feats.device) < frac
        out = sm.gated_spmm(packed, feats, aw)
        ref = plain(packed, aw)
        err, _, bad = compare_rows(out, ref)
        check(bad == 0, f"{tag}: kernel == plain (max abs err {err:.3e})")
        check(zero_rows(out, ~aw.repeat_interleave(packed.vb)[:n]),
              f"{tag}: inactive windows exactly 0")
        check(torch.equal(sm.gated_spmm(packed, feats, aw), out),
              f"{tag}: bitwise equal run to run")
        del out
        call = lambda: sm.gated_spmm(packed, feats, aw)
        ms = time_ms(torch, call, reps=5, warmup=1)
        call_host_ms = host_ms(torch, call, reps=5)
        call_device_ms = device_ms(torch, call, ("gated_spmm",), reps=5)
        plain_ms = time_ms(torch, lambda: plain(packed, aw), reps=2,
                           warmup=1)
        bound_ms, bound_by, detail = spmm_bound(torch, packed, aw, d)
        library_ms = None
        try:
            lib = library_spmm(torch, packed, aw)
            lib_out = lib(feats)
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError) as e:
            library_note = (f"torch.sparse.mm refused: "
                            f"{str(e).splitlines()[0]}")
        else:
            lerr, _, bad = compare_rows(lib_out, ref)
            del lib_out
            if bad:
                library_note = (f"cuSPARSE product disagrees with the plain "
                                f"version (max abs err {lerr:.3e})")
            else:
                library_ms = time_ms(torch, lambda: lib(feats), reps=5,
                                     warmup=1)
                library_note = "cuSPARSE CSR SpMM (torch.sparse.mm)"
            del lib
        del ref
        case = dict(case=tag, active_windows=int(aw.sum()), max_abs_err=err,
                    ms=ms, host_ms=call_host_ms, device_ms=call_device_ms,
                    plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=library_ms,
                    library_note=library_note, **detail)
        cases.append(case)
        dev_txt = ("not measured" if call_device_ms is None
                   else f"{call_device_ms:.4f}")
        print(f"  gated_spmm {tag}: kernel_ms={ms:.4f} (host "
              f"{call_host_ms:.4f}, device {dev_txt}) plain_ms="
              f"{plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) "
              f"library_ms="
              f"{'-' if library_ms is None else f'{library_ms:.4f}'} "
              f"({library_note}) active_windows={case['active_windows']:,} "
              f"live_lanes={detail['live_lanes']:,} distinct_sources="
              f"{detail['distinct_sources']:,} bytes={detail['bytes']:,} "
              f"gathered_bytes={detail['gathered_bytes']:,}", flush=True)
    return cases


def pull_rows_bound(torch, order, d):
    """(bound_ms, bound_by, detail) for one neighbour-row sum: ptr and the
    live slots' src once, each distinct source row of x once, the f32
    [V, D] output written once; an add a live slot and column."""
    V = order.ptr.shape[0] - 1
    n_live = int(order.ptr[-1])
    n_src = int(torch.unique(order.src[:n_live]).numel()) if n_live else 0
    from repro_torch.kernels import work
    flops, nbytes = work.pull_rows_work(V, n_live, n_src, d)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, dict(bytes=nbytes, flops=flops,
                                         live_slots=n_live,
                                         distinct_sources=n_src,
                                         gathered_bytes=4 * d * n_live)


# the hot-row budgets phase 6 sweeps pull_rows over, bytes
HOT_SWEEP = (0, 10_000_000, 20_000_000, 30_000_000, 40_000_000)


def hot_set_info(torch, pc, order, n, d, budget):
    """The hot set of rows of ``d`` f32 in ``budget`` bytes, built apart
    from any call: its sources, bytes, share of the live slots, and the
    build's host time (the sources' ranking, then the hot set's table)."""
    rows = min(n, budget // (4 * d))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    count, rank = pc.source_ranking(order, n)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    hot = pc.hot_set(order, n, rows, (count, rank))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n_hot = int(hot.hot.sum())
    n_live = max(int(order.ptr[-1]), 1)
    return dict(budget=budget, sources=n_hot, bytes=4 * d * n_hot,
                share=int(count[hot.hot].sum()) / n_live,
                ranking_ms=(t1 - t0) * 1e3, table_ms=(t2 - t1) * 1e3)


def row_sum_cases(torch, graph, feats):
    """Phase 6, GraphSAGE's neighbour-row sum (``pull_rows``, both layers'
    widths): run twice, bitwise equal; within the GNN tolerance of the
    plain version on the card (atomics); timed beside it and one cuSPARSE
    SpMM of the same matrix, with its bytes bound.  Prints the row path
    taken, the hot set (sources, bytes, share of the live slots, build
    time apart from the call) and a sweep of its budget (``HOT_SWEEP``):
    every budget bitwise equal to budget 0 and run to run."""
    from repro_torch.kernels.pull_contrib import pull_contrib as pc
    from repro_torch.kernels.pull_contrib.ref import ROW_CHUNK, \
        pull_rows_ref
    from repro_torch.kernels.segment_ops.plan import live_plan_sizes
    from repro_torch.models.gnn import neighbor_order
    n = graph.num_vertices
    order = neighbor_order(graph.src, graph.dst, graph.valid, n)
    n_live = int(order.ptr[-1])
    n_empty = int((order.ptr[1:] == order.ptr[:-1]).sum())
    info = pc.kernel_info()
    chunks, parts, splits = live_plan_sizes(n, order.src.shape[0],
                                            ROW_CHUNK)
    paths = ", ".join(f"{p}: {r} registers, {b} blocks a SM"
                      for p, (r, b) in info["row_paths"].items())
    packed = ", ".join(f"{p}: {r}/{b}"
                       for p, (r, b) in info["packed_paths"].items())
    print(f"  pull_rows: K={ROW_CHUNK} slots a chunk, blocks of 128; row "
          f"paths (floats a load x loads a lane) {paths}; packed paths "
          f"(floats a load / lanes a chunk: registers / blocks a SM) "
          f"{packed}; plan bound {chunks:,} chunks, scratch bound "
          f"{parts:,} partial rows, {splits:,} split vertices at most; "
          f"{n_empty:,} of {n:,} rows empty (the fill's)", flush=True)
    a = torch.sparse_csr_tensor(
        order.ptr.long(), order.src[:n_live].long(),
        torch.ones(n_live, dtype=torch.float32, device=feats.device),
        (n, feats.shape[0]), check_invariants=False)
    cases, max_err = [], 0.0
    for d in (feats.shape[1], 128):
        x = feats if d == feats.shape[1] else feats[:, :d].contiguous()
        path = "{}x{}".format(*pc.row_path(d, x.data_ptr()))
        hot = hot_set_info(torch, pc, order, n, d, pc.HOT_BYTES)
        print(f"  pull_rows d={d}: path {path} "
              f"({info['row_paths'][path][0]} registers); hot set "
              f"{hot['sources']:,} sources, {hot['bytes']:,} bytes, "
              f"{100 * hot['share']:.1f} % of the live slots; built "
              f"apart from the call in {hot['ranking_ms']:.3f} ms (ranking) "
              f"+ {hot['table_ms']:.3f} ms (table)", flush=True)
        out = pc.pull_rows(order, x)
        check(torch.equal(pc.pull_rows(order, x), out),
              f"pull_rows d={d}: bitwise equal run to run")
        plain = pull_rows_ref(order, x)
        err, big, bad = compare_rows(out, plain)
        max_err = max(max_err, err)
        check(bad == 0, f"pull_rows d={d}: kernel == plain within the GNN "
              f"tolerance (max abs err {err:.3e}, largest {big:.3e})")
        del out
        call = lambda: pc.pull_rows(order, x)
        ms = time_ms(torch, call, reps=5, warmup=1)
        call_host_ms = host_ms(torch, call, reps=5)
        call_device_ms = device_ms(torch, call, ("pull_rows",), reps=5)
        split_ms = {k: device_ms(torch, call, (f"pull_rows_{k}",), reps=5)
                    for k in ("fill", "tag", "kernel", "split", "release")}
        plain_ms = time_ms(torch, lambda: pull_rows_ref(order, x), reps=2,
                           warmup=1)
        lib_out = torch.sparse.mm(a, x)
        lerr, _, lbad = compare_rows(lib_out, plain)
        del lib_out, plain
        library_ms = (None if lbad else
                      time_ms(torch, lambda: torch.sparse.mm(a, x), reps=5,
                              warmup=1))
        bound_ms, bound_by, detail = pull_rows_bound(torch, order, d)
        case = dict(case=f"d={d}", max_abs_err=err, ms=ms,
                    host_ms=call_host_ms, device_ms=call_device_ms,
                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=library_ms, library_err=lerr, path=path,
                    registers=info["row_paths"][path][0], hot=hot,
                    device_split_ms=split_ms, empty_rows=n_empty, **detail)
        cases.append(case)
        lib_txt = ("- (cuSPARSE disagrees with the plain version, max abs "
                   f"err {lerr:.3e})" if library_ms is None
                   else f"{library_ms:.4f} (cuSPARSE CSR SpMM)")
        dev_txt = ("not measured" if call_device_ms is None
                   else f"{call_device_ms:.4f}")
        print(f"  pull_rows d={d}: kernel_ms={ms:.4f} (host "
              f"{call_host_ms:.4f}, device {dev_txt}) plain_ms="
              f"{plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) "
              f"library_ms={lib_txt} live_slots={n_live:,} "
              f"distinct_sources={detail['distinct_sources']:,} "
              f"gathered_bytes={detail['gathered_bytes']:,}; device by "
              f"launch {split_ms}", flush=True)
        del x
    # the budget sweep, after every other case: the policy moves no sum
    for case in cases:
        d = int(case["case"][2:])
        x = feats if d == feats.shape[1] else feats[:, :d].contiguous()
        base = pc.pull_rows(order, x, hot_bytes=0)
        case["sweep"] = []
        for budget in sorted(set(HOT_SWEEP) | {pc.HOT_BYTES}):
            def call(budget=budget):
                return pc.pull_rows(order, x, hot_bytes=budget)
            got = call()
            same = torch.equal(got, base) and torch.equal(call(), got)
            del got
            check(same, f"pull_rows d={d} budget {budget:,}: bitwise equal "
                  f"to budget 0 and run to run")
            ms = time_ms(torch, call, reps=5, warmup=1)
            h = hot_set_info(torch, pc, order, n, d, budget)
            case["sweep"].append(dict(ms=ms, **h))
            print(f"    sweep d={d} budget {budget:>11,}: {ms:.4f} ms; "
                  f"{h['sources']:,} hot sources, {100 * h['share']:.1f} % "
                  f"of the live slots", flush=True)
        del base, x
    del order, a
    torch.cuda.empty_cache()
    return dict(cases=cases, max_abs_err=max_err, info=info)


def gnn_setup(torch, dev, graph, n, forward=True):
    """Phase 6's inputs: graphsage-reddit features and parameters from the
    seed, the bootstrap forward (if ``forward``) and the packed graph at
    the serve engine's geometry and overlay."""
    from repro_torch.configs.graphsage_reddit import CONFIG
    from repro_torch.kernels.pagerank_spmv.update import pack_graph
    from repro_torch.kernels.segment_ops.ref import gated_spmm_ref
    from repro_torch.models.gnn import GraphBatch, init_sage, sage_forward
    from repro_torch.serve.engine import KERNEL_PACK_DEFAULTS

    d = CONFIG.d_in
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    feats = torch.randn(n, d, generator=gen, device=dev)
    params = init_sage(CONFIG, gen)
    every = torch.ones(n, dtype=torch.bool, device=dev)

    def layer_fn(g, x):
        with torch.no_grad():             # serving: no gradient kept
            return sage_forward(CONFIG, params,
                                GraphBatch(x, g.src, g.dst, g.valid, every))

    def plain(p, aw):
        return gated_spmm_ref(p.src, p.dst_rel, p.valid, p.window, feats,
                              aw, p.num_vertices, p.vb)

    emb, fwd_s = None, 0.0
    if forward:
        t0 = time.perf_counter()
        emb = layer_fn(graph, feats)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the serve engine's geometry and locator overlay (64 batches)
    packed = pack_graph(graph, **KERNEL_PACK_DEFAULTS,
                        overlay_capacity=64 * FLUSH)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    hub, hub_entries, hub_live = widest_window(torch, packed)
    print(f"  {CONFIG.name}: d_in={d} d_hidden={CONFIG.d_hidden} "
          f"classes={CONFIG.n_classes} layers={CONFIG.n_layers}; features "
          f"f32[{n:,}, {d}] = {feats.numel() * 4 / 1e9:.2f} GB")
    print(f"  bootstrap forward {fwd_s:.2f} s; pack {pack_s:.2f} s: "
          f"NE={packed.num_entries:,} NW={packed.num_windows:,} "
          f"BE={packed.be} VB={packed.vb}; largest window {hub} owns "
          f"{hub_entries:,} entries ({hub_live:,} live lanes; mean "
          f"{packed.num_entries / packed.num_windows:.1f} entries)",
          flush=True)
    return dict(config=CONFIG, feats=feats, gen=gen, layer_fn=layer_fn,
                plain=plain, emb=emb, packed=packed, forward_s=fwd_s,
                pack_s=pack_s, hub_window=hub, hub_entries=hub_entries,
                hub_live_lanes=hub_live)


def gnn_checks(args, torch, dev, edges, n, graph):
    """Phase 6: incremental GraphSAGE refresh at graphsage-reddit width,
    and gated_spmm on each batch's affected set."""
    phase("6. GNN refresh at scale (gated_spmm)")
    import numpy as np
    from repro_torch.core.incremental_gnn import incremental_refresh
    from repro_torch.graph.dynamic import apply_batch, make_batch_update, \
        touched_vertices_mask
    from repro_torch.kernels.pagerank_spmv.update import apply_batch_packed
    from repro_torch.kernels.pull_contrib import pull_contrib as pc
    from repro_torch.kernels.segment_ops import segment_matmul as sm
    from repro_torch.kernels.segment_ops.ops import aggregate_features
    from repro_torch.models.gnn import neighbor_sum

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    setup = gnn_setup(torch, dev, graph, n)
    cfg, feats, gen = setup["config"], setup["feats"], setup["gen"]
    layer_fn, plain = setup["layer_fn"], setup["plain"]
    emb, packed = setup["emb"], setup["packed"]

    feed = make_feed(args, edges, n)[:GNN_BATCHES]
    rows, max_err = [], 0.0
    sm.LAUNCH_COUNTS.clear()                  # counts of this run only
    pc.LAUNCH_COUNTS.clear()
    row_launches = 0
    for b, events in enumerate(feed):
        dele = np.asarray([(u, v) for k, u, v in events if k == "delete"],
                          np.int32).reshape(-1, 2)
        ins = np.asarray([(u, v) for k, u, v in events if k == "insert"],
                         np.int32).reshape(-1, 2)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        mallocs = cuda_mallocs(torch)
        with recording_syncs(torch) as syncs:
            t0 = time.perf_counter()
            ev[0].record()
            upd = make_batch_update(dele, ins, FLUSH, FLUSH, device=dev)
            graph2 = apply_batch(graph, upd)
            ev[1].record()
            packed2 = apply_batch_packed(packed, upd)
            ev[2].record()
            touched = touched_vertices_mask(upd, n)
            before = pc.LAUNCH_COUNTS["pull_rows"]
            res = incremental_refresh(graph2, feats, emb, touched,
                                      layer_fn=layer_fn,
                                      n_layers=cfg.n_layers)
            row_launches += pc.LAUNCH_COUNTS["pull_rows"] - before
            affected = touched | graph2.push_or(touched)
            ev[3].record()
            agg = aggregate_features(packed2, feats, affected)
            ev[4].record()
            recomputed = int(res.nodes_recomputed)   # the batch's read
            latency_ms = (time.perf_counter() - t0) * 1e3
        mallocs = cuda_mallocs(torch) - mallocs
        if b == 0:                     # where the first batch's syncs are
            print(f"  [gnn] batch 0 host syncs by call site: "
                  f"{sync_sites(syncs)}")
        split = [a.elapsed_time(z) for a, z in zip(ev[:-1], ev[1:])]
        awin = packed2.active_windows(affected)
        vmask = awin.repeat_interleave(packed2.vb)[:n]
        ever = int(res.affected_ever.sum())
        row = dict(batch=b, latency_ms=latency_ms, kernel_ms=split[3],
                   update_ms=split[0], packed_update_ms=split[1],
                   refresh_ms=split[2], nodes_recomputed=recomputed,
                   affected_ever=ever, affected=int(affected.sum()),
                   active_windows=int(awin.sum()),
                   active_share=float(awin.float().mean()),
                   host_syncs=len(syncs),
                   cuda_mallocs=mallocs)
        print(f"  [gnn] batch {b}: latency_ms={latency_ms:.2f} "
              f"(update {split[0]:.2f}, packed {split[1]:.2f}, refresh "
              f"{split[2]:.2f}, gated_spmm {split[3]:.3f} ms device) "
              f"nodes_recomputed={recomputed:,} affected_ever={ever:,} "
              f"kernel affected={row['affected']:,} active windows "
              f"{row['active_windows']:,}/{packed2.num_windows:,} "
              f"({100 * row['active_share']:.1f} %) host_syncs={len(syncs)} "
              f"cudaMalloc={row['cuda_mallocs']}", flush=True)
        # (a) the kernel against its plain version on the same inputs
        ref = plain(packed2, awin)
        err, big, bad = compare_rows(agg, ref)
        max_err = max(max_err, err)
        del ref
        check(bad == 0, f"[gnn] batch {b}: (a) kernel == plain (max abs err "
              f"{err:.3e}, largest {big:.3e})")
        # (b) its active rows against sage_forward's layer-1 neighbour sum
        nsum = neighbor_sum(feats, graph2.src, graph2.dst, graph2.valid, n)
        err_b, big_b, bad = compare_rows(agg, nsum, vmask)
        del nsum
        check(bad == 0, f"[gnn] batch {b}: (b) kernel == layer-1 neighbour "
              f"sum on active windows (max abs err {err_b:.3e}, largest "
              f"{big_b:.3e})")
        # (c) the refreshed embeddings against a full forward, where
        # refreshed
        exact = layer_fn(graph2, feats)
        err_c, big_c, bad = compare_rows(res.embeddings, exact,
                                         res.affected_ever)
        stale = float((res.embeddings - exact).abs().max())
        check(bad == 0, f"[gnn] batch {b}: (c) refreshed embeddings == full "
              f"forward on affected_ever (max abs err {err_c:.3e}, largest "
              f"{big_c:.3e}; elsewhere stale by up to {stale:.3e})")
        # (d) inactive windows exactly 0
        check(zero_rows(agg, ~vmask),
              f"[gnn] batch {b}: (d) inactive windows exactly 0")
        row.update(err_plain=err, err_neighbor_sum=err_b,
                   err_refresh=err_c, stale_elsewhere=stale)
        rows.append(row)
        del agg, exact
        graph, packed, emb = graph2, packed2, res.embeddings
        del res, graph2, packed2
    launches = sm.LAUNCH_COUNTS["gated_spmm"]   # read right after the run
    stream_peak = torch.cuda.max_memory_allocated()
    check(launches == len(feed) and launches > 0,
          f"[gnn] (e) gated_spmm launched {launches} times for "
          f"{len(feed)} calls")
    check(row_launches == cfg.n_layers * len(feed),
          f"[gnn] (f) pull_rows launched {row_launches} times in the "
          f"refreshes (one a layer of each batch's forward)")
    rows_sum = row_sum_cases(torch, graph, feats)

    info = spmm_info(packed, feats.shape[1])
    cases = spmm_cases(torch, packed, feats, gen, awin, plain)
    max_err = max([max_err] + [c["max_abs_err"] for c in cases])
    peak = torch.cuda.max_memory_allocated()
    phase_s = time.perf_counter() - t_phase
    print(f"  peak device memory: {stream_peak / 2**30:.2f} GiB in the "
          f"stream, {peak / 2**30:.2f} GiB in the phase; phase "
          f"{phase_s:.1f} s")
    return dict(**{k: setup[k] for k in (
        "forward_s", "pack_s", "hub_window", "hub_entries",
        "hub_live_lanes")}, spmm=info, rows=rows, launches=launches,
        row_launches=row_launches, row_sum=rows_sum,
        max_abs_err=max_err, cases=cases, peak_bytes_stream=stream_peak,
        peak_bytes=peak, phase_s=phase_s)


def gnn_kernel_cases(args, torch, dev, edges, n, graph):
    """``--gnn-kernels-only``: phase 6's set-up, its pull_rows cases on
    the set-up graph and its gated_spmm cases, the ``batch`` case on the
    first batch's affected set, with no stream and no refresh (for
    iterating on the kernels)."""
    phase("6. pull_rows and gated_spmm kernel cases only")
    from repro_torch.graph.dynamic import apply_batch, make_batch_update, \
        touched_vertices_mask
    from repro_torch.kernels.pagerank_spmv.update import apply_batch_packed
    import numpy as np
    setup = gnn_setup(torch, dev, graph, n, forward=False)
    events = make_feed(args, edges, n)[0]
    pairs = {k: np.asarray([(u, v) for kind, u, v in events if kind == k],
                           np.int32).reshape(-1, 2)
             for k in ("delete", "insert")}
    upd = make_batch_update(pairs["delete"], pairs["insert"], FLUSH, FLUSH,
                            device=dev)
    graph2 = apply_batch(graph, upd)
    packed = apply_batch_packed(setup["packed"], upd)
    touched = touched_vertices_mask(upd, n)
    awin = packed.active_windows(touched | graph2.push_or(touched))
    del graph2
    rows_sum = row_sum_cases(torch, graph, setup["feats"])
    info = spmm_info(packed, setup["feats"].shape[1])
    cases = spmm_cases(torch, packed, setup["feats"], setup["gen"], awin,
                       setup["plain"])
    return dict(**{k: setup[k] for k in (
        "pack_s", "hub_window", "hub_entries", "hub_live_lanes")},
        spmm=info, cases=cases, row_sum=rows_sum)


def scipy_pagerank(src, dst, n, alpha=0.85, tol=1e-10, max_iter=500):
    """f64[n]: static PageRank of the edges (src, dst) with an implicit
    self-loop on every vertex, by SciPy's CSR product on the host, the
    port's update rule and stopping test: a witness that shares no code
    with the port."""
    import numpy as np
    import scipy.sparse as sp
    deg = np.bincount(src, minlength=n).astype(np.float64) + 1.0
    a = sp.csr_matrix((np.ones(len(src)), (dst, src)), shape=(n, n))
    r = np.full(n, 1.0 / n)
    for _ in range(max_iter):
        r_new = (1.0 - alpha) / n + alpha * (a @ (r / deg) + r / deg)
        delta = float(np.abs(r_new - r).max())
        r = r_new
        if delta <= tol:
            break
    return r


def paper_checks(args, torch, dev, edges, n, graph):
    """Phase 7: the paper's five methods on both engines over random
    batches of two sizes, each batch's L1 against a static f64 solve of
    its graph; then checkpointed restart through the streaming driver's
    loop and its command line."""
    phase("7. paper methods and restart at scale")
    import shutil
    import tempfile
    from repro_torch.core.api import METHODS
    from repro_torch.core.pagerank import static_pagerank
    from repro_torch.ft.checkpoint import CheckpointManager
    from repro_torch.graph.dynamic import apply_batch, make_batch_update
    from repro_torch.graph.structure import CACHE_BUILDS
    from repro_torch.graph.generators import random_batch_update
    from repro_torch.kernels.pagerank_spmv.pagerank_spmv import \
        LAUNCH_COUNTS as SPMV_COUNTS
    from repro_torch.kernels.pagerank_spmv.update import pack_graph
    from repro_torch.kernels.pull_contrib.pull_contrib import \
        LAUNCH_COUNTS as PULL_COUNTS
    from repro_torch.kernels.slot_count.slot_count import \
        LAUNCH_COUNTS as COUNT_COUNTS
    from repro_torch.launch.pagerank import restore_stream, run_batches
    from repro_torch.serve.engine import KERNEL_PACK_DEFAULTS

    t_phase = time.perf_counter()
    sizes = (FLUSH, round(PAPER_BATCH_FRAC * len(edges)))
    batches = min(PAPER_BATCHES, args.batches)
    t0 = time.perf_counter()
    base = static_pagerank(graph).ranks
    torch.cuda.synchronize()
    print(f"  set-up graph: |V|={n:,} live edges {len(edges):,} in "
          f"{graph.edge_capacity:,} slots; static f64 solve "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    # the serve engine's geometry, an overlay for every batch's insertions
    packed0 = pack_graph(graph, **KERNEL_PACK_DEFAULTS,
                         overlay_capacity=2 * batches * max(sizes))
    torch.cuda.synchronize()
    print(f"  pack for the kernel engine {time.perf_counter() - t0:.2f} s",
          flush=True)
    counts = (COUNT_COUNTS, PULL_COUNTS, SPMV_COUNTS)
    runs = []
    for size in sizes:
        updates, refs, g = [], [], graph
        for b in range(batches):
            dele, ins = random_batch_update(edges, n, size,
                                            seed=SEED + 100 * size + b)
            updates.append(make_batch_update(dele, ins, size, size,
                                             device=dev))
            g = apply_batch(g, updates[-1])
            refs.append(static_pagerank(g).ranks)
        witness = None
        if size == sizes[0]:
            # the yardstick itself, held to a solve of the last graph that
            # shares no code with the port
            t0 = time.perf_counter()
            live = g.valid.cpu().numpy()
            witness = torch.from_numpy(scipy_pagerank(
                g.src.cpu().numpy()[live], g.dst.cpu().numpy()[live],
                n)).to(dev)
            l1 = float((refs[-1] - witness).abs().sum())
            print(f"  batch {size:,}, last graph: static f64 solve vs SciPy "
                  f"witness L1 {l1:.3e} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
            check(l1 <= 1e-4, f"static f64 solve vs the SciPy witness: L1 "
                  f"{l1:.3e} <= 1e-4")
        del g
        for method in METHODS:
            for engine in ("xla", "kernel"):
                for c in counts:
                    c.clear()                 # counts of this run only
                marks = [count_marks(torch, CACHE_BUILDS, COUNT_COUNTS)]

                def log(msg, marks=marks):
                    marks.append(count_marks(torch, CACHE_BUILDS,
                                             COUNT_COUNTS))
                _, final, rows = run_batches(
                    graph, base, lambda i: updates[i], 0, batches, method,
                    reference=lambda i, g: refs[i], engine=engine,
                    packed=packed0 if engine == "kernel" else None, log=log)
                launches = dict(slot_count=COUNT_COUNTS["slot_count"],
                                segment_bounds=COUNT_COUNTS["segment_bounds"],
                                segment_or=COUNT_COUNTS["segment_or"],
                                pull_contrib=PULL_COUNTS["pull_contrib"],
                                frontier_spmv=SPMV_COUNTS["frontier_spmv"])
                for row, a, z in zip(rows, marks[:-1], marks[1:]):
                    row.update({k: z[k] - a[k] for k in z})
                l1_witness = (None if witness is None else
                              float((final - witness).abs().sum()))
                runs.append(dict(size=size, method=method, engine=engine,
                                 rows=rows, launches=launches,
                                 l1_witness=l1_witness))
                print(f"  [{engine}] {method} batch {size:,}: " + "; ".join(
                    f"{r['ms']:.2f} ms, {r['iterations']} it, affected "
                    f"{r['affected']:,}, L1 {r['l1']:.3e}, syncs "
                    f"{r['host_syncs']}, {count_text(r)}"
                    for r in rows) + f"; launches {launches}"
                    + ("" if witness is None else
                       f"; last batch L1 vs SciPy {l1_witness:.3e}"),
                    flush=True)
                worst = max([r["l1"] for r in rows]
                            + ([] if witness is None else [l1_witness]))
                check(worst <= 1e-4, f"[{engine}] {method} batch {size:,}: "
                      f"L1 vs static f64 (and SciPy) {worst:.3e} <= 1e-4")
                check(launches["slot_count"] > 0
                      and launches["segment_bounds"] > 0
                      and launches["pull_contrib"] > 0
                      and (engine == "xla")
                      == (launches["frontier_spmv"] == 0),
                      f"[{engine}] {method}: slot_count, segment_bounds and "
                      f"pull_contrib launched, frontier_spmv "
                      f"{'not ' if engine == 'xla' else ''}launched")
                check(all(r["orders"] == 1 and r["out_degrees"] == 1
                          for r in rows),
                      f"[{engine}] {method}: one order and one out-degree "
                      f"count built a batch")
        del updates, refs, witness
    del packed0
    torch.cuda.empty_cache()

    # restart through the driver's loop: 3 batches uninterrupted; 2 with a
    # checkpoint every 2, then a restart from it for the third
    dele_ins = [random_batch_update(edges, n, FLUSH, seed=SEED + 7 + b)
                for b in range(3)]
    updates = [make_batch_update(d, i, FLUSH, FLUSH, device=dev)
               for d, i in dele_ins]
    quiet = lambda msg: None
    _, full, _ = run_batches(graph, base, lambda i: updates[i], 0, 3,
                             "frontier_prune", log=quiet)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        mgr = CheckpointManager(tmp, every=2)
        run_batches(graph, base, lambda i: updates[i], 0, 2,
                    "frontier_prune", mgr=mgr, log=quiet)
        start, g_mid, r_mid = restore_stream(mgr, graph,
                                             lambda i: updates[i])
        _, resumed, _ = run_batches(g_mid, r_mid, lambda i: updates[i],
                                    start, 3, "frontier_prune", log=quiet)
        restart = dict(start=start, bitwise=bool(torch.equal(full, resumed)),
                       linf=float((full - resumed).abs().max()))
        check(start == 2 and restart["bitwise"],
              f"restart at batch {start} through the driver's loop: final "
              f"ranks bitwise equal to the uninterrupted run's (L_inf "
              f"{restart['linf']:.3e})")
        del g_mid, r_mid, resumed, full

        # the command line, twice on one checkpoint directory
        cli = []
        env = dict(os.environ, PYTHONPATH=SRC)
        for n_batches in (3, 5):
            cmd = [sys.executable, "-m", "repro_torch.launch.pagerank",
                   "--dataset", "sx-mathoverflow", "--batches",
                   str(n_batches), "--ckpt-every", "2", "--check-error",
                   "--ckpt-dir", os.path.join(tmp, "cli")]
            t0 = time.perf_counter()
            r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                               cwd=ROOT, timeout=600)
            cli.append(dict(cmd=" ".join(cmd[1:]), rc=r.returncode,
                            s=time.perf_counter() - t0, out=r.stdout))
            print(f"  $ python {' '.join(cmd[1:-2])} "
                  f"({cli[-1]['s']:.1f} s, exit {r.returncode})")
            for line in r.stdout.splitlines():
                print(f"    {line}")
            check(r.returncode == 0 and "stream complete" in r.stdout,
                  f"the driver with --batches {n_batches} completed"
                  + ("" if r.returncode == 0 else f": {r.stderr[-2000:]}"))
            l1s = [float(x.split("L1err=")[1]) for x in r.stdout.splitlines()
                   if "L1err=" in x]
            check(l1s and max(l1s) <= 1e-4,
                  f"the driver's L1 vs the NumPy oracle {max(l1s):.3e} "
                  f"<= 1e-4")
        check("restored at batch 2" in cli[1]["out"],
              "the second run printed 'restored at batch 2'")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    print(f"  phase {phase_s:.1f} s", flush=True)
    return dict(sizes=list(sizes), runs=runs, restart=restart, cli=cli,
                phase_s=phase_s)


# ---------------------------------------------------------------------------
# phase 8: observability
# ---------------------------------------------------------------------------

# the reference's shadow budgets (repro.obs.monitor.MonitorConfig)
SHADOW_L1, SHADOW_LINF = 1e-4, 1e-5


def obs_run(torch, dev, graph, feed, engine_name, telemetry=False,
            monitor=None, trace=False, check_syncs=False, fault=None,
            initial=None, pack=None):
    """Serve ``feed`` through a ``ServeEngine`` with the given
    observability: per batch the update latency, the step's host wall
    time, the reported host syncs (with ``check_syncs``, held to the
    debug mode's count), the snapshot's digest and, when telemetry is on,
    the rows.  ``fault``: (generation, vertex, scale) of a rank fault.
    ``initial``: a list that gets each batch's initial affected count
    (read after the step).  ``pack``: (packed graph, pinned pack
    keywords) of an earlier run's bootstrap, which the kernel engine then
    takes in place of packing again (a packed graph's tensors are never
    written: each batch's maintenance makes new ones); the result's
    ``pack`` is this run's."""
    from repro_torch import obs
    from repro_torch.serve import IngestQueue, RankStore, ServeEngine, \
        ServeMetrics
    from repro_torch.serve import engine as serve_engine
    ingest = IngestQueue(flush_size=FLUSH, flush_interval=1e9, device=dev)
    store, metrics = RankStore(), ServeMetrics()
    eng = ServeEngine(graph, ingest, store, metrics=metrics,
                      method="frontier_prune", engine=engine_name,
                      telemetry=telemetry, monitor=monitor)
    if pack is not None:
        eng._packed, eng._pack_kw = pack[0], dict(pack[1])
    seeds = []
    real_init = serve_engine.build_initial_state
    if initial is not None:
        def recording_init(*a, **kw):
            out = real_init(*a, **kw)
            seeds.append(out[1])
            return out
        serve_engine.build_initial_state = recording_init
    tracer = obs.start_tracing() if trace else None
    try:
        t0 = time.perf_counter()
        eng.bootstrap()
        torch.cuda.synchronize()
        boot_s = time.perf_counter() - t0
        pack = (eng._packed, dict(eng._pack_kw))
        if fault is not None:
            eng.inject_fault(fault[0], kind="rank", vertex=fault[1],
                             scale=fault[2])
        rows = []
        for b, events in enumerate(feed):
            for kind, u, v in events:
                ingest.submit(kind, u, v)
            seeds.clear()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if check_syncs:
                with recording_syncs(torch) as syncs:
                    check(eng.step(force=True),
                          f"[{engine_name}] batch {b} served")
            else:
                check(eng.step(force=True),
                      f"[{engine_name}] batch {b} served")
            step_ms = (time.perf_counter() - t1) * 1e3
            m = metrics
            row = dict(batch=b, latency_ms=m.update_latency_s[-1] * 1e3,
                       step_ms=step_ms, iterations=m.batch_iterations[-1],
                       affected=m.batch_affected[-1],
                       host_syncs=m.batch_host_syncs[-1],
                       digest=obs.rank_digest(store.snapshot().ranks))
            if check_syncs:
                row["measured_syncs"] = len(syncs)
                if row["host_syncs"] != len(syncs):
                    print(f"  [{engine_name}] batch {b}: synchronizing "
                          f"calls by site {sync_sites(syncs)}")
                check(row["host_syncs"] == len(syncs),
                      f"[{engine_name}] batch {b}: host_syncs "
                      f"{row['host_syncs']} == {len(syncs)} synchronizing "
                      f"calls (set_sync_debug_mode), monitor and telemetry "
                      f"on")
            if eng.last_telemetry is not None:
                row["telemetry_rows"] = eng.last_telemetry.iterations
                row["first_row_affected"] = float(
                    eng.last_telemetry.column("affected")[0])
            if initial is not None:
                row["initial_affected"] = int(seeds[-1].sum())
            rows.append(row)
    finally:
        serve_engine.build_initial_state = real_init
        if trace:
            obs.stop_tracing(write=False)
    eng.close()
    return dict(boot_s=boot_s, rows=rows, metrics=metrics, tracer=tracer,
                pack=pack if engine_name == "kernel" else None)


def obs_checks(args, torch, dev, edges, n, graph, serve):
    phase("8. observability (telemetry, correctness monitor, replay)")
    import shutil
    import tempfile

    import numpy as np
    from repro_torch import obs
    from repro_torch.obs import CorrectnessMonitor, MonitorConfig
    t_phase = time.perf_counter()
    feed = make_feed(args, edges, n)
    want = [r["digest"] for r in serve["kernel"]["rows"]]
    tmp = tempfile.mkdtemp(prefix="smoke_incidents_")
    out = dict(runs={})
    try:
        # the same feed four ways on the kernel engine, in turns, twice;
        # the first run packs, the others take its bootstrap pack
        def monitor(**kw):
            return CorrectnessMonitor(MonitorConfig(
                shadow_every=2, anchor_every=2, incident_dir=tmp, **kw))
        cfgs = dict(
            plain=lambda: dict(),
            telemetry=lambda: dict(telemetry=True),
            monitor=lambda: dict(monitor=monitor()),
            both=lambda: dict(telemetry=True, trace=True, check_syncs=True,
                              initial=[], monitor=monitor(
                                  shadow_background=False)))
        runs, pack, shadow, incidents = {}, None, [], []
        for rnd in (1, 2):
            for name, make in cfgs.items():
                kw = make()
                run = obs_run(torch, dev, graph, feed, "kernel", pack=pack,
                              **kw)
                pack = run["pack"]
                mon = kw.get("monitor")
                tag = f"{name}{rnd}"
                runs[tag] = dict(boot_s=run["boot_s"], rows=run["rows"])
                print(f"  [{tag}] bootstrap {run['boot_s']:.2f} s",
                      flush=True)
                if mon is None:
                    continue
                incidents += mon.incidents
                shadow += [(tag, r) for r in mon.shadow.reports]
                runs[tag]["anchor_bytes"] = {
                    g: sum(a.nbytes for a in st.values())
                    for g, (st, _) in mon.recorder._anchors.items()}
                runs[tag]["shadow_samples"] = mon.shadow.samples
                if name == "both":
                    both = run
                del mon, kw
        for tag, run in runs.items():
            got = [r["digest"] for r in run["rows"]]
            check(got == want, f"[{tag}] every batch's snapshot digest "
                  f"equals phase 4's unmonitored run ({len(got)} batches)")
        check(all(r["telemetry_rows"] == r["iterations"]
                  and r["first_row_affected"] == r["initial_affected"]
                  <= r["affected"] for t in ("both1", "both2")
                  for r in runs[t]["rows"]),
              "[both] a batch's telemetry rows == its iterations; the "
              "first row's affected == its initial affected set "
              "(<= batch_affected, every vertex ever affected)")
        check(incidents == [], "no incident on the clean feed (four "
              "monitored runs)")
        check(runs["both1"]["shadow_samples"] == 3 and all(
            r.l1 <= SHADOW_L1 and r.linf <= SHADOW_LINF for _, r in shadow),
              f"shadow within budget: L1 <= {SHADOW_L1:g} and L_inf <= "
              f"{SHADOW_LINF:g} ({len(shadow)} samples, worst L1 "
              f"{max(r.l1 for _, r in shadow):.3e}, L_inf "
              f"{max(r.linf for _, r in shadow):.3e})")
        tr = both["tracer"]
        trace_path = os.path.join(tmp, "trace.json")
        tr.write(trace_path)
        with open(trace_path) as f:
            doc = json.load(f)
        spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
        steps = [e for e in spans if e["name"] == "serve.step"]
        inner = [e for e in spans if e["name"] == "fused_update_loop"]
        check(len(steps) == len(feed) and all(
            any(s["ts"] <= i["ts"] and i["ts"] + i["dur"]
                <= s["ts"] + s["dur"] + 1e-3 for i in inner)
            for s in steps),
              f"Chrome trace loads ({len(doc['traceEvents'])} events); each "
              f"serve.step span contains a fused_update_loop span")
        scrape = obs.MetricsExporter(both["metrics"]).scrape()
        check(all(k in scrape for k in (
            "repro_sentinel_rank_mass_err", "repro_sentinel_trips",
            "repro_shadow_l1", "repro_shadow_linf", "repro_shadow_samples")),
              "a prometheus_text scrape holds the sentinel and shadow "
              "gauges")
        del both, tr
        print(f"  card: {device_smi()}; a batch, per round: update "
              f"latency ms plain / telemetry / monitor / both; step wall "
              f"ms, the same four; host syncs plain / both (measured)")
        for rnd in (1, 2):
            for b in range(len(feed)):
                r = {k: runs[f"{k}{rnd}"]["rows"][b] for k in cfgs}
                anchor = runs[f"both{rnd}"]["anchor_bytes"].get(b + 1)
                lat = " / ".join(f"{r[k]['latency_ms']:.2f}" for k in cfgs)
                wall = " / ".join(f"{r[k]['step_ms']:.2f}" for k in cfgs)
                print(f"  round {rnd} batch {b}: latency {lat}; step "
                      f"{wall}; syncs {r['plain']['host_syncs']} / "
                      f"{r['both']['host_syncs']} (+"
                      f"{r['both']['host_syncs'] - r['plain']['host_syncs']}"
                      f"; measured {r['both']['measured_syncs']})"
                      + (f"; anchor {anchor / 2**20:.1f} MiB"
                         if anchor is not None else ""), flush=True)
        for tag, rep in shadow:
            print(f"  [{tag}] shadow gen {rep.generation}: solve "
                  f"{rep.solve_s * 1e3:.2f} ms, {rep.iterations} "
                  f"iterations, L1 {rep.l1:.3e}, L_inf {rep.linf:.3e}")
        out["runs"] = runs
        out["shadow"] = [dict(run=t, **r._asdict()) for t, r in shadow]
        # (b) an injected rank fault on the largest rank, caught, dumped
        # and replayed bit for bit by the replay driver on the card
        from repro_torch.core.pagerank import static_pagerank
        r0 = static_pagerank(graph).ranks
        rmax, vmax = (float(x) for x in torch.max(r0, 0))
        del r0
        mass_tol = MonitorConfig().sentinel.mass_tol
        gen = max(1, len(feed) // 2 + 1)
        scale = float(np.ceil(1.0 + 20.0 * mass_tol / rmax))
        print(f"  fault: rank x{scale:g} at vertex {int(vmax)} (largest "
              f"bootstrap rank {rmax:.6e}), generation {gen}: mass error "
              f"~{rmax * (scale - 1):.3e} vs mass_tol {mass_tol:g}")
        fdir = os.path.join(tmp, "fault")
        fmon = CorrectnessMonitor(MonitorConfig(
            shadow_every=0, anchor_every=2, incident_dir=fdir))
        dumps = []
        real_dump = fmon.recorder.dump

        def timed_dump(*a, **kw):
            t0 = time.perf_counter()
            path = real_dump(*a, **kw)
            dumps.append(time.perf_counter() - t0)
            return path
        fmon.recorder.dump = timed_dump
        frun = obs_run(torch, dev, graph, feed, "kernel", monitor=fmon,
                       fault=(gen, int(vmax), scale), pack=pack)
        errors = [i for i in fmon.incidents if i.severity == "error"]
        check(bool(errors) and errors[0].kind == "rank_mass"
              and errors[0].generation == gen
              and errors[0].value >= 10 * mass_tol,
              f"an error incident rank_mass fires at generation {gen} "
              f"(mass error {errors[0].value if errors else 0:.3e} >= "
              f"{10 * mass_tol:g})")
        bundle = fmon.last_bundle
        check(bundle is not None and os.path.isdir(bundle),
              f"the monitor dumped a bundle ({bundle})")
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(bundle) for f in fs)
        print(f"  bundle {size / 2**20:.1f} MiB, dumped in "
              f"{dumps[0]:.2f} s", flush=True)
        rep_json = os.path.join(tmp, "replay.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.replay", bundle,
             "--strict", "--json", rep_json], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
            text=True, timeout=600)
        replay_s = time.perf_counter() - t0
        print("\n".join("    " + ln for ln in proc.stdout.splitlines()))
        if proc.returncode != 0:
            print(proc.stderr[-4000:])
        rep = dict(steps=[])
        if os.path.exists(rep_json):
            with open(rep_json) as f:
                rep = json.load(f)
        check(proc.returncode == 0 and rep["steps"] and all(
            s["bitwise"] and s["decisions_match"] for s in rep["steps"]),
              f"launch.replay --strict on the card: exit "
              f"{proc.returncode}, {len(rep['steps'])} steps, every step "
              f"bitwise and every decision matching ({replay_s:.1f} s)")
        out["fault"] = dict(generation=gen, vertex=int(vmax), scale=scale,
                            rank=rmax, mass_err=errors[0].value,
                            bundle_bytes=size, dump_s=dumps[0],
                            replay_s=replay_s, replay=rep,
                            rows=frun["rows"])
        shutil.rmtree(bundle)
        # (c) a clean monitored run on the xla engine, replayed in-process
        xmon = CorrectnessMonitor(MonitorConfig(shadow_every=0,
                                                anchor_every=2))
        xrun = obs_run(torch, dev, graph, feed, "xla", monitor=xmon)
        t0 = time.perf_counter()
        xrep = obs.replay(xmon.recorder, device=dev)
        check(xrep.ok and len(xrep.steps) == len(feed),
              f"xla engine: the monitored run replays in-process, "
              f"{xrep.num_bitwise}/{len(xrep.steps)} bit-for-bit "
              f"({time.perf_counter() - t0:.1f} s)")
        out["xla"] = dict(rows=xrun["rows"], replay_ok=xrep.ok)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the card's digest of phase 4's final ranks against the CPU's
    final = serve["final_ranks"]
    card, cpu = obs.rank_digest(final), obs.rank_digest(final.cpu())
    check(card == cpu, f"rank_digest on the card == on the CPU for phase "
          f"4's final ranks ({card & 0xFFFFFFFFFFFFFFFF:016x})")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase {out['phase_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 9: replicas, the iteration budget, block-Gauss-Seidel
# ---------------------------------------------------------------------------

# (a) the chaos run: the feed, the faults and the schedule (PERF.md §4)
CHAOS_EVENTS, CHAOS_HB, CHAOS_ANCHOR, CHAOS_SLO = 8192, 256, 2, 2048
CHAOS_P = 0.02
CHAOS_SCHEDULE = "partition:r1@1024+1024;kill:r0@3072+1024;kill_writer@5120"
# (c) the iteration budget's cap, and the batches that drain it uncapped
BUDGET_CAP, BUDGET_DRAIN = 2, 3
# (d) block-Gauss-Seidel: the reference test's tolerance, and the one at
# which its L1 gate is held (PERF.md §6, PR 23: at 2**21 the stopping
# rule at 1e-7 leaves an L1 of ~1e-4, for Jacobi ~2.5e-4)
GS_TOL, GS_TOL_L1 = 1e-7, 1e-8


def median_max(xs) -> str:
    import numpy as np
    if not len(xs):
        return "none"
    return f"median {float(np.median(xs)):.2f} max {float(np.max(xs)):.2f}"


def path_counters():
    """Every kernel launch counter of the rank and PPR paths."""
    from repro_torch.kernels.pagerank_spmv.pagerank_spmv import \
        LAUNCH_COUNTS as SPMV
    from repro_torch.kernels.pull_contrib.pull_contrib import \
        LAUNCH_COUNTS as PULL
    from repro_torch.kernels.slot_count.slot_count import \
        LAUNCH_COUNTS as COUNT
    from repro_torch.kernels.walk_repair.walk_repair import \
        LAUNCH_COUNTS as WALK
    return (SPMV, PULL, COUNT, WALK)


def read_counters(counters) -> dict:
    out = {}
    for c in counters:
        out.update(c)
    return {k: out.get(k, 0) for k in (
        "frontier_spmv", "pull_contrib", "slot_count", "segment_bounds",
        "segment_or", "walk_repair")}


@contextlib.contextmanager
def counted_steps(torch, rows):
    """Every ``ServeEngine.step`` inside the block runs under the sync
    debug mode; each served batch appends (reported, measured, sites,
    the step's host wall ms: it ends in a read that waits for the card,
    then publishes and runs the ``on_publish`` hook).  A harness engine's
    own latency is on its logical clock."""
    from repro_torch.serve.engine import ServeEngine
    real = ServeEngine.step

    def step(self, force=False):
        t0 = time.perf_counter()
        with recording_syncs(torch) as syncs:
            did = real(self, force)
        if did:
            rows.append((self.metrics.batch_host_syncs[-1], len(syncs),
                         sync_sites(syncs),
                         (time.perf_counter() - t0) * 1e3))
        return did
    ServeEngine.step = step
    try:
        yield rows
    finally:
        ServeEngine.step = real


@contextlib.contextmanager
def timed_calls(torch, targets):
    """Host seconds spent in each of ``targets`` ((owner, attribute)
    pairs, each call ended by a device sync) while the block runs:
    yields {attribute: [seconds, ...]}."""
    spent = {name: [] for _, name in targets}
    real = [(owner, name, getattr(owner, name)) for owner, name in targets]

    def wrap(name, fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[name].append(time.perf_counter() - t0)
            return out
        return timed
    for owner, name, fn in real:
        setattr(owner, name, wrap(name, fn))
    try:
        yield spent
    finally:
        for owner, name, fn in real:
            setattr(owner, name, fn)


def check_syncs(rows, what: str) -> None:
    bad = [(i, r, m, s) for i, (r, m, s, _) in enumerate(rows) if r != m]
    for i, r, m, s in bad:
        print(f"  {what} batch {i}: reported {r}, measured {m}: {s}")
    check(not bad and len(rows) > 0,
          f"{what}: batch_host_syncs == the debug mode's count on all "
          f"{len(rows)} writer batches")


def chaos_case(torch, dev, edges, n):
    """(a) The chaos harness at full width on the kernel engine."""
    from repro_torch.serve import ChaosHarness
    from repro_torch.serve import ReadReplica, ServeEngine, chaos
    from repro_torch.serve import engine as serve_engine
    counters = path_counters()
    where = [(chaos, "from_coo"), (ServeEngine, "_solve"),
             (serve_engine, "pack_graph"), (ReadReplica, "bootstrap")]
    t0 = time.perf_counter()
    with timed_calls(torch, where) as spent:
        h = ChaosHarness(
            num_replicas=2, events=CHAOS_EVENTS, schedule=CHAOS_SCHEDULE,
            seed=SEED, scale=SCALE, edge_factor=EDGE_FACTOR,
            flush_size=FLUSH, step_every=FLUSH, hb_every=CHAOS_HB,
            anchor_every=CHAOS_ANCHOR, staleness_slo_events=CHAOS_SLO,
            drop_p=CHAOS_P, dup_p=CHAOS_P, reorder_p=CHAOS_P, device=dev,
            engine="kernel", edges=edges)
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"  harness set-up {setup_s:.2f} s: graph build "
          f"{sum(spent['from_coo']):.2f} s, static f64 solve "
          f"{sum(spent['_solve']):.2f} s, host pack "
          f"{sum(spent['pack_graph']):.2f} s, 2 replica bootstraps "
          f"{sum(spent['bootstrap']):.2f} s")
    for c in counters:
        c.clear()                             # counts of the run only
    t0 = time.perf_counter()
    with counted_steps(torch, []) as rows, \
            timed_calls(torch, [(serve_engine, "pack_graph")]) as packs:
        rep = h.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_counters(counters)
    for line in rep.lines():
        print(f"  {line}")
    check_syncs(rows, "[chaos]")
    check(rep.parity_max_linf == 0.0 and rep.parity_checks >= 3,
          f"[chaos] writer-to-replica L_inf {rep.parity_max_linf!r} == 0.0 "
          f"at all {rep.parity_checks} parity checks")
    check(rep.failovers == 1 and h.writer.epoch == 1,
          f"[chaos] one failover, the writer at epoch {h.writer.epoch}")
    check(rep.resyncs >= 1 and rep.transport["dropped"] > 0
          and rep.events_fed == CHAOS_EVENTS,
          f"[chaos] resyncs {rep.resyncs} >= 1, dropped "
          f"{rep.transport['dropped']} > 0, events {rep.events_fed}")
    kernels = ("frontier_spmv", "pull_contrib", "slot_count",
               "segment_bounds", "segment_or")
    check(all(launches[k] > 0 for k in kernels),
          f"[chaos] the writer's steps launched "
          + ", ".join(f"{k} {launches[k]}" for k in kernels))
    hook = [x for w in h.writers for x in w.hook_ms]
    sizes = [x for w in h.writers for x in w.delta_sizes]
    step_ms = [r[3] for r in rows]
    anchor_ms = [x for w in h.writers for x in w.anchor_ms]
    anchor_b = [x for w in h.writers for x in w.anchor_bytes]
    apply_ms = [x for r in h.all_replicas for x in r.apply_ms]
    resync_ms = [x for r in h.all_replicas for x in r.resync_ms]
    fail_ms = h.controller.failover_ms
    card = device_smi()
    print(f"  card: {card}; the run {run_s:.1f} s, {len(step_ms)} writer "
          f"batches")
    print(f"  rank delta a publish: {median_max(sizes)} vertices "
          f"(of {n:,})")
    print(f"  writer hook ms a publish (diff + copies, anchors included): "
          f"{median_max(hook)}; the batch's step wall ms (update, "
          f"publish, hook): {median_max(step_ms)}")
    gb = median_max([b / 1e9 for b in anchor_b])
    print(f"  anchors: {len(anchor_b)}, {gb} GB, ms {median_max(anchor_ms)}")
    print(f"  replica apply ms a delta: {median_max(apply_ms)} "
          f"({len(apply_ms)} applies)")
    print(f"  resync ms: {median_max(resync_ms)} ({len(resync_ms)}); "
          f"failover ms: {median_max(fail_ms)} ({len(fail_ms)}), of which "
          f"the new writer's host pack "
          f"{sum(packs['pack_graph']) * 1e3:.2f} ms")
    out = dict(report=dict(lines=rep.lines(),
                           parity_max_linf=rep.parity_max_linf,
                           failovers=rep.failovers, resyncs=rep.resyncs,
                           transport=rep.transport),
               setup_s=setup_s, setup_split={k: sum(v) for k, v in
                                              spent.items()},
               failover_pack_s=sum(packs["pack_graph"]),
               run_s=run_s, launches=launches,
               syncs=[r[:2] for r in rows], delta_sizes=sizes,
               hook_ms=hook, step_ms=step_ms, anchor_ms=anchor_ms,
               anchor_bytes=anchor_b, apply_ms=apply_ms,
               resync_ms=resync_ms, failover_ms=list(fail_ms))
    del h
    return out


def budget_case(args, torch, dev, edges, n, graph):
    """(c) Phase 4's graph and feed with ``iteration_budget=2``, then the
    cap lifted until the carried frontier drains; returns the bootstrap
    pack for (b) and (d)."""
    from repro_torch.core.pagerank import MAX_ITER, static_pagerank
    from repro_torch.ft.straggler import IterationBudget
    from repro_torch.graph.generators import random_batch_update
    from repro_torch.serve import IngestQueue, RankStore, ServeEngine, \
        ServeMetrics
    budget = IterationBudget(BUDGET_CAP)
    ingest = IngestQueue(flush_size=FLUSH, flush_interval=1e9, device=dev)
    metrics = ServeMetrics()
    # as the reference's budget test: no static fallback, so the carried
    # frontier seeds dynamic solves (at 2**21 a carried batch's seeds
    # cover ~half the graph, past the default 0.25)
    eng = ServeEngine(graph, ingest, RankStore(), metrics=metrics,
                      method="frontier_prune", engine="kernel",
                      iteration_budget=budget, static_fallback_frac=2.0,
                      kernel_opts=dict(be=512, vb=256))
    t0 = time.perf_counter()
    eng.bootstrap()
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    pack = (eng.packed, dict(eng._pack_kw))
    feed = make_feed(args, edges, n)
    for k in range(BUDGET_DRAIN):
        dele, ins = random_batch_update(edges, n, FLUSH,
                                        seed=SEED + 100 + k)
        feed.append([("delete", int(u), int(v)) for u, v in dele]
                    + [("insert", int(u), int(v)) for u, v in ins])
    rows = []
    capped = args.batches
    with counted_steps(torch, []) as syncs:
        for b, events in enumerate(feed):
            if b == capped:
                budget.max_iter = MAX_ITER        # lift the cap
            if b >= capped and budget.carried_frontier is None:
                break
            for kind, u, v in events:
                ingest.submit(kind, u, v)
            carried = budget.carried_frontier is not None
            fallbacks = metrics.static_fallbacks
            check(eng.step(force=True), f"[budget] batch {b} served")
            rows.append(dict(
                batch=b, cap=budget.max_iter,
                fallback=metrics.static_fallbacks > fallbacks,
                iterations=metrics.batch_iterations[-1],
                latency_ms=metrics.update_latency_s[-1] * 1e3,
                seeded_with_carry=carried,
                carries=budget.carried_frontier is not None,
                host_syncs=syncs[-1][0], measured_syncs=syncs[-1][1]))
            r = rows[-1]
            print(f"  [budget] batch {b}: cap {r['cap']} iterations "
                  f"{r['iterations']} (f32 + polish) latency_ms "
                  f"{r['latency_ms']:.2f} static fallback {r['fallback']} "
                  f"carried-in {carried} carries-out {r['carries']} "
                  f"host_syncs {r['host_syncs']} (measured "
                  f"{r['measured_syncs']})", flush=True)
    check_syncs(syncs, "[budget]")
    # the cap binds dynamic solves only (a static fallback runs uncapped)
    capped_rows = [r for r in rows
                   if r["cap"] == BUDGET_CAP and not r["fallback"]]
    check(len(capped_rows) == capped
          and all(r["iterations"] <= 2 * BUDGET_CAP for r in capped_rows),
          f"[budget] the cap held: each capped dynamic batch <= "
          f"{BUDGET_CAP} f32 + {BUDGET_CAP} polish iterations "
          f"({[r['iterations'] for r in capped_rows]})")
    check(metrics.budget_carryover >= 1 and budget.carried_frontier is None,
          f"[budget] budget_carryover {metrics.budget_carryover} >= 1, and "
          f"the uncapped batches drained the carried frontier")
    snap = eng.store.snapshot()
    static = static_pagerank(snap.graph)
    l1 = float((snap.ranks - static.ranks).abs().sum())
    check(l1 <= 1e-4, f"[budget] after the drain, L1 vs a static f64 solve "
          f"{l1:.3e} <= 1e-4")
    eng.close()
    return dict(boot_s=boot_s, rows=rows, l1=l1,
                carryover=metrics.budget_carryover), pack


def ppr_replica_case(args, torch, dev, edges, n, graph, pack):
    """(b) A PPR writer and one replica bootstrapping cold from the
    anchor; deltas through a lossy transport; a gap past the log heals by
    repair (``_edge_diff_touched``), not by a rebuild."""
    from repro_torch.ft.elastic import ReplicaRoster
    from repro_torch.ppr import IndexConfig
    from repro_torch.serve import FaultyTransport, IngestQueue, \
        LogicalClock, RankStore, ReadReplica, ReplicationWriter, \
        ServeEngine
    cfg = IndexConfig(num_walks=PPR_WALKS, max_len=PPR_LEN, seed=SEED)
    counters = path_counters()
    clock = LogicalClock()
    transport = FaultyTransport(seed=SEED + 1, drop_p=0.3)
    roster = ReplicaRoster(heartbeat_timeout=1e9)
    ingest = IngestQueue(flush_size=FLUSH, flush_interval=1e9, device=dev,
                         clock=clock)
    eng = ServeEngine(graph, ingest, RankStore(), method="frontier_prune",
                      engine="kernel", ppr_index=cfg, clock=clock)
    eng._packed, eng._pack_kw = pack[0], dict(pack[1])
    t0 = time.perf_counter()
    eng.bootstrap()
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    w = ReplicationWriter(eng, transport, anchor_every=1, log_capacity=1,
                          clock=clock)
    w.attach()
    transport.set_writer(w)
    r = ReadReplica("r0", transport, n, roster=roster, ppr_cfg=cfg,
                    clock=clock, device=dev, max_retries=2,
                    backoff_base=0.01)
    for c in counters:
        c.clear()                             # counts of the stream only
    check(r.bootstrap() and r.index_builds == 1,
          "[ppr] the replica bootstrapped cold from the anchor (one build)")
    cold_ms = r.resync_ms[-1]

    def settle():
        for _ in range(40):
            clock.advance(0.1)
            w.heartbeat(roster)
            r.pump()

    def same(what):
        ws = eng.store.snapshot()
        check(r.generation == ws.generation
              and torch.equal(r.ppr.steps, ws.ppr_index.steps)
              and torch.equal(r.ranks, ws.ranks),
              f"[ppr] {what}: the replica's walk steps and ranks equal the "
              f"writer's bit for bit at generation {ws.generation}")

    same("after the cold bootstrap")
    feed = make_feed(args, edges, n)[:4]
    for b, events in enumerate(feed):
        if b == 1:
            transport.partition("r0")         # two deltas past the log
        for kind, u, v in events:
            ingest.submit(kind, u, v)
        check(eng.step(force=True), f"[ppr] batch {b} served")
        clock.advance(0.1)
        w.heartbeat(roster)
        r.pump()
        if b == 2:
            transport.heal("r0")
            resyncs, heals = r.resyncs, r.heals_by_repair
            settle()
            check(r.resyncs == resyncs + 1
                  and r.heals_by_repair == heals + 1
                  and r.index_builds == 1,
                  f"[ppr] the gap past the log resynced from the anchor "
                  f"and healed by repair, no rebuild (resyncs "
                  f"{r.resyncs}, heals {r.heals_by_repair}, builds "
                  f"{r.index_builds})")
            heal_ms = r.resync_ms[-1]
            same("after the heal")
    settle()
    same("at the end")
    launches = read_counters(counters)
    check(launches["walk_repair"] > 0,
          f"[ppr] walk_repair launched {launches['walk_repair']} times "
          f"(writer repairs, replica repairs and the heal)")
    print(f"  [ppr] card: {device_smi()}; writer bootstrap (static solve + "
          f"index build) {boot_s:.2f} s; the replica's cold bootstrap "
          f"(anchor + build) {cold_ms:.1f} ms, the heal (anchor + diff + "
          f"repair) {heal_ms:.1f} ms; applies {median_max(r.apply_ms)} ms; "
          f"dropped {transport.dropped}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    out = dict(boot_s=boot_s, cold_ms=cold_ms, heal_ms=heal_ms,
               apply_ms=list(r.apply_ms), launches=launches,
               dropped=transport.dropped,
               peak_bytes=torch.cuda.max_memory_allocated())
    eng.close()
    del eng, w, r
    return out


def gs_case(torch, dev, graph, pack):
    """(d) Block-Gauss-Seidel on phase 4's graph at the serving pack
    (BE 512, VB 256), against the Jacobi f32 loop and a static f64 solve."""
    from repro_torch.core.gauss_seidel import gauss_seidel_pagerank
    from repro_torch.core.kernel_engine import kernel_pagerank_loop
    from repro_torch.core.pagerank import static_pagerank
    packed = pack[0]
    check(packed.be == 512 and packed.vb == 256,
          f"[gs] the pack is BE {packed.be}, VB {packed.vb}")
    n = graph.num_vertices
    static = static_pagerank(graph).ranks
    init = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    out = {}
    for tol in (GS_TOL, GS_TOL_L1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gs = gauss_seidel_pagerank(graph, packed, init, tol=tol)
        torch.cuda.synchronize()
        gs_s = time.perf_counter() - t0
        jac = kernel_pagerank_loop(graph, packed, init, ones, tol=tol,
                                   closed_form=True, expand=False)
        l1 = float((gs.ranks.double() - static).abs().sum())
        l1_jac = float((jac.ranks.double() - static).abs().sum())
        row = dict(tol=tol, sweeps=gs.sweeps, ms_a_sweep=gs_s * 1e3
                   / gs.sweeps, jacobi_iterations=jac.iterations,
                   l1=l1, l1_jacobi=l1_jac, delta=float(gs.delta))
        print(f"  [gs] tol {tol:g}: {gs.sweeps} sweeps, "
              f"{row['ms_a_sweep']:.1f} ms a sweep; Jacobi "
              f"{jac.iterations} iterations; L1 vs static f64 {l1:.3e} "
              f"(Jacobi {l1_jac:.3e})", flush=True)
        check(gs.sweeps <= jac.iterations,
              f"[gs] tol {tol:g}: sweeps {gs.sweeps} <= Jacobi iterations "
              f"{jac.iterations}")
        if tol == GS_TOL:
            again = gauss_seidel_pagerank(graph, packed, init, tol=tol)
            check(again.sweeps == gs.sweeps
                  and torch.equal(again.ranks, gs.ranks)
                  and torch.equal(again.delta, gs.delta),
                  f"[gs] tol {tol:g}: two runs bitwise equal")
        else:
            check(l1 <= 1e-4, f"[gs] tol {tol:g}: L1 vs a static f64 solve "
                  f"{l1:.3e} <= 1e-4")
        out[f"{tol:g}"] = row
    print(f"  [gs] card: {device_smi()}")
    return out


def replica_checks(args, torch, dev, edges, n, graph):
    phase("9. replicas (chaos, PPR replication, iteration budget, "
          "Gauss-Seidel)")
    t_phase = time.perf_counter()
    out = dict(chaos=chaos_case(torch, dev, edges, n))
    print(f"  (a) chaos {time.perf_counter() - t_phase:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out["budget"], pack = budget_case(args, torch, dev, edges, n, graph)
    print(f"  (c) budget {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    out["ppr"] = ppr_replica_case(args, torch, dev, edges, n, graph, pack)
    torch.cuda.empty_cache()
    print(f"  (b) ppr {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    out["gs"] = gs_case(torch, dev, graph, pack)
    print(f"  (d) gs {time.perf_counter() - t:.1f} s", flush=True)
    out["launches"] = {k: out["chaos"]["launches"][k]
                       + out["ppr"]["launches"][k]
                       for k in out["chaos"]["launches"]}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase {out['phase_s']:.1f} s", flush=True)
    return out


def device_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()




# ---------------------------------------------------------------------------
# phase 10: the geometry tuner and the sharded rank engines
# ---------------------------------------------------------------------------

# the sharded engines' feed: the first MESH_BATCHES of phase 4's (the
# depth cut so that the whole smoke keeps inside its time)
MESH_BATCHES = 3
# kernel shards of phase 10 (b): a (1, 4) mesh repeating the card; the
# xla engine runs on the reference's 2 x 2 test mesh
MESH_SHARDS = 4
# (b)'s forced repack: routed rows a shard a batch, FLUSH // MESH_BUDGET
# (64 at FLUSH 1024; such a batch puts ~200 on each of 4 shards)
MESH_BUDGET = 16
# (a): the model's pick at ~5 % active may measure at most this much
# slower than the fixed serving geometry
TUNE_SLACK = 1.05


def tune_cases(torch, dev, graph):
    """(a) The tuner at full width: the model's ranking of the grid at
    frontier fractions 0.05 and 1.0, then the model's top 3 at 0.05, the
    fixed serving geometry (BE 512, VB 256, spill 256) and the model's last
    pick, each packed (host time printed) and timed at ~5 % and 100 %
    active (the tuner's clustered frontier: the first f·|V| vertices) in
    two rounds, predicted beside measured."""
    import functools
    import numpy as np
    from repro_torch.kernels.pagerank_spmv import tune
    from repro_torch.kernels.pagerank_spmv.ops import gated_contrib
    from repro_torch.kernels.pagerank_spmv.ref import frontier_spmv_ref_padded
    from repro_torch.kernels.pagerank_spmv.update import pack_graph
    from repro_torch.serve.engine import KERNEL_PACK_DEFAULTS
    n = graph.num_vertices
    dst = graph.dst[graph.valid].cpu().numpy()
    inserts = max(1024, 64 * FLUSH)          # the serve engine's
    out = dict(ranking={})
    for f in (0.05, 1.0):
        ranked = tune.candidate_costs(dst, n, f, inserts)
        out["ranking"][f] = [(g.be, g.vb, g.spill_lanes_per_window,
                              p * 1e3) for g, p in ranked]
        print(f"  [tune] model at f={f:g}: " + ", ".join(
            f"({b},{v},{s}) {p:.4f}" for b, v, s, p in out["ranking"][f])
            + " ms", flush=True)
    ranked = tune.candidate_costs(dst, n, 0.05, inserts)
    fixed = tune.KernelGeometry(**KERNEL_PACK_DEFAULTS)
    picks = [("model #1", ranked[0][0]), ("model #2", ranked[1][0]),
             ("model #3", ranked[2][0]), ("fixed", fixed),
             ("model last", ranked[-1][0])]
    ranks = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
    inv = (1.0 / graph.out_degree(include_self_loop=True)
           .to(torch.float64)).to(torch.float32)
    rsc = (ranks * inv).to(torch.float32)
    rows, max_err = [], 0.0
    for label, geom in picks:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        packed = pack_graph(graph, **geom.pack_kw())
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        counts = tune.window_counts(dst, n, geom.vb)
        n_w = tune.window_entries(dst, n, geom.be, geom.vb,
                                  geom.spill_lanes_per_window)
        for f in (0.05, 1.0):
            aff = torch.zeros(n, dtype=torch.bool, device=dev)
            aff[: int(f * n)] = True
            awin = packed.active_windows(aff)
            call = functools.partial(gated_contrib, packed, ranks, inv,
                                     active_window=awin, use_kernel=True)
            # the kernel at this geometry against its plain version
            got = call()
            ref = frontier_spmv_ref_padded(
                packed.src, packed.dst_rel, packed.valid, packed.window,
                rsc, awin, packed.vb)[:n]
            err = float((got - ref).abs().max())
            max_err = max(max_err, err)
            check(bool(torch.allclose(got, ref, rtol=KERNEL_RTOL,
                                      atol=KERNEL_ATOL)),
                  f"[tune] {label} {geom.describe()} f={f:g}: kernel == "
                  f"plain (max abs err {err:.3e})")
            del got, ref
            model = tune.gated_spmv_cost(counts, n_w, n, geom.be, geom.vb, f)
            rows.append(dict(label=label, be=geom.be, vb=geom.vb,
                             spill=geom.spill_lanes_per_window, frac=f,
                             pack_s=pack_s, entries=packed.num_entries,
                             predicted_ms=model["total_s"] * 1e3,
                             max_abs_err=err,
                             ms=[time_ms(torch, call)],
                             host_ms=host_ms(torch, call), call=call))
    # the second round, in the opposite order: a geometry's time is the
    # smaller of its two rounds
    for row in reversed(rows):
        row["ms"].append(time_ms(torch, row["call"]))
    for row in rows:
        del row["call"]                   # the packs go with the calls
        row["ms"] = min(row["ms"])
        print(f"  [tune] {row['label']:10s} be={row['be']:4d} "
              f"vb={row['vb']:3d} spill={row['spill']:3d} "
              f"f={row['frac']:<4g} predicted {row['predicted_ms']:.4f} ms"
              f", measured {row['ms']:.4f} ms (host {row['host_ms']:.4f})"
              f"; pack {row['pack_s']:.2f} s, {row['entries']:,} entries",
              flush=True)
    out.update(rows=rows, max_abs_err=max_err)
    at5 = {r["label"]: r["ms"] for r in rows if r["frac"] == 0.05}
    out["pick"] = (ranked[0][0].be, ranked[0][0].vb)
    check(at5["model #1"] <= TUNE_SLACK * at5["fixed"],
          f"[tune] the model's pick {out['pick']} at ~5 % active "
          f"{at5['model #1']:.4f} ms <= {TUNE_SLACK:g} x the fixed "
          f"(512, 256)'s {at5['fixed']:.4f} ms")
    # the cache: a miss, then a hit on a second call with the same key
    path = os.path.join(os.path.dirname(
        os.environ["REPRO_TORCH_TUNE_CACHE"]), "phase10.json")
    if os.path.exists(path):
        os.remove(path)
    g1, i1 = tune.tune_geometry(graph, expected_inserts=inserts,
                                cache_path=path)
    g2, i2 = tune.tune_geometry(graph, expected_inserts=inserts,
                                cache_path=path)
    check(not i1.cache_hit and i2.cache_hit and g1 == g2
          and i1.key.startswith(torch.cuda.get_device_name(0)
                                .replace(" ", "_") + "/"),
          f"[tune] key {i1.key}: a miss ({i1.tune_time_s * 1e3:.1f} ms), "
          f"then a hit ({i2.tune_time_s * 1e3:.2f} ms), the same "
          f"geometry {g2.describe()}")
    out.update(key=i1.key, miss_ms=i1.tune_time_s * 1e3,
               hit_ms=i2.tune_time_s * 1e3)
    return out


def shard_kernel_cases(torch, dev, sharded):
    """Each shard's frontier_spmv against its plain version on the card,
    on the inputs the sharded loops give it: an rsc spanning every vertex
    (``src`` is global) and the shard's own active windows.  Two rsc: all
    of it set (the psum exchange), and only the shard's own range and its
    halo set (the halo exchange's buffer), at ~5 % and 100 % of the
    windows active."""
    from repro_torch.kernels.pagerank_spmv.ref import frontier_spmv_ref_padded
    from repro_torch.kernels.pagerank_spmv.shard import frontier_spmv_shard
    spec, packs = sharded.spec, sharded.sharded.shards
    wps, vps, v_pad = (spec.windows_per_shard, spec.vertices_per_shard,
                       spec.padded_vertices)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 10)
    full = torch.rand(v_pad, generator=gen, device=dev)
    cases, max_err = [], 0.0
    for s, p in enumerate(packs):
        halo = torch.zeros(v_pad, device=dev)
        halo[s * vps:(s + 1) * vps] = full[s * vps:(s + 1) * vps]
        ids = sharded.halo.ids[s].long().to(dev)
        ids = ids[ids < v_pad]
        halo[ids] = full[ids]
        for frac in (0.05, 1.0):
            awin = torch.rand(wps, generator=gen, device=dev) < frac
            for regime, rsc in (("full", full), ("halo", halo)):
                out = frontier_spmv_shard(p, rsc, awin)
                ref = frontier_spmv_ref_padded(p.src, p.dst_rel, p.valid,
                                               p.window, rsc, awin, p.vb)
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                max_err = max(max_err, err)
                tag = f"[shard {s}] {regime} rsc, {frac:.0%} of windows"
                check(bool(torch.allclose(out, ref, rtol=KERNEL_RTOL,
                                          atol=KERNEL_ATOL)),
                      f"{tag}: kernel == plain (max abs err {err:.3e})")
                check(bool((out[~awin.repeat_interleave(p.vb)] == 0).all())
                      and torch.equal(frontier_spmv_shard(p, rsc, awin), out),
                      f"{tag}: inactive windows exactly 0, bitwise equal "
                      "run to run")
                call = lambda: frontier_spmv_shard(p, rsc, awin)
                cases.append(dict(shard=s, rsc=regime, frac=frac,
                                  active_windows=int(awin.sum()),
                                  max_abs_err=err, ms=time_ms(torch, call),
                                  plain_ms=time_ms(torch, lambda:
                                      frontier_spmv_ref_padded(
                                          p.src, p.dst_rel, p.valid,
                                          p.window, rsc, awin, p.vb))))
                c = cases[-1]
                print(f"  {tag}: kernel_ms={c['ms']:.4f} plain_ms="
                      f"{c['plain_ms']:.4f} active_windows="
                      f"{c['active_windows']:,} of {wps:,}", flush=True)
    return dict(cases=cases, max_abs_err=max_err)


def mesh_run(torch, dev, graph, feed, ranks0, mesh, engine, tag,
             check_syncs=True, template=None, **kernel_opts):
    """Serve ``feed`` on ``mesh``; each batch's latency, syncs (held to
    the debug mode's count), frontier_spmv launches (held to one a shard
    an f32 iteration) and snapshot.  ``template``: a sharded kernel
    engine as an earlier run's bootstrap left it; this run starts from a
    copy of its pack and halo (with ``kernel_opts``' exchange and delta
    budget) instead of packing again, as phase 9 reuses a bootstrap
    pack."""
    import copy
    from repro_torch.kernels.pagerank_spmv.pagerank_spmv import LAUNCH_COUNTS
    from repro_torch.serve import IngestQueue, RankStore, ServeEngine, \
        ServeMetrics
    ingest = IngestQueue(flush_size=FLUSH, flush_interval=1e9, device=dev)
    metrics = ServeMetrics()
    eng = ServeEngine(graph, ingest, RankStore(), metrics=metrics,
                      method="frontier_prune", engine=engine, mesh=mesh,
                      kernel_opts=kernel_opts)
    if template is not None:
        sk = copy.copy(template)
        sk.exchange = kernel_opts.get("exchange", "halo")
        sk.halo = template.halo if sk.exchange == "halo" else None
        sk.delta_budget = kernel_opts.get("delta_budget")
        sk.last_comm_info, sk.last_comm_bytes = {}, 0
        eng._sharded = sk
    t0 = time.perf_counter()
    eng.bootstrap(ranks=ranks0)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    # the pack and halo as the bootstrap left them (steps replace, never
    # mutate, them)
    boot = copy.copy(eng._sharded) if eng._sharded is not None else None
    info = eng.tune_info
    print(f"  [{tag}] bootstrap {boot_s:.2f} s"
          + (f"; geometry {eng.kernel_geometry.describe()} (tune "
             f"{info.source}, cache_hit={info.cache_hit})"
             if info is not None else ""), flush=True)
    rows, snaps = [], []
    for b, events in enumerate(feed):
        for kind, u, v in events:
            ingest.submit(kind, u, v)
        before = LAUNCH_COUNTS["frontier_spmv"]
        if check_syncs:
            with recording_syncs(torch) as syncs:
                check(eng.step(force=True), f"[{tag}] batch {b} served")
        else:
            check(eng.step(force=True), f"[{tag}] batch {b} served")
            syncs = None
        launches = LAUNCH_COUNTS["frontier_spmv"] - before
        sharded = eng._sharded
        comm = dict(sharded.last_comm_info) if sharded is not None else {}
        m = metrics
        row = dict(batch=b, latency_ms=m.update_latency_s[-1] * 1e3,
                   iterations=m.batch_iterations[-1],
                   affected=m.batch_affected[-1], launches=launches,
                   host_syncs=m.batch_host_syncs[-1],
                   measured_syncs=None if syncs is None else len(syncs),
                   fallback=m.static_fallbacks,
                   repacks=dict(m.packed_rebuilds_by_shard), **comm,
                   halo_occupancy=m.as_dict().get("halo_occupancy"))
        rows.append(row)
        snaps.append(eng.store.snapshot().ranks.clone())
        print(f"  [{tag}] batch {b}: latency_ms={row['latency_ms']:.2f} "
              f"iterations={row['iterations']} affected="
              f"{row['affected']:,} frontier_spmv={launches} f32_iterations="
              f"{comm.get('f32_iterations')} comm_bytes="
              f"{comm.get('comm_bytes', 0):,} halo_occupancy="
              f"{row['halo_occupancy']} host_syncs={row['host_syncs']} "
              f"(measured {row['measured_syncs']}) repacks by shard "
              f"{row['repacks']}", flush=True)
        if syncs is not None:
            if row["host_syncs"] != row["measured_syncs"]:
                print(f"  [{tag}] batch {b}: synchronizing calls by site "
                      f"{sync_sites(syncs)}")
            check(row["host_syncs"] == row["measured_syncs"],
                  f"[{tag}] batch {b}: host_syncs {row['host_syncs']} == "
                  f"{row['measured_syncs']} synchronizing calls")
        if sharded is not None and engine == "kernel" and not row["repacks"]:
            check(launches == sharded.num_shards * comm["f32_iterations"]
                  and launches > 0,
                  f"[{tag}] batch {b}: frontier_spmv launched {launches} "
                  f"times = {sharded.num_shards} shards x "
                  f"{comm['f32_iterations']} f32 iterations")
    lat = sorted(r["latency_ms"] for r in rows)
    return dict(boot_s=boot_s, rows=rows, latency_median_ms=lat[len(lat) // 2],
                latency_max_ms=lat[-1], comm_bytes=metrics.comm_bytes,
                repacks=dict(metrics.packed_rebuilds_by_shard),
                launches=sum(r["launches"] for r in rows),
                geometry=(None if eng.kernel_geometry is None
                          else eng.kernel_geometry.describe()),
                tune_cache_hit=(None if info is None else info.cache_hit),
                boot=boot), snaps, eng


def mesh_checks(args, torch, dev, edges, n, graph):
    """Phase 10: (a) the tuner; (b) four kernel shards on the card (halo,
    then psum), the xla mesh engine; (c) update_pagerank(mesh=), elastic
    rescale 4 -> 2 shards, the serve driver's --mesh test."""
    phase("10. shards and geometry (tuner, sharded rank engines)")
    import tempfile
    import numpy as np
    from repro_torch.core.api import update_pagerank
    from repro_torch.core.pagerank import static_pagerank
    from repro_torch.ft import checkpoint as ck
    from repro_torch.ft.elastic import rescale_pagerank_state
    from repro_torch.graph.dynamic import apply_batch
    from repro_torch.graph.partition import partition_graph
    from repro_torch.launch.mesh import make_test_mesh
    t_phase = time.perf_counter()
    out = dict(tune=tune_cases(torch, dev, graph))
    feed = make_feed(args, edges, n)[:MESH_BATCHES]
    ranks0 = static_pagerank(graph).ranks
    shards = make_test_mesh(MESH_SHARDS, device=dev, model=MESH_SHARDS)
    square = make_test_mesh(4, device=dev)
    print(f"  (b) kernel mesh {shards.shape}, xla mesh {square.shape}, all "
          f"on {sorted({str(d) for d in shards.devices.flat})}; "
          f"{len(feed)} batches of phase 4's feed", flush=True)
    f64, snaps_f64, _ = mesh_run(torch, dev, graph, feed, ranks0, None,
                                 "xla", "f64 engine", check_syncs=False)
    runs, snaps = {}, {}
    template = None
    for tag, mesh, engine, kw in (
            ("halo", shards, "kernel", dict(exchange="halo")),
            ("halo again", shards, "kernel", dict(exchange="halo")),
            ("psum", shards, "kernel", dict(exchange="psum")),
            ("xla mesh", square, "xla", {}),
            ("xla mesh again", square, "xla", {})):
        runs[tag], snaps[tag], eng = mesh_run(
            torch, dev, graph, feed, ranks0, mesh, engine, tag,
            template=template if engine == "kernel" else None, **kw)
        if tag == "halo":
            final_graph = eng.store.snapshot().graph
            saved = eng.store.snapshot().ranks
            # the later kernel runs start from this bootstrap's pack
            template = runs[tag]["boot"]
            out["shard_kernels"] = shard_kernel_cases(torch, dev, template)
        del eng
    static = static_pagerank(final_graph).ranks
    for tag in ("halo", "psum", "xla mesh"):
        r = runs[tag]
        check(all(row["fallback"] == 0 for row in r["rows"]),
              f"[{tag}] no static fallback")
        linf = max(float((a - b).abs().max())
                   for a, b in zip(snaps[tag], snaps_f64))
        l1 = float((snaps[tag][-1] - static).abs().sum())
        r.update(linf_vs_f64=linf, l1_vs_static=l1)
        check(linf <= 1e-6, f"[{tag}] L_inf vs the f64 engine {linf:.3e} "
              "<= 1e-6 every batch")
        check(l1 <= 1e-4, f"[{tag}] final L1 vs a static f64 solve "
              f"{l1:.3e} <= 1e-4")
        print(f"  [{tag}] latency a batch median {r['latency_median_ms']:.2f}"
              f" ms, max {r['latency_max_ms']:.2f} ms; comm bytes "
              f"{r['comm_bytes']:,}; frontier_spmv {r['launches']}",
              flush=True)
    for a, b in (("halo", "halo again"), ("xla mesh", "xla mesh again")):
        check(all(torch.equal(x, y) for x, y in zip(snaps[a], snaps[b])),
              f"[{a}] served twice: every snapshot bitwise equal")
    # a forced per-shard repack: a routed budget the first batch overflows
    runs["repack"], _, eng = mesh_run(
        torch, dev, graph, feed[:1], ranks0, shards, "kernel", "repack",
        template=template, exchange="halo",
        delta_budget=FLUSH // MESH_BUDGET)
    check(eng.metrics.packed_rebuilds == 1
          and len(eng.metrics.packed_rebuilds_by_shard) > 0,
          f"[repack] a budget of {FLUSH // MESH_BUDGET} rows a shard "
          f"overflowed: "
          f"repacks by shard {dict(eng.metrics.packed_rebuilds_by_shard)}")
    del eng
    # (c) the one-shot entry point, elastic rescale, the driver
    from repro_torch.graph.dynamic import make_batch_update
    dels = [(u, v) for k, u, v in feed[0] if k == "delete"]
    ins = [(u, v) for k, u, v in feed[0] if k == "insert"]
    upd = make_batch_update(np.asarray(dels, np.int64).reshape(-1, 2),
                            np.asarray(ins, np.int64).reshape(-1, 2),
                            FLUSH, FLUSH, device=dev)
    graph1 = apply_batch(graph, upd)
    t0 = time.perf_counter()
    one = update_pagerank(graph, graph1, upd, ranks0, "frontier_prune",
                          mesh=square)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    plain = update_pagerank(graph, graph1, upd, ranks0, "frontier_prune")
    linf = float((one.ranks - plain.ranks).abs().max())
    check(linf <= 1e-6, f"[update_pagerank(mesh=) on the 2 x 2 mesh, one "
          f"shot {one_s:.2f} s] L_inf vs the f64 engine {linf:.3e} <= 1e-6")
    with tempfile.TemporaryDirectory() as d:
        ck.save(d, MESH_BATCHES, dict(
            batch_idx=torch.tensor(MESH_BATCHES, dtype=torch.int64),
            ranks=saved))
        t0 = time.perf_counter()
        idx, ranks, part = rescale_pagerank_state(d, final_graph, square,
                                                  dtype=torch.float64)
        rescale_s = time.perf_counter() - t0
    want = partition_graph(final_graph, 2, 2)
    check(idx == MESH_BATCHES and torch.equal(ranks, saved)
          and np.array_equal(part.src, want.src)
          and np.array_equal(part.valid, want.valid),
          f"[rescale] 4 shards onto 2 x 2 in {rescale_s:.2f} s: ranks "
          f"bitwise, the partition the new mesh's {part.src.shape}")
    t0 = time.perf_counter()
    # the driver once for phases 10 and 11: its walk index is range-
    # sharded over the test mesh's model axis
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mesh", "test",
         "--engine", "kernel", "--ppr-walks", "8", "--events", "2000",
         "--min-queries", "1"],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=SRC))
    tail = [l for l in proc.stdout.splitlines()
            if l.startswith(("mesh", "kernel geometry", "serve complete"))]
    print("  [driver] " + " | ".join(tail))
    check(proc.returncode == 0 and "serve complete" in proc.stdout
          and "ppr_top1=" in proc.stdout,
          f"[driver] launch.serve --mesh test --engine kernel --ppr-walks 8 "
          f"(a range-sharded walk index) exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s"
          + ("" if proc.returncode == 0 else f": {proc.stderr[-2000:]}"))
    for r in runs.values():
        r.pop("boot")
    out.update(runs=runs, one_shot_s=one_s, one_shot_linf=linf,
               rescale_s=rescale_s,
               launches=sum(r["launches"] for r in runs.values()),
               phase_s=time.perf_counter() - t_phase)
    print(f"  phase {out['phase_s']:.1f} s; frontier_spmv launched "
          f"{out['launches']} times in (b)", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 11: the walk index range-sharded over four shards of one card
# ---------------------------------------------------------------------------

# shards of the walk index: a (1, 4) mesh repeating the card, phase 10's
PPR_SHARDS = 4


def _walk_parts(index):
    """[(first global row, int32[rows, R, L])] of a walk index, whole or
    sharded."""
    if hasattr(index, "spec"):
        vps = index.spec.vertices_per_shard
        return [(s * vps, t) for s, t in enumerate(index.steps)]
    return [(0, index.steps)]


def same_walks(torch, a, b) -> bool:
    """Two walk indexes (whole or sharded, any shard count) hold the same
    walks bit for bit: compared range by range, no shard joined."""
    V = a.num_vertices
    pa, pb = _walk_parts(a), _walk_parts(b)
    cuts = sorted({g for g, _ in pa} | {g for g, _ in pb} | {V})

    def rows(parts, lo, hi):
        g, t = max((p for p in parts if p[0] <= lo), key=lambda p: p[0])
        return t[lo - g:hi - g]
    return all(torch.equal(rows(pa, lo, hi), rows(pb, lo, hi))
               for lo, hi in zip(cuts[:-1], cuts[1:]) if lo < V)


def top10_agrees(torch, est_a, est_b, k=10) -> bool:
    """The top-k vertices of two estimates agree wherever no other
    estimate lies within 1e-12 of the k-th's (a tie may order either
    way)."""
    va, ia = torch.topk(est_a, k)
    _, ib = torch.topk(est_b, k)
    for i in range(k):
        if int(ia[i]) == int(ib[i]):
            continue
        if int(((est_b - va[i]).abs() <= 1e-12).sum()) < 2:
            return False
    return True


def ppr_mesh_checks(args, torch, dev, edges, n, graph, unsharded=None):
    """Phase 11: the walk index range-sharded over PPR_SHARDS shards of
    the card: (a) the sharded build; (b) the kernel engine on the mesh
    with the index over MESH_BATCHES of phase 4's feed, each batch held
    to the unsharded repair; (c) a tight capacity; (d) the xla mesh
    engine.  The serve driver with a range-sharded index runs in phase
    10 (c)."""
    phase("11. sharded walk index (walk_repair on four shards)")
    import numpy as np
    from repro_torch.core.pagerank import static_pagerank
    from repro_torch.kernels.pagerank_spmv.pagerank_spmv import \
        LAUNCH_COUNTS as SPMV_COUNTS
    from repro_torch.kernels.pagerank_spmv.shard import ShardCapacityError
    from repro_torch.kernels.walk_repair import walk_repair as wr
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.ppr import (IndexConfig, ShardedWalkIndex,
                                 build_sharded_walk_index, build_walk_index,
                                 ppr_estimate, repair_walk_index,
                                 repair_walk_index_sharded,
                                 shard_stale_counts)
    from repro_torch.ppr import repair as ppr_repair
    from repro_torch.ppr import shard as ppr_shard
    from repro_torch.serve import IngestQueue, RankStore, ServeEngine, \
        ServeMetrics
    from repro_torch.serve import engine as serve_engine
    t_phase = time.perf_counter()
    cfg = IndexConfig(num_walks=PPR_WALKS, max_len=PPR_LEN, seed=SEED)
    mesh = make_test_mesh(PPR_SHARDS, device=dev, model=PPR_SHARDS)
    feed = make_feed(args, edges, n)[:MESH_BATCHES]
    deg = graph.out_degree(include_self_loop=False).cpu().numpy()
    seeds = sorted(int(v) for v in np.random.default_rng(SEED).choice(
        np.flatnonzero(deg >= PPR_MIN_DEG), PPR_SEEDS, replace=False))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = dict(shards=PPR_SHARDS, mesh=str(mesh.shape))

    # (a) the sharded build against the unsharded one
    t0 = time.perf_counter()
    plain = build_walk_index(graph, cfg)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded = build_sharded_walk_index(graph, cfg, mesh=mesh)
    torch.cuda.synchronize()
    out["sharded_build_s"] = time.perf_counter() - t0
    vps = sharded.spec.vertices_per_shard
    check(len(sharded.steps) == PPR_SHARDS and same_walks(torch, sharded,
                                                          plain),
          f"(a) sharded build ({PPR_SHARDS} shards of {vps:,} start "
          f"vertices, {out['sharded_build_s']:.2f} s) == the unsharded "
          f"build ({out['build_s']:.2f} s), bit for bit")
    del sharded

    # (b) the kernel engine on the mesh with the index
    rec = dict(repair=[], resample=[])
    real = dict(repair=serve_engine.repair_walk_index_sharded,
                resample=ppr_shard._resample)

    def timed_repair(index, graph_new, touched, **kw):
        rec["old"] = (index, graph_new, touched)
        start, stop = cuda_events(torch)
        start.record()
        res = real["repair"](index, graph_new, touched, **kw)
        stop.record()
        rec["repair"].append((start, stop))
        return res

    def timed_resample(*a, **kw):
        start, stop = cuda_events(torch)
        start.record()
        res = real["resample"](*a, **kw)
        stop.record()
        rec["resample"].append((start, stop))
        return res

    ranks0 = static_pagerank(graph).ranks
    ingest = IngestQueue(flush_size=FLUSH, flush_interval=1e9, device=dev)
    store, metrics = RankStore(), ServeMetrics()
    eng = ServeEngine(graph, ingest, store, metrics=metrics,
                      method="frontier_prune", engine="kernel", mesh=mesh,
                      ppr_index=cfg)
    rows, first = [], None
    serve_engine.repair_walk_index_sharded = timed_repair
    ppr_shard._resample = timed_resample
    try:
        t0 = time.perf_counter()
        eng.bootstrap(ranks=ranks0)
        torch.cuda.synchronize()
        out["boot_s"] = time.perf_counter() - t0
        served = store.snapshot().ppr_index
        check(isinstance(served, ShardedWalkIndex)
              and all(t.device == d for t, d in
                      zip(served.steps, mesh.axis_devices("model")))
              and same_walks(torch, served, plain),
              f"(b) bootstrap built the index sharded over the mesh's "
              f"model axis ({out['boot_s']:.2f} s) == the unsharded build")
        spmv0 = SPMV_COUNTS["frontier_spmv"]
        for b, events in enumerate(feed):
            for kind, u, v in events:
                ingest.submit(kind, u, v)
            rec["repair"].clear()
            rec["resample"].clear()
            before = wr.LAUNCH_COUNTS["walk_repair"]
            resampled0 = metrics.walks_resampled
            with recording_syncs(torch) as syncs:
                check(eng.step(force=True), f"[ppr mesh] batch {b} served")
            launches = wr.LAUNCH_COUNTS["walk_repair"] - before
            old, graph_new, touched = rec.pop("old")
            by_shard = shard_stale_counts(old, touched)
            del old
            want = sum(-(-int(c) // ppr_repair.REPAIR_CHUNK_WALKS)
                       for c in by_shard)
            # the unsharded repair of the same batch, timed the same way
            start, stop = cuda_events(torch)
            start.record()
            plain, k = repair_walk_index(plain, graph_new, touched)
            stop.record()
            stop.synchronize()
            plain_ms = start.elapsed_time(stop)
            repair_ms = sum(a.elapsed_time(z) for a, z in rec["repair"])
            shard_ms = [a.elapsed_time(z) for a, z in rec["resample"]]
            served = store.snapshot().ppr_index
            if first is None:
                first = served
            row = dict(batch=b, latency_ms=metrics.update_latency_s[-1] * 1e3,
                       stale_by_shard=[int(c) for c in by_shard],
                       repair_ms=repair_ms, shard_resample_ms=shard_ms,
                       unsharded_repair_ms=plain_ms, launches=launches,
                       host_syncs=metrics.batch_host_syncs[-1],
                       measured_syncs=len(syncs))
            rows.append(row)
            print(f"  [ppr mesh] batch {b}: latency_ms="
                  f"{row['latency_ms']:.2f} stale by shard "
                  f"{row['stale_by_shard']} repair_ms={repair_ms:.2f} "
                  f"(resample a shard {median_max(shard_ms)} ms) beside "
                  f"the unsharded repair {plain_ms:.2f} ms; walk_repair="
                  f"{launches} host_syncs={row['host_syncs']} (measured "
                  f"{len(syncs)})", flush=True)
            check(same_walks(torch, served, plain),
                  f"[ppr mesh] batch {b}: every shard == the unsharded "
                  f"repair of the batch, bit for bit")
            check(k == sum(row["stale_by_shard"])
                  and metrics.walks_resampled - resampled0 == k,
                  f"[ppr mesh] batch {b}: {k:,} walks resampled, the "
                  f"shards' stale counts summed")
            check(launches == want and launches > 0,
                  f"[ppr mesh] batch {b}: walk_repair launched {launches} "
                  f"times, once a shard with stale walks")
            if row["host_syncs"] != len(syncs):
                print(f"  [ppr mesh] batch {b}: synchronizing calls by "
                      f"site {sync_sites(syncs)}")
            check(row["host_syncs"] == len(syncs),
                  f"[ppr mesh] batch {b}: host_syncs {row['host_syncs']} "
                  f"== {len(syncs)} synchronizing calls")
        # the serve path's launches (not the unsharded repairs beside it)
        out["launches"] = dict(
            walk_repair=sum(r["launches"] for r in rows),
            frontier_spmv=SPMV_COUNTS["frontier_spmv"] - spmv0)
        check(out["launches"]["frontier_spmv"] > 0,
              f"frontier_spmv launched on the sharded PPR serve path "
              f"({out['launches']})")
        # queries over the shards against the unsharded index
        q = []
        for sd in seeds:
            t = time.perf_counter()
            est = ppr_estimate(served, [sd])
            torch.cuda.synchronize()
            q_ms = (time.perf_counter() - t) * 1e3
            one = ppr_estimate(plain, [sd])
            linf = float((est - one).abs().max())
            q.append(dict(seed=sd, ms=q_ms, linf=linf))
            check(linf <= 1e-12 and top10_agrees(torch, est, one),
                  f"[ppr mesh] seed {sd}: top-10 == the unsharded index's, "
                  f"L_inf {linf:.3e} <= 1e-12 ({q_ms:.2f} ms)")
        out["queries"] = q
        # (c) a tight capacity on the last batch's touched set
        final_graph = store.snapshot().graph
        counts = shard_stale_counts(served, touched)
        tight = max(1, int(counts.max()) // 2)
        try:
            repair_walk_index_sharded(served, final_graph, touched,
                                      capacity=tight)
            over = None
        except ShardCapacityError as e:
            over = list(e.shards)
        check(bool(over) and all(counts[s] > tight for s in over),
              f"(c) capacity {tight:,} (stale by shard {counts.tolist()}) "
              f"raises ShardCapacityError naming shards {over}")
        drop0 = ppr_shard.REPAIR_COUNTS["dropped_stale"]
        got, _ = repair_walk_index_sharded(served, final_graph, touched,
                                           capacity=tight, check=False)
        dropped = ppr_shard.REPAIR_COUNTS["dropped_stale"] - drop0
        check(dropped == sum(int(c) - tight for c in counts if c > tight),
              f"(c) check=False drops {dropped:,} stale walks, the "
              f"overflow past {tight:,} a shard")
        del got
    finally:
        serve_engine.repair_walk_index_sharded = real["repair"]
        ppr_shard._resample = real["resample"]
    del eng, plain, served
    out["rows"] = rows
    lat = sorted(r["latency_ms"] for r in rows)
    out["latency_median_ms"] = lat[len(lat) // 2]
    shard_all = [m for r in rows for m in r["shard_resample_ms"]]
    sharded_txt = median_max([r["repair_ms"] for r in rows])
    plain_txt = median_max([r["unsharded_repair_ms"] for r in rows])
    phase5_txt = ("" if unsharded is None else "; phase 5's unsharded "
                  "repair " + median_max([r["repair_ms"]
                                          for r in unsharded["rows"]])
                  + " ms")
    print(f"  [ppr mesh] repair a batch {sharded_txt} ms; resample a "
          f"shard {median_max(shard_all)} ms; the unsharded repair of the "
          f"same batches {plain_txt} ms{phase5_txt}", flush=True)

    # (d) the xla engine on the 2 x 2 test mesh with the index, one batch
    square = make_test_mesh(4, device=dev)
    ingest = IngestQueue(flush_size=FLUSH, flush_interval=1e9, device=dev)
    store = RankStore()
    eng = ServeEngine(graph, ingest, store, metrics=ServeMetrics(),
                      method="frontier_prune", engine="xla", mesh=square,
                      ppr_index=cfg)
    eng.bootstrap(ranks=ranks0)
    for kind, u, v in feed[0]:
        ingest.submit(kind, u, v)
    t0 = time.perf_counter()
    check(eng.step(force=True), "(d) xla mesh batch 0 served")
    torch.cuda.synchronize()
    out["xla_step_s"] = time.perf_counter() - t0
    got = store.snapshot().ppr_index
    check(len(got.steps) == square.shape["model"]
          and same_walks(torch, got, first),
          f"(d) xla engine on the {square.shape} mesh: its "
          f"{len(got.steps)}-shard index after batch 0 == the kernel mesh "
          f"engine's, bit for bit ({out['xla_step_s']:.2f} s)")
    del eng, got, first

    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase {out['phase_s']:.1f} s; launches {out['launches']}",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 12: the GNN family's training step at full width
# ---------------------------------------------------------------------------

# (architecture, cell) trained at the full config, TRAIN_STEPS AdamW steps
TRAIN_CELLS = (("graphsage-reddit", "ogb_products"),
               ("graphsage-reddit", "minibatch_lg"),
               ("pna", "full_graph_sm"), ("pna", "minibatch_lg"),
               ("graphcast", "full_graph_sm"),
               ("graphcast", "minibatch_lg"), ("nequip", "molecule"))
TRAIN_STEPS = 3
# cells whose steps are also run on the host's CPU and compared
TRAIN_CPU_CELLS = ("full_graph_sm", "molecule")


def bits_equal(torch, a, b) -> bool:
    """Equal bit for bit (NaN included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        kind = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        return torch.equal(a.view(kind), b.view(kind))
    return torch.equal(a, b)


def close_nan(torch, got, want, rtol, atol_frac):
    """(ok, max abs err): finite where ``want`` is, NaN where it is NaN,
    and |got - want| <= atol_frac · max|want| + rtol · |want|; in f64 on
    ``want``'s device."""
    want = want.detach().double()
    got = got.detach().to(want.device).double()
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin):
        return False, float("inf")
    if not bool(fin.any()):
        return True, 0.0
    g, w = got[fin], want[fin]
    diff = (g - w).abs()
    big = float(w.abs().max())
    return (bool((diff <= atol_frac * big + rtol * w.abs()).all()),
            float(diff.max()))


def unrun_cell_bytes(arch, cell):
    """Bytes of the largest tensors a full-width step of a cell saves for
    its backward, where one card cannot hold them, else None."""
    d = cell.dims
    if cell.name != "ogb_products":
        return None
    e = -(-d["n_edges"] // 512) * 512
    if arch == "pna":          # msg_in f32[E, 2·75] a layer, 4 layers
        return e * 150 * 4 * 4, "msg_in f32[E, 150] a layer, x4 layers"
    if arch == "graphcast":    # [hm[src], hm[dst]] f32[E, 1024] a round
        return e * 1024 * 4 * 16, "edge inputs f32[E, 1024] a round, x16"
    if arch == "nequip":       # v_src, m1 [E, 3, 32], m2 [E, 5, 32] a layer
        return e * (3 + 3 + 5) * 32 * 4 * 5, \
            "v_src, m1 f32[E, 3, 32], m2 f32[E, 5, 32] a layer, x5"
    return None


def sampled_blocks(torch, dev, graph, n, spec, cell):
    """graphsage-reddit's minibatch_lg batch from blocks the ported
    NeighborSampler draws on the set-up graph's CSR (host), with random
    features (a table on the card, gathered) and labels from the seed."""
    import numpy as np
    from repro_torch.graph.sampling import NeighborSampler
    d = cell.dims
    csr = graph.to_device_csr()
    indptr = csr.indptr.cpu().numpy()
    indices = csr.indices.cpu().numpy()
    seeds = np.random.default_rng(SEED).choice(n, d["batch_nodes"],
                                               replace=False)
    fanouts = (d["fanout0"], d["fanout1"])
    t0 = time.perf_counter()
    sb = NeighborSampler(indptr, indices, fanouts, seed=SEED).sample(seeds)
    host_ms_ = (time.perf_counter() - t0) * 1e3
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    table = torch.randn(n, spec.config.d_in, generator=gen, device=dev)

    def up(a, dtype):
        return torch.from_numpy(np.asarray(a)).to(device=dev, dtype=dtype)
    hop1, hop2 = sb.blocks
    feats = [table.index_select(0, up(b, torch.int64))
             for b in (hop2.nodes, hop1.nodes, sb.seeds)]
    del table
    batch = dict(
        blocks_feats=feats,
        blocks_parent=[up(hop2.parent, torch.int32),
                       up(hop1.parent, torch.int32)],
        blocks_mask=[up(hop2.mask, torch.bool), up(hop1.mask, torch.bool)],
        labels=torch.randint(0, spec.config.n_classes, (len(seeds),),
                             generator=gen, device=dev, dtype=torch.int32))
    live = int(hop1.mask.sum()) + int(hop2.mask.sum())
    print(f"  [sampler] {len(seeds)} seeds, fanouts {fanouts}: blocks of "
          f"{len(hop1.nodes):,} and {len(hop2.nodes):,} rows ({live:,} "
          f"sampled edges) drawn on the host in {host_ms_:.1f} ms",
          flush=True)
    return batch, host_ms_


def train_cell(torch, dev, spec, cell, tag, batch=None):
    """TRAIN_STEPS AdamW steps of one cell at its full config: loss
    finite (or NaN exactly where the CPU's is), bitwise run to run, each
    pull_rows call of a step held to pull_rows_ref on the card, and on
    TRAIN_CPU_CELLS the steps held to the same steps on the CPU."""
    import copy
    import dataclasses
    from repro_torch.kernels.pull_contrib import pull_contrib as pc
    from repro_torch.kernels.pull_contrib.ref import pull_rows_ref
    from repro_torch.models import gnn as G
    from repro_torch.models import message
    from repro_torch.models.tree import tree_map
    from repro_torch.optim.adamw import init_adamw
    from repro_torch.train import inputs as TI
    from repro_torch.train import steps as TS
    cfg = TI.effective_config(spec, cell, False)
    spec_eff = dataclasses.replace(spec, config=cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    row = dict(arch=spec.arch_id, cell=cell.name, tag=tag)
    t_cell = t0 = time.perf_counter()
    if batch is None:
        batch = TI.build_inputs(spec, cell, concrete=True, smoke=False,
                                seed=1, device=dev)
    torch.cuda.synchronize()
    row["inputs_s"] = time.perf_counter() - t0
    row["input_bytes"] = TI.input_bytes(batch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = TI.init_fn(spec_eff)(gen)
    init = copy.deepcopy(params)
    row["param_count"] = sum(p.numel() for p in params.leaves())
    loss_fn = TS.make_gnn_loss(spec.arch_id, cfg)
    step = TS.make_gnn_train_step(spec.arch_id, cfg)

    def run_steps(p, record=None, data=batch):
        opt = init_adamw(p)
        losses = []
        for s in range(TRAIN_STEPS):
            if record is None:
                p, opt, loss = step(p, opt, data)
                losses.append(loss)
                continue
            launches = pc.LAUNCH_COUNTS["pull_rows"]
            start, stop = cuda_events(torch)
            t = time.perf_counter()
            with recording_syncs(torch) as syncs:
                start.record()
                p, opt, loss = step(p, opt, batch)
                stop.record()
            stop.synchronize()
            record.append(dict(
                step=s, ms=start.elapsed_time(stop),
                wall_ms=(time.perf_counter() - t) * 1e3,
                host_syncs=len(syncs),
                pull_rows=pc.LAUNCH_COUNTS["pull_rows"] - launches,
                loss=float(loss)))
            losses.append(loss)
        return p, losses

    # the main path: TRAIN_STEPS steps, counted
    steps = []
    launches0 = pc.LAUNCH_COUNTS["pull_rows"]
    params, losses = run_steps(params, steps)
    row["pull_rows_launches"] = pc.LAUNCH_COUNTS["pull_rows"] - launches0
    row["steps"] = steps
    row["peak_bytes"] = torch.cuda.max_memory_allocated()
    # forward launches alone (no gradient kept); the rest are backward's
    f0 = pc.LAUNCH_COUNTS["pull_rows"]
    with torch.no_grad():
        loss_fn(params, batch)
    row["pull_rows_forward"] = pc.LAUNCH_COUNTS["pull_rows"] - f0
    row["pull_rows_backward"] = steps[0]["pull_rows"] - \
        row["pull_rows_forward"]
    ms = sorted(s["ms"] for s in steps)
    row["ms_median"] = ms[len(ms) // 2]
    step_ms = ", ".join(f"{s['ms']:.2f}" for s in steps)
    wall_ms = ", ".join(f"{s['wall_ms']:.2f}" for s in steps)
    print(f"  [{tag}] {row['param_count']:,} parameters, inputs "
          f"{row['input_bytes'] / 1e9:.3f} GB built in {row['inputs_s']:.2f}"
          f" s; a step {step_ms} ms (wall {wall_ms}); "
          f"losses {[s['loss'] for s in steps]}; host syncs a step "
          f"{[s['host_syncs'] for s in steps]}; pull_rows a step "
          f"{steps[0]['pull_rows']} (forward {row['pull_rows_forward']}, "
          f"backward {row['pull_rows_backward']}); peak "
          f"{row['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    check(bool(torch.isfinite(losses[0])),
          f"[{tag}] step 0's loss {float(losses[0]):.6g} is finite")
    # sampled blocks have no gather to differentiate: a sum's backward is
    # a gather, so that step launches pull_rows in its forward only
    blocks = "blocks_parent" in batch
    check(row["pull_rows_forward"] > 0
          and (row["pull_rows_backward"] > 0 or blocks),
          f"[{tag}] pull_rows launched in the forward"
          + ("" if blocks else " and the backward"))
    # bit for bit run to run: gradients, then the steps again
    p_a, p_b = copy.deepcopy(init), copy.deepcopy(init)
    la, ga = TS.value_and_grad(loss_fn, p_a, batch)
    lb, gb = TS.value_and_grad(loss_fn, p_b, batch)
    check(bits_equal(torch, la, lb)
          and all(bits_equal(torch, x, y) for x, y in zip(ga, gb)),
          f"[{tag}] loss and {len(ga)} gradients bitwise run to run")
    row["nan_grads"] = int(sum(int(torch.isnan(g).sum()) for g in ga))
    del gb
    again, losses2 = run_steps(copy.deepcopy(init))
    check(all(bits_equal(torch, x, y) for x, y in zip(losses, losses2))
          and all(bits_equal(torch, x.detach(), y.detach())
                  for x, y in zip(params.leaves(), again.leaves())),
          f"[{tag}] {TRAIN_STEPS} steps again: losses and parameters "
          f"bitwise")
    del again
    # each pull_rows call of a step against its plain version on the card
    real = dict(message=message.pull_rows, gnn=G.pull_rows)
    errs = dict(calls=0, bad=0, max_abs_err=0.0)

    def held(order, x, **kw):
        res = real["message"](order, x, **kw)
        ok, err = close_nan(torch, res, pull_rows_ref(order, x), GNN_RTOL,
                            GNN_ATOL)
        errs["calls"] += 1
        errs["bad"] += not ok
        errs["max_abs_err"] = max(errs["max_abs_err"], err)
        return res
    message.pull_rows = G.pull_rows = held
    try:
        TS.value_and_grad(loss_fn, copy.deepcopy(init), batch)
    finally:
        message.pull_rows, G.pull_rows = real["message"], real["gnn"]
    row["pull_rows_check"] = errs
    check(errs["calls"] > 0 and errs["bad"] == 0,
          f"[{tag}] {errs['calls']} pull_rows calls of a step (forward and "
          f"backward) == pull_rows_ref on the card within rtol {GNN_RTOL} / "
          f"atol {GNN_ATOL}·max (max abs err {errs['max_abs_err']:.3e})")
    # the same step on the CPU: its loss and every gradient, then the
    # losses of TRAIN_STEPS steps.  The parameters after the steps are
    # printed, not held: from the second step AdamW moves each parameter
    # by ~lr·sign(g), so an element whose gradient is within rounding of
    # 0 moves either way on either device (graphcast's full config, with
    # activations near 1e15, has many)
    if cell.name in TRAIN_CPU_CELLS:
        t0 = time.perf_counter()
        cpu_batch = tree_map(lambda t: t.cpu(), batch)
        cl, cg = TS.value_and_grad(loss_fn, copy.deepcopy(init).to("cpu"),
                                   cpu_batch)
        ok, _ = close_nan(torch, la, cl, 1e-5, 0.0)
        worst = 0.0
        for x, y in zip(ga, cg):
            good, err = close_nan(torch, x, y, 1e-4, 1e-5)
            ok &= good
            worst = max(worst, err)
        del cg
        cpu, cpu_losses = run_steps(copy.deepcopy(init).to("cpu"),
                                    data=cpu_batch)
        for x, y in zip(losses, cpu_losses):
            ok &= close_nan(torch, x, y, 1e-5, 0.0)[0]
        row["cpu_s"] = time.perf_counter() - t0
        row["cpu_grad_max_abs_err"] = worst
        check(ok, f"[{tag}] == the same step on the CPU "
              f"({row['cpu_s']:.1f} s): loss rtol 1e-5, {len(ga)} "
              f"gradients rtol 1e-4 / atol 1e-5·max (max abs err "
              f"{worst:.3e}), the {TRAIN_STEPS} steps' losses rtol 1e-5")
        off, p_err = 0, 0.0
        for x, y in zip(params.leaves(), cpu.leaves()):
            x, y = x.detach().double().cpu(), y.detach().double()
            d = (x - y).abs()
            p_err = max(p_err, float(d.max()))
            off += int((d > 1e-5 * float(y.abs().max())
                        + 1e-4 * y.abs()).sum())
        row.update(cpu_param_max_abs_err=p_err, cpu_params_off=off)
        print(f"  [{tag}] parameters after {TRAIN_STEPS} steps vs the CPU: "
              f"max abs err {p_err:.3e}, {off:,} of {row['param_count']:,} "
              f"past rtol 1e-4 / atol 1e-5·max", flush=True)
        del cpu, cpu_batch
    del ga
    if row["nan_grads"]:
        print(f"  [{tag}] {row['nan_grads']:,} gradient entries are NaN "
              f"(the reference's std aggregator: sqrt at zero variance); "
              f"losses after step 0 {[float(x) for x in losses[1:]]}",
              flush=True)
    row["cell_s"] = time.perf_counter() - t_cell
    print(f"  [{tag}] {row['cell_s']:.1f} s", flush=True)
    del params, batch, init
    return row


def train_case(torch, dev):
    """pull_rows at a training width: graphcast's processor sum by dst
    (d = 512) on minibatch_lg's slot order, against its plain version and
    one cuSPARSE SpMM of the same matrix, with its bytes bound."""
    from repro_torch.configs.registry import REGISTRY
    from repro_torch.kernels.pull_contrib import pull_contrib as pc
    from repro_torch.kernels.pull_contrib.ref import pull_rows_ref
    from repro_torch.models.message import slot_order
    from repro_torch.train import inputs as TI
    spec = REGISTRY["graphcast"]
    cell = spec.shapes["minibatch_lg"]
    b = TI.build_inputs(spec, cell, concrete=True, smoke=False, seed=1,
                        device=dev)
    dst, m = b["edge_dst"], b["mesh_feats"].shape[0]
    del b
    order, _ = slot_order(dst, m)
    e, d = dst.shape[0], spec.config.d_hidden
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    x = torch.randn(e, d, generator=gen, device=dev)
    call = lambda: pc.pull_rows(order, x, hot_bytes=0)   # noqa: E731
    res = call()
    check(torch.equal(call(), res), f"pull_rows at d={d} (slot order): "
          "bitwise run to run")
    ok, err = close_nan(torch, res, pull_rows_ref(order, x), GNN_RTOL,
                        GNN_ATOL)
    check(ok, f"pull_rows at d={d} (slot order) == pull_rows_ref within "
          f"the GNN tolerance (max abs err {err:.3e})")
    ms = time_ms(torch, call, reps=5, warmup=1)
    plain_ms = time_ms(torch, lambda: pull_rows_ref(order, x), reps=2,
                       warmup=1)
    a = torch.sparse_csr_tensor(
        order.ptr.long(), order.src.long(),
        torch.ones(e, dtype=torch.float32, device=dev), (m, e),
        check_invariants=False)
    lok, lerr = close_nan(torch, torch.sparse.mm(a, x), res, GNN_RTOL,
                          GNN_ATOL)
    library_ms = (time_ms(torch, lambda: torch.sparse.mm(a, x), reps=5,
                          warmup=1) if lok else None)
    bound_ms, bound_by, detail = pull_rows_bound(torch, order, d)
    print(f"  pull_rows d={d} on graphcast minibatch_lg's slots by dst "
          f"({e:,} slots into {m:,} rows): kernel_ms={ms:.4f} plain_ms="
          f"{plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) library_ms="
          + ("- (cuSPARSE disagrees)" if library_ms is None
             else f"{library_ms:.4f} (cuSPARSE CSR SpMM)"), flush=True)
    del x, a, res
    return dict(case=f"train d={d}", ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                max_abs_err=err, library_err=lerr, **detail)


def train_checks(args, torch, dev, edges, n, graph):
    """Phase 12: TRAIN_CELLS at their full configs, TRAIN_STEPS AdamW
    steps each (graphsage-reddit's minibatch_lg twice: its random blocks,
    then blocks the sampler draws on the set-up graph); the cells one
    card cannot hold listed with their bytes; pull_rows at a training
    width."""
    phase("12. GNN training (pull_rows forward and backward)")
    from repro_torch.configs.registry import REGISTRY
    t_phase = time.perf_counter()
    rows = []
    for arch, cell_name in TRAIN_CELLS:
        spec = REGISTRY[arch]
        rows.append(train_cell(torch, dev, spec, spec.shapes[cell_name],
                               f"{arch} {cell_name}"))
        if (arch, cell_name) == ("graphsage-reddit", "minibatch_lg"):
            cell = spec.shapes[cell_name]
            batch, sample_ms = sampled_blocks(torch, dev, graph, n, spec,
                                              cell)
            r = train_cell(torch, dev, spec, cell,
                           f"{arch} {cell_name} sampled", batch=batch)
            r["sampler_host_ms"] = sample_ms
            rows.append(r)
    not_run = []
    for spec in REGISTRY.values():
        if spec.family != "gnn":
            continue
        for cell in spec.shapes.values():
            if (spec.arch_id, cell.name) in TRAIN_CELLS:
                continue
            big = unrun_cell_bytes(spec.arch_id, cell)
            not_run.append(dict(
                arch=spec.arch_id, cell=cell.name,
                bytes=None if big is None else big[0],
                why=("one card cannot hold it: " + big[1]) if big
                else "not in this phase's list"))
    for r in not_run:
        if r["bytes"] is not None:
            print(f"  not run: {r['arch']} {r['cell']}: "
                  f"{r['bytes'] / 1e9:.1f} GB ({r['why']})")
    print("  not run (not in this phase's list): " + ", ".join(
        f"{r['arch']} {r['cell']}" for r in not_run if r["bytes"] is None))
    case = train_case(torch, dev)
    out = dict(cells=rows, not_run=not_run, case=case,
               launches=sum(r["pull_rows_launches"] for r in rows),
               phase_s=time.perf_counter() - t_phase)
    print(f"  phase {out['phase_s']:.1f} s; pull_rows launched "
          f"{out['launches']} times on the train steps", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 13: the LM family at full width
# ---------------------------------------------------------------------------

H100_BF16_FLOPS = 989e12         # dense bf16 tensor-core rate (data sheet)
LM_STEPS = 3                     # AdamW steps a train cell
LM_DECODE_STEPS = 16             # decode steps, from ctx - 16 to ctx
# every LM cell at full width as (layers kept, batch), None keeping the
# config's depth: cut only as far as one 80 GB card and the phase's time
# force (PERF.md §4 lists each cut).  arctic-480b's train_4k is sized and
# printed as not run.
LM_CELLS = {
    "qwen2.5-3b": dict(train_4k=(None, 4), prefill_32k=(None, 2),
                       decode_32k=(None, 32)),
    "gemma3-12b": dict(train_4k=(6, 4), prefill_32k=(6, 2),
                       decode_32k=(6, 16), long_500k=(6, 1)),
    "glm4-9b": dict(train_4k=(8, 4), prefill_32k=(None, 2),
                    decode_32k=(None, 32)),
    "qwen3-moe-30b-a3b": dict(train_4k=(6, 4), prefill_32k=(24, 2),
                              decode_32k=(24, 32)),
    "arctic-480b": dict(prefill_32k=(1, 2), decode_32k=(1, 32)),
}
# the card against the CPU: full width in f32, these depths, a batch of
# LM_CPU_BATCH x LM_CPU_SEQ tokens
LM_CPU_LAYERS = {"qwen2.5-3b": 2, "qwen3-moe-30b-a3b": 1}
LM_CPU_BATCH, LM_CPU_SEQ = 2, 128


def lm_cut(spec, cell_name, layers, batch):
    """(config, cell) of ``spec`` cut to ``layers`` and ``batch``."""
    import dataclasses
    cfg = spec.config if layers is None else dataclasses.replace(
        spec.config, n_layers=layers)
    cell = spec.shapes[cell_name]
    return cfg, dataclasses.replace(cell, dims={**cell.dims,
                                                "batch": batch})


def lm_cut_text(spec, cfg, cell) -> str:
    full = spec.shapes[cell.name].dims["batch"]
    return (f"{cfg.n_layers} of {spec.config.n_layers} layers, batch "
            f"{cell.dims['batch']} of {full}")


def lm_init(torch, dev, spec, cfg):
    """Random parameters of ``cfg`` on the card from the seed."""
    import dataclasses
    from repro_torch.train import inputs as TI
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    return TI.init_fn(dataclasses.replace(spec, config=cfg))(gen)


@contextlib.contextmanager
def held_pull_rows(torch):
    """Every pull_rows call inside the block held to pull_rows_ref on the
    card (GNN_RTOL / GNN_ATOL relative to the largest sum); yields the
    tally."""
    from repro_torch.kernels.pull_contrib.ref import pull_rows_ref
    from repro_torch.models import message
    real = message.pull_rows
    errs = dict(calls=0, bad=0, max_abs_err=0.0, by_width={})

    def held(order, x, **kw):
        res = real(order, x, **kw)
        err, _, bad = compare_rows(res, pull_rows_ref(order, x))
        errs["calls"] += 1
        errs["bad"] += bad
        errs["max_abs_err"] = max(errs["max_abs_err"], err)
        d = x.shape[1]
        errs["by_width"][d] = max(errs["by_width"].get(d, 0.0), err)
        return res
    message.pull_rows = held
    try:
        yield errs
    finally:
        message.pull_rows = real


def lm_train_cell(torch, dev, spec, cfg, cell, twice=False):
    """LM_STEPS AdamW steps of a train cell (the arch's microbatches,
    moment and accumulator dtypes); every pull_rows call of a step held to
    its plain version; with ``twice``, the gradients and then the steps
    again from the same seed, bitwise.  Returns (row, final parameters)."""
    from repro_torch.kernels.pull_contrib import pull_contrib as pc
    from repro_torch.models import transformer as T
    from repro_torch.models.tree import tree_leaves
    from repro_torch.optim.adamw import init_adamw
    from repro_torch.train import inputs as TI
    from repro_torch.train import steps as TS
    arch = spec.arch_id
    tag = f"{arch} {cell.name}"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_cell = time.perf_counter()
    batch = TI.build_inputs(spec, cell, concrete=True, seed=1, device=dev)
    b, s = batch["tokens"].shape
    micro = TI.MICROBATCHES[arch]
    factored = TI.FACTORED_V.get(arch, False)
    mdt = TI.MOMENT_DTYPE.get(arch, torch.float32)
    step = TS.make_lm_train_step(
        cfg, n_microbatches=micro, factored=factored,
        accum_dtype=TI.ACCUM_DTYPE.get(arch, torch.float32))

    def loss_fn(p, bt):
        return T.lm_loss(cfg, p, bt["tokens"], bt["labels"])
    params = lm_init(torch, dev, spec, cfg)
    row = dict(arch=arch, cell=cell.name, kind="train",
               cut=lm_cut_text(spec, cfg, cell), layers=cfg.n_layers,
               batch=b, seq=s, microbatches=micro,
               param_count=sum(p.numel() for p in tree_leaves(params)))
    mb = {k: v[: b // micro] for k, v in batch.items()}
    f0 = pc.LAUNCH_COUNTS["pull_rows"]
    with torch.no_grad():
        loss_fn(params, mb)
    row["pull_rows_forward"] = pc.LAUNCH_COUNTS["pull_rows"] - f0
    # a microbatch's gradients: every pull_rows call held to its plain
    # version; with ``twice``, again, bitwise
    with held_pull_rows(torch) as errs:
        la, ga = TS.value_and_grad(loss_fn, params, mb)
    row["pull_rows_check"] = errs
    check(errs["calls"] > 0 and errs["bad"] == 0,
          f"[{tag}] {errs['calls']} pull_rows calls of a microbatch "
          f"(forward and backward) == pull_rows_ref on the card within "
          f"rtol {GNN_RTOL} / atol {GNN_ATOL}·max (max abs err "
          f"{errs['max_abs_err']:.3e})")
    if twice:
        lb, gb = TS.value_and_grad(loss_fn, params, mb)
        check(bits_equal(torch, la, lb)
              and all(bits_equal(torch, x, y) for x, y in zip(ga, gb)),
              f"[{tag}] loss and {len(ga)} gradients bitwise run to run")
        del gb
    del ga

    def run(p, n, keep_first=False):
        """n steps from ``p``; with ``keep_first``, also a copy of the
        parameters after the first."""
        opt = init_adamw(p, moment_dtype=mdt, factored=factored)
        rec, first = [], None
        for i in range(n):
            launches = pc.LAUNCH_COUNTS["pull_rows"]
            start, stop = cuda_events(torch)
            t = time.perf_counter()
            with recording_syncs(torch) as syncs:
                start.record()
                p, opt, loss = step(p, opt, batch)
                stop.record()
            stop.synchronize()
            ms = start.elapsed_time(stop)
            rec.append(dict(step=i, ms=ms,
                            wall_ms=(time.perf_counter() - t) * 1e3,
                            host_syncs=len(syncs),
                            pull_rows=pc.LAUNCH_COUNTS["pull_rows"]
                            - launches, loss=float(loss),
                            tokens_per_s=b * s / (ms / 1e3)))
            if keep_first and i == 0:
                first = [x.detach().clone() for x in tree_leaves(p)]
        del opt
        return ((p, first) if keep_first else p), rec

    params, steps = run(params, LM_STEPS, keep_first=twice)
    if twice:
        params, first = params
    row.update(steps=steps, peak_bytes=torch.cuda.max_memory_allocated(),
               launches=sum(r["pull_rows"] for r in steps))
    row["pull_rows_backward"] = steps[0]["pull_rows"] // micro - \
        row["pull_rows_forward"]
    check(all(math.isfinite(r["loss"]) for r in steps),
          f"[{tag}] {LM_STEPS} losses finite: {[r['loss'] for r in steps]}")
    # the embedding's backward sums its rows through pull_rows; an MoE's
    # combine sums its pairs by token forward too
    check(row["pull_rows_backward"] > 0
          and (row["pull_rows_forward"] > 0 or not cfg.is_moe),
          f"[{tag}] pull_rows launched in the backward"
          + (" and the forward" if cfg.is_moe else ""))
    if twice:
        del params
        again, steps2 = run(lm_init(torch, dev, spec, cfg), 1)
        check(steps[0]["loss"] == steps2[0]["loss"]
              and all(bits_equal(torch, x, y.detach())
                      for x, y in zip(first, tree_leaves(again))),
              f"[{tag}] the first step again from the seed: loss and "
              f"{len(first)} updated parameters bitwise")
        row["launches"] += sum(r["pull_rows"] for r in steps2)
        del first
        params = again
    row["cell_s"] = time.perf_counter() - t_cell
    ms = ", ".join(f"{r['ms']:.1f}" for r in steps)
    print(f"  [{tag}] {row['cut']}, {micro} microbatches of "
          f"{b // micro} x {s}; {row['param_count'] / 1e9:.3f} B "
          f"parameters; a step {ms} ms ({steps[-1]['tokens_per_s']:,.0f} "
          f"tokens/s after the first); host syncs a step "
          f"{[r['host_syncs'] for r in steps]}; pull_rows a step "
          f"{steps[0]['pull_rows']} ({row['pull_rows_forward']} forward, "
          f"{row['pull_rows_backward']} backward a microbatch); peak "
          f"{row['peak_bytes'] / 2**30:.2f} GiB; {row['cell_s']:.1f} s",
          flush=True)
    return row, params


def lm_prefill_cell(torch, dev, spec, cfg, cell, params):
    """One prefill of a cell (the last position's logits)."""
    from repro_torch.kernels.pull_contrib import pull_contrib as pc
    from repro_torch.train import inputs as TI
    from repro_torch.train import steps as TS
    tag = f"{spec.arch_id} {cell.name}"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tokens = TI.build_inputs(spec, cell, concrete=True, seed=1,
                             device=dev)["tokens"]
    b, s = tokens.shape
    launches = pc.LAUNCH_COUNTS["pull_rows"]
    start, stop = cuda_events(torch)
    start.record()
    logits = TS.make_lm_prefill(cfg)(params, tokens)
    stop.record()
    stop.synchronize()
    ms = start.elapsed_time(stop)
    row = dict(arch=spec.arch_id, cell=cell.name, kind="prefill",
               cut=lm_cut_text(spec, cfg, cell), layers=cfg.n_layers,
               batch=b, seq=s, ms=ms, tokens_per_s=b * s / (ms / 1e3),
               launches=pc.LAUNCH_COUNTS["pull_rows"] - launches,
               peak_bytes=torch.cuda.max_memory_allocated())
    check(tuple(logits.shape) == (b, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"[{tag}] {row['cut']} x {s}: last-position logits "
          f"[{b}, {cfg.vocab}] finite; {ms:.1f} ms "
          f"({row['tokens_per_s']:,.0f} tokens/s), pull_rows "
          f"{row['launches']}, peak {row['peak_bytes'] / 2**30:.2f} GiB")
    return row


def lm_decode_cell(torch, dev, spec, cfg, cell, params):
    """LM_DECODE_STEPS greedy decode steps into a full-size KV cache whose
    contents are drawn on the card, from ctx - LM_DECODE_STEPS to ctx."""
    from repro_torch.kernels.pull_contrib import pull_contrib as pc
    from repro_torch.models import transformer as T
    from repro_torch.train import inputs as TI
    from repro_torch.train import steps as TS
    tag = f"{spec.arch_id} {cell.name}"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    batch = TI.build_inputs(spec, cell, concrete=True, seed=1, device=dev)
    b, ctx = batch["batch"], batch["ctx"]
    cache = T.init_cache(cfg, b, ctx, length=ctx - LM_DECODE_STEPS,
                         device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    for i in range(cfg.n_layers):
        cache.k[i].normal_(generator=gen)
        cache.v[i].normal_(generator=gen)
    cache_bytes = 2 * cache.k.numel() * cache.k.element_size()
    decode = TS.make_lm_decode_step(cfg)
    toks = batch["tokens"]
    rec = []
    launches = pc.LAUNCH_COUNTS["pull_rows"]
    finite = True
    for i in range(LM_DECODE_STEPS):
        start, stop = cuda_events(torch)
        with recording_syncs(torch) as syncs:
            start.record()
            logits, cache = decode(params, cache, toks)
            stop.record()
        toks = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        stop.synchronize()
        finite &= bool(torch.isfinite(logits).all())
        rec.append(dict(step=i, ms=start.elapsed_time(stop),
                        host_syncs=len(syncs)))
    ms = sorted(r["ms"] for r in rec[1:])
    row = dict(arch=spec.arch_id, cell=cell.name, kind="decode",
               cut=lm_cut_text(spec, cfg, cell), layers=cfg.n_layers,
               batch=b, ctx=ctx, cache_bytes=cache_bytes, steps=rec,
               ms_median=ms[len(ms) // 2],
               launches=pc.LAUNCH_COUNTS["pull_rows"] - launches,
               peak_bytes=torch.cuda.max_memory_allocated())
    check(finite and int(cache.length) == ctx,
          f"[{tag}] {row['cut']}, cache {cache_bytes / 1e9:.2f} GB at "
          f"{ctx:,}: {LM_DECODE_STEPS} steps, logits finite, length "
          f"{ctx:,}; a step {rec[0]['ms']:.2f} ms first, "
          f"{row['ms_median']:.2f} median after ({b} tokens a step); host "
          f"syncs a step {[r['host_syncs'] for r in rec]}; pull_rows "
          f"{row['launches']}; peak {row['peak_bytes'] / 2**30:.2f} GiB")
    del cache
    return row


def lm_train_bytes(torch, spec, layers):
    """(bytes, text) of what a train step of ``spec`` at ``layers`` layers
    holds before any activation: weights, gradients, the accumulator and
    the moments (factored second moments as rows and columns)."""
    import dataclasses
    from repro_torch.optim.adamw import _FACTOR_MIN_SIZE
    from repro_torch.train import inputs as TI
    arch = spec.arch_id
    cfg = dataclasses.replace(spec.config, n_layers=layers)
    # the leaves' shapes and bytes, as init_lm lays them out
    d, hd, h, kvh = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    e, fm = cfg.n_experts, cfg.moe_d_ff
    f = cfg.d_ff if (not cfg.is_moe or cfg.dense_residual) else 0
    shapes = [((cfg.vocab, d), 2), ((d,), 2)]
    shapes += [((layers,) + s, 2) for s in (
        (d,), (d, h * hd), (d, kvh * hd), (d, kvh * hd), (h * hd,),
        (kvh * hd,), (kvh * hd,), (h * hd, d), (d,), (d, f), (d, f),
        (f, d))]
    if cfg.is_moe:
        shapes += [((layers, d, e), 4), ((layers, e, d, fm), 2),
                   ((layers, e, d, fm), 2), ((layers, e, fm, d), 2)]
    n = lambda s: math.prod(s)     # noqa: E731
    weights = sum(n(s) * w for s, w in shapes)
    accum = TI.ACCUM_DTYPE.get(arch, torch.float32).itemsize
    mom = TI.MOMENT_DTYPE.get(arch, torch.float32).itemsize
    fac = TI.FACTORED_V.get(arch, False)
    m = sum(n(s) * mom for s, _ in shapes)
    v = sum((n(s[:-1]) + n(s[:-2] + s[-1:])) * 4
            if fac and len(s) >= 2 and n(s) >= _FACTOR_MIN_SIZE
            else n(s) * mom for s, _ in shapes)
    total = 2 * weights + sum(n(s) for s, _ in shapes) * accum + m + v
    return total, (f"{layers} layer: weights {weights / 1e9:.1f} GB, "
                   f"gradients {weights / 1e9:.1f}, accumulator "
                   f"{sum(n(s) for s, _ in shapes) * accum / 1e9:.1f}, "
                   f"moments {m / 1e9:.1f} + {v / 1e9:.1f} (factored)")


def lm_cpu_case(torch, dev, spec, layers):
    """The card against the CPU at full width in f32 (``layers`` layers, a
    batch of LM_CPU_BATCH x LM_CPU_SEQ): the MoE's routing (top-k experts
    and kept pairs) first, then the loss (rtol 1e-5), every gradient and,
    after one AdamW update (lr 3e-4), every parameter and moment (rtol
    1e-4 / atol 1e-5·max).  Returns (row, the card's parameters)."""
    import dataclasses
    import numpy as np
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.models.tree import tree_leaves, tree_map
    from repro_torch.optim.adamw import adamw_update_, init_adamw
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.train import steps as TS
    tag = f"{spec.arch_id} f32 x {layers} layer(s)"
    t0 = time.perf_counter()
    cfg = dataclasses.replace(spec.config, n_layers=layers, dtype="float32")
    card = lm_init(torch, dev, spec, cfg)
    host = T.trainable(tree_map(lambda p: p.detach().cpu(), card))
    rng = np.random.default_rng(SEED)
    toks = rng.integers(0, cfg.vocab, (LM_CPU_BATCH, LM_CPU_SEQ + 1))
    data = {k: torch.from_numpy(v.astype(np.int32)) for k, v in
            (("tokens", toks[:, :-1]), ("labels", toks[:, 1:]))}
    routes = dict(card=[], cpu=[])
    real = moe.route

    def loss_fn(p, b):
        return T.lm_loss(cfg, p, b["tokens"], b["labels"])

    def grads(where, p, b):
        def recorded(*a, **kw):
            r = real(*a, **kw)
            routes[where].append((r.slot, r.keep))
            return r
        moe.route = recorded
        try:
            return TS.value_and_grad(loss_fn, p, b)
        finally:
            moe.route = real
    lc, gc = grads("card", card, {k: v.to(dev) for k, v in data.items()})
    lh, gh = grads("cpu", host, data)
    row = dict(arch=spec.arch_id, layers=layers,
               param_count=sum(p.numel() for p in tree_leaves(card)))
    if cfg.is_moe:
        flips = sum(int((a.cpu() != b).sum()) + int((k.cpu() != m).sum())
                    for (a, k), (b, m) in zip(routes["card"], routes["cpu"]))
        row["routing_flips"] = flips
        check(len(routes["card"]) == len(routes["cpu"]) > 0 and flips == 0,
              f"[{tag}] MoE routing equal on card and CPU: every pair's "
              f"slot and kept mask ({flips} differ; a difference is a "
              f"routing flip, after which the sums are not comparable)")
    ok, _ = close_nan(torch, lc, lh, 1e-5, 0.0)
    worst = 0.0
    for x, y in zip(gc, gh):
        good, err = close_nan(torch, x, y.to(dev), 1e-4, 1e-5)
        ok &= good
        worst = max(worst, err)
    check(ok, f"[{tag}] == the CPU: loss {float(lc):.6f} vs "
          f"{float(lh):.6f} (rtol 1e-5), {len(gc)} gradients rtol 1e-4 / "
          f"atol 1e-5·max (max abs err {worst:.3e})")
    # one AdamW update from each side's gradients (lr at its peak).  The
    # first update moves an element by lr·g / (|g| + eps), ~lr·sign(g):
    # where the two gradients differ by more than rtol 1e-4 (held above
    # only by the bound's atol: near 0, the key bias's gradient being one
    # near-cancellation) the update is not determined to rtol 1e-4 and
    # those elements are counted, not held
    states = []
    for p, g in ((card, gc), (host, gh)):
        opt = init_adamw(p)
        lr = warmup_cosine(opt.step, peak_lr=3e-4, warmup_steps=0,
                           total_steps=10_000)
        states.append(adamw_update_(p, g, opt, lr=lr))
    ok, p_err, loose = True, 0.0, 0
    for x, y, g, h in zip(tree_leaves(card), tree_leaves(host), gc, gh):
        h = h.to(dev)
        sure = (g - h).abs() <= 1e-4 * h.abs()
        loose += int((~sure).sum())
        good, err = close_nan(torch, x.detach()[sure], y.detach().to(dev)[
            sure], 1e-4, 1e-5)
        ok &= good
        p_err = max(p_err, err)
    for x, y in zip(states[0].m + states[0].v, states[1].m + states[1].v):
        good, err = close_nan(torch, x, y.to(dev), 1e-4, 1e-5)
        ok &= good
        p_err = max(p_err, err)
    del gc, gh
    row.update(loss_card=float(lc), loss_cpu=float(lh), grad_max_abs_err=worst,
               param_max_abs_err=p_err, params_not_held=loose,
               seconds=time.perf_counter() - t0)
    check(ok, f"[{tag}] after one AdamW update: parameters and moments == "
          f"the CPU's within rtol 1e-4 / atol 1e-5·max (max abs err "
          f"{p_err:.3e}; {loose:,} parameters whose two gradients differ "
          f"by more than rtol 1e-4 not held); "
          f"{row['param_count'] / 1e9:.3f} B parameters, "
          f"{row['seconds']:.1f} s")
    del host, states
    return row, card, cfg


def lm_decode_matches_prefill(torch, dev, cfg, params):
    """Decode token by token from an empty cache against prefill's
    last-position logits, f32 at full width (the reference's
    test_decode_matches_prefill_logits: rtol / atol 2e-3)."""
    import numpy as np
    from repro_torch.models import transformer as T
    from repro_torch.train import steps as TS
    n = 16
    toks = torch.from_numpy(np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab, (2, n)).astype(np.int32)).to(dev)
    want = TS.make_lm_prefill(cfg)(params, toks)
    cache = T.init_cache(cfg, 2, 2 * n, device=dev)
    decode = TS.make_lm_decode_step(cfg)
    for t in range(n):
        got, cache = decode(params, cache, toks[:, t:t + 1])
    err = float((got[:, 0] - want).abs().max())
    ok = bool(torch.allclose(got[:, 0], want, rtol=2e-3, atol=2e-3))
    check(ok, f"[{cfg.name} f32 x {cfg.n_layers} layers] decode of {n} "
          f"tokens == prefill's last-position logits within rtol / atol "
          f"2e-3 (max abs err {err:.3e})")
    return err


def attention_yardstick(torch, dev, b=2, s=32768):
    """One qwen2.5-3b layer's attention at 2 x 32,768 (16 query heads over
    2 kv heads, head dim 128, bf16): chunked_causal_attention beside
    F.scaled_dot_product_attention(is_causal=True), their max abs
    difference, and the causal FLOP bound at the bf16 peak.  Printed, not
    gated: the fused call is no part of the port."""
    import torch.nn.functional as F
    from repro_torch.models import layers as L
    h, kvh, d = 16, 2, 128
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    q = torch.randn(b, s, h, d, generator=gen, device=dev).bfloat16()
    k = torch.randn(b, s, kvh, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(b, s, kvh, d, generator=gen, device=dev).bfloat16()
    with torch.no_grad():
        ours = L.chunked_causal_attention(q, k, v, chunk=512)
        ms = time_ms(torch, lambda: L.chunked_causal_attention(
            q, k, v, chunk=512), reps=3, warmup=1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), reps=5, warmup=1)
        diff = float((ours.float() - lib.transpose(1, 2).float()).abs()
                     .max())
    flops = 4 * b * h * d * s * (s + 1) / 2     # QK^T and PV, causal half
    bound_ms = flops / H100_BF16_FLOPS * 1e3
    print(f"  attention yardstick, one qwen2.5-3b layer at {b} x {s:,} "
          f"(bf16): chunked_causal_attention {ms:.2f} ms, "
          f"F.scaled_dot_product_attention(is_causal=True) {lib_ms:.2f} ms, "
          f"max abs difference {diff:.3e}, bound {bound_ms:.2f} ms "
          f"({flops / 1e12:.2f} TFLOP at 989 TFLOP/s bf16)", flush=True)
    del q, k, v, ours, lib
    return dict(ms=ms, library_ms=lib_ms, max_abs_diff=diff,
                bound_ms=bound_ms, flops=flops)


def lm_checks(args, torch, dev):
    """Phase 13: every LM cell at full width (LM_CELLS' cuts), the card
    against the CPU, decode against prefill, the attention yardstick."""
    phase("13. LM family (train, prefill, decode at full width)")
    from repro_torch.configs.registry import REGISTRY
    t_phase = time.perf_counter()
    rows = []
    for arch, cells in LM_CELLS.items():
        spec = REGISTRY[arch]
        params = None
        if "train_4k" in cells:
            cfg, cell = lm_cut(spec, "train_4k", *cells["train_4k"])
            row, params = lm_train_cell(torch, dev, spec, cfg, cell,
                                        twice=arch == "qwen2.5-3b")
            rows.append(row)
            if cfg.n_layers != (cells["prefill_32k"][0]
                                or spec.config.n_layers):
                params = None
        else:
            big, why = lm_train_bytes(torch, spec, 1)
            rows.append(dict(arch=arch, cell="train_4k", kind="train",
                             not_run=big, why=why))
            print(f"  not run: {arch} train_4k: {big / 1e9:.1f} GB before "
                  f"any activation ({why}) > one 80 GB card", flush=True)
        torch.cuda.empty_cache()
        for name in ("prefill_32k", "decode_32k", "long_500k"):
            if name not in cells:
                continue
            cfg, cell = lm_cut(spec, name, *cells[name])
            if params is None:
                params = lm_init(torch, dev, spec, cfg)
            if cell.kind == "prefill":
                rows.append(lm_prefill_cell(torch, dev, spec, cfg, cell,
                                            params))
            else:
                rows.append(lm_decode_cell(torch, dev, spec, cfg, cell,
                                           params))
        del params
        torch.cuda.empty_cache()
    skipped = [f"{s.arch_id} {c.name}" for s in REGISTRY.values()
               if s.family == "lm" for c in s.shapes.values() if c.skip]
    print(f"  skipped as in the reference (full attention at 500k): "
          f"{', '.join(skipped)}")
    cpu = []
    for arch, layers in LM_CPU_LAYERS.items():
        row, params, cfg = lm_cpu_case(torch, dev, REGISTRY[arch], layers)
        if not cfg.is_moe:
            row["decode_vs_prefill_err"] = lm_decode_matches_prefill(
                torch, dev, cfg, params)
        cpu.append(row)
        del params
        torch.cuda.empty_cache()
    yardstick = attention_yardstick(torch, dev)
    out = dict(cells=rows, cpu=cpu, yardstick=yardstick,
               launches=sum(r.get("launches", 0) for r in rows),
               phase_s=time.perf_counter() - t_phase)
    print(f"  phase {out['phase_s']:.1f} s; pull_rows launched "
          f"{out['launches']} times on the LM cells", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 14: the recsys family (DeepFM) at its full config
# ---------------------------------------------------------------------------

RECSYS_STEPS = 3                 # AdamW steps of train_batch
RECSYS_SERVE_CALLS = 200         # serve_p99 calls timed (after 5 warm-up)
# the card against the CPU: full widths, this many rows a field, a batch
RECSYS_CPU_VOCAB, RECSYS_CPU_BATCH = 10_000, 1_024


def recsys_bound(spec, cell) -> dict:
    """The ported roofline's terms for a DeepFM cell on one card: its
    FLOPs (``model_flops``) at f32's rate and its bytes
    (``recsys_model_bytes``) at HBM's; the bound is the larger."""
    from repro_torch.roofline import analysis as RA
    flops = RA.model_flops(spec, cell)
    nbytes = RA.recsys_model_bytes(spec, cell)
    b = RA.analytic_bound(flops, nbytes)
    return dict(flops=flops, bytes=nbytes, flop_ms=b["compute_s"] * 1e3,
                bytes_ms=b["memory_s"] * 1e3, bound_ms=b["bound_s"] * 1e3,
                bound_by=b["bound_by"])


def bound_text(b) -> str:
    """A cell's bound and both its terms, for a line of the phase."""
    return (f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
            f"({b['flops']:.3e} FLOP = {b['flop_ms']:.4f} ms at 67 TFLOP/s "
            f"f32; {b['bytes'] / 1e9:.4f} GB = {b['bytes_ms']:.4f} ms at "
            f"3.35 TB/s)")


def recsys_init(torch, dev, cfg):
    """DeepFM's parameters of ``cfg`` on ``dev``, drawn from the seed."""
    from repro_torch.models.recsys import init_deepfm
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    return init_deepfm(cfg, gen)


def recsys_loss_fn(cfg):
    from repro_torch.models import recsys as R
    return lambda p, b: R.deepfm_loss(cfg, p, b["sparse_ids"], b["labels"])


def recsys_grad_checks(torch, dev, spec, batch) -> dict:
    """train_batch's loss and gradients from the seed's parameters: every
    pull_rows call held to pull_rows_ref on the card (the two tables'
    gradients, d = embed_dim and 1), then again, bitwise."""
    from repro_torch.models.tree import tree_leaves
    from repro_torch.train import steps as TS
    cfg = spec.config
    tag = "deepfm train_batch"
    params = recsys_init(torch, dev, cfg)
    n = sum(p.numel() for p in tree_leaves(params))
    check(n == cfg.param_count() + 1,
          f"[{tag}] {n:,} parameters on the card == the config's "
          f"param_count + the scalar bias it leaves out (the reference's "
          f"count; {cfg.total_rows:,} table rows)")
    loss_fn = recsys_loss_fn(cfg)
    with held_pull_rows(torch) as errs:
        la, ga = TS.value_and_grad(loss_fn, params, batch)
    check(errs["calls"] == 2 and errs["bad"] == 0
          and sorted(errs["by_width"]) == [1, cfg.embed_dim],
          f"[{tag}] the gradients' {errs['calls']} pull_rows calls (d = "
          f"{sorted(errs['by_width'])}) == pull_rows_ref on the card within "
          f"rtol {GNN_RTOL} / atol {GNN_ATOL}·max (max abs err "
          f"{errs['max_abs_err']:.3e})")
    lb, gb = TS.value_and_grad(loss_fn, params, batch)
    check(bits_equal(torch, la, lb)
          and all(bits_equal(torch, x, y) for x, y in zip(ga, gb)),
          f"[{tag}] loss {float(la):.6f} and {len(ga)} gradients bitwise "
          f"run to run")
    return errs


def recsys_steps(torch, dev, spec, batch):
    """RECSYS_STEPS AdamW steps of train_batch from the seed's parameters,
    each timed with CUDA events, its syncs recorded; returns (parameters,
    optimizer state, one row a step)."""
    from repro_torch.kernels.pull_contrib import pull_contrib as pc
    from repro_torch.optim.adamw import init_adamw
    from repro_torch.train import steps as TS
    cfg = spec.config
    b = batch["sparse_ids"].shape[0]
    step = TS.make_recsys_train_step(cfg)
    params = recsys_init(torch, dev, cfg)
    opt = init_adamw(params)
    rows = []
    for i in range(RECSYS_STEPS):
        launches = pc.LAUNCH_COUNTS["pull_rows"]
        start, stop = cuda_events(torch)
        t = time.perf_counter()
        with recording_syncs(torch) as syncs:
            start.record()
            params, opt, loss = step(params, opt, batch)
            stop.record()
        stop.synchronize()
        ms = start.elapsed_time(stop)
        rows.append(dict(step=i, ms=ms,
                         wall_ms=(time.perf_counter() - t) * 1e3,
                         host_syncs=len(syncs), sync_sites=sync_sites(syncs),
                         pull_rows=pc.LAUNCH_COUNTS["pull_rows"] - launches,
                         loss=float(loss), samples_per_s=b / (ms / 1e3)))
    return params, opt, rows


def recsys_serve_cells(torch, dev, spec, params) -> dict:
    """serve_p99 (RECSYS_SERVE_CALLS calls, host clock to a sync),
    serve_bulk and retrieval_cand (CUDA events) on ``params``; each
    output checked for its shape and range."""
    import statistics
    from repro_torch.train import inputs as TI
    from repro_torch.train import steps as TS
    cfg = spec.config
    serve = TS.make_recsys_serve(cfg)
    retrieve = TS.make_recsys_retrieval(cfg)
    out = {}
    sb = TI.build_inputs(spec, spec.shapes["serve_p99"], concrete=True,
                         seed=1, device=dev)
    for _ in range(5):
        serve(params, sb)
    torch.cuda.synchronize()
    lat = []
    for _ in range(RECSYS_SERVE_CALLS):
        t = time.perf_counter()
        probs = serve(params, sb)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    lat.sort()
    out["serve_p99"] = dict(batch=sb["sparse_ids"].shape[0],
                            calls=len(lat), p50_ms=statistics.median(lat),
                            p99_ms=lat[math.ceil(0.99 * len(lat)) - 1],
                            max_ms=lat[-1])
    for name in ("serve_bulk", "retrieval_cand"):
        cell = spec.shapes[name]
        inp = TI.build_inputs(spec, cell, concrete=True, seed=1, device=dev)
        fn = serve if cell.kind == "recsys_serve" else retrieve
        res = fn(params, inp)
        ms = time_ms(torch, lambda: fn(params, inp), reps=5, warmup=1)
        n = (inp["sparse_ids"].shape[0] if cell.kind == "recsys_serve"
             else inp["cand_ids"].shape[0])
        out[name] = dict(rows=n, ms=ms, per_s=n / (ms / 1e3),
                         finite=bool(torch.isfinite(res).all()),
                         shape=list(res.shape))
        if cell.kind == "recsys_serve":
            out[name]["in_range"] = bool(((res >= 0) & (res <= 1)).all())
    out["serve_p99"].update(finite=bool(torch.isfinite(probs).all()),
                            in_range=bool(((probs >= 0) & (probs <= 1))
                                          .all()),
                            shape=list(probs.shape))
    return out


def recsys_split(torch, dev, spec, params, batch, steps) -> dict:
    """Where a train step's time goes: its gradients (forward and
    backward), within them the slot order and chunk plan and each
    pull_rows, and the rest of the step (AdamW); each pull_rows beside
    its plain version, ``index_add_`` and its bound."""
    from repro_torch.kernels.pull_contrib import pull_contrib as pc
    from repro_torch.kernels.pull_contrib.ref import ROW_CHUNK, \
        pull_rows_ref
    from repro_torch.models import message
    from repro_torch.models.recsys import _field_ids
    from repro_torch.train import steps as TS
    cfg = spec.config
    loss_fn = recsys_loss_fn(cfg)
    grad_ms = time_ms(torch, lambda: TS.value_and_grad(loss_fn, params,
                                                       batch),
                      reps=3, warmup=1)
    ids = _field_ids(cfg, batch["sparse_ids"]).reshape(-1)
    n = cfg.total_rows

    def order_and_plan():
        order, _ = message.slot_order(ids.clone(), n)
        pc.row_plan(order, ROW_CHUNK)
    order_ms = time_ms(torch, order_and_plan, reps=3, warmup=1)
    order, _ = message.slot_order(ids, n)
    n_empty = int((order.ptr[1:] == order.ptr[:-1]).sum())
    plan = pc.row_plan(order, ROW_CHUNK)
    n_chunks = int((plan.window < n).sum())
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 14)
    kernels = {}
    for d in (cfg.embed_dim, 1):
        g = torch.randn(ids.shape[0], d, generator=gen, device=dev)
        out = pc.pull_rows(order, g, hot_bytes=0)
        err, big, bad = compare_rows(out, pull_rows_ref(order, g))
        vec, loads = pc.row_path(d, g.data_ptr())
        lanes = pc.row_lanes(d, vec)
        check(bad == 0 and bits_equal(torch, out, pc.pull_rows(
                  order, g, hot_bytes=0)),
              f"[deepfm pull_rows d = {d}] the train step's order "
              f"({ids.shape[0]:,} slots into {n:,} rows, {n_empty:,} of "
              f"them empty; {n_chunks:,} chunks; row path {(vec, loads)}, "
              f"{lanes} of 32 lanes a chunk) == pull_rows_ref on the card "
              f"within "
              f"rtol {GNN_RTOL} / atol {GNN_ATOL}·max (max abs err "
              f"{err:.3e}) and bitwise run to run")
        # and bitwise the plain version on the CPU, over the same order
        cpu_order = type(order)(*(t.cpu() for t in order))
        check(torch.equal(out.cpu(), pull_rows_ref(cpu_order, g.cpu())),
              f"[deepfm pull_rows d = {d}] == pull_rows_ref on the CPU, "
              f"bit for bit")
        del cpu_order
        bound_ms, bound_by, detail = pull_rows_bound(torch, order, d)
        idx = ids.long()
        call = lambda: pc.pull_rows(order, g, hot_bytes=0)  # noqa: E731
        kernels[d] = dict(
            d=d, max_abs_err=err, row_path=[vec, loads], lanes=lanes,
            empty_rows=n_empty, chunks=n_chunks,
            device_split_ms={k: device_ms(torch, call, (f"pull_rows_{k}",),
                                          reps=5)
                             for k in ("packed", "fill", "split")},
            ms=time_ms(torch, call, reps=5, warmup=1),
            plain_ms=time_ms(torch, lambda: pull_rows_ref(order, g), reps=3,
                             warmup=1),
            library_ms=time_ms(torch, lambda: torch.zeros(
                n, d, device=dev).index_add_(0, idx, g), reps=5, warmup=1),
            bound_ms=bound_ms, bound_by=bound_by, bound_detail=detail)
        del g, out
    later = [r["ms"] for r in steps[1:]] or [steps[0]["ms"]]
    step_ms = sorted(later)[len(later) // 2]
    rows_ms = sum(k["ms"] for k in kernels.values())
    return dict(step_ms=step_ms, grad_ms=grad_ms, order_plan_ms=order_ms,
                pull_rows_ms=rows_ms, adamw_ms=step_ms - grad_ms,
                forward_backward_rest_ms=grad_ms - order_ms - rows_ms,
                adamw_bytes_ms=7 * 4 * (cfg.param_count() + 1)
                / H100_BYTES_PER_S * 1e3, kernels=kernels)


def recsys_cpu_case(torch, dev, spec) -> dict:
    """The card against the CPU at full widths on RECSYS_CPU_VOCAB rows a
    field: the loss (rtol 1e-5), every gradient and, after one AdamW
    update (lr 1e-3), every parameter and moment (rtol 1e-4 / atol
    1e-5·max; parameters whose two gradients differ by more than rtol
    1e-4 counted, not held); serve and retrieval (rtol 1e-5 / atol
    1e-6·max)."""
    import dataclasses
    import numpy as np
    from repro_torch.models.tree import trainable
    from repro_torch.models.tree import tree_leaves, tree_map
    from repro_torch.optim.adamw import adamw_update_, init_adamw
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.train import steps as TS
    cfg = dataclasses.replace(spec.config, vocab_per_field=RECSYS_CPU_VOCAB)
    tag = (f"deepfm f32 x {RECSYS_CPU_VOCAB:,} rows a field, batch "
           f"{RECSYS_CPU_BATCH:,}")
    t0 = time.perf_counter()
    card = recsys_init(torch, dev, cfg)
    host = trainable(tree_map(lambda p: p.detach().cpu(), card))
    rng = np.random.default_rng(SEED)
    data = dict(
        sparse_ids=torch.from_numpy(rng.integers(
            0, cfg.vocab_per_field, (RECSYS_CPU_BATCH, cfg.n_sparse))
            .astype(np.int32)),
        labels=torch.from_numpy((rng.random(RECSYS_CPU_BATCH) < 0.5)
                                .astype(np.float32)))
    on_card = {k: v.to(dev) for k, v in data.items()}
    loss_fn = recsys_loss_fn(cfg)
    lc, gc = TS.value_and_grad(loss_fn, card, on_card)
    lh, gh = TS.value_and_grad(loss_fn, host, data)
    ok, _ = close_nan(torch, lc, lh, 1e-5, 0.0)
    worst = 0.0
    for x, y in zip(gc, gh):
        good, err = close_nan(torch, x, y.to(dev), 1e-4, 1e-5)
        ok &= good
        worst = max(worst, err)
    check(ok, f"[{tag}] == the CPU: loss {float(lc):.7f} vs {float(lh):.7f} "
              f"(rtol 1e-5), {len(gc)} gradients rtol 1e-4 / atol 1e-5·max "
              f"(max abs err {worst:.3e})")
    # one AdamW update from each side's gradients, lr at its peak: where
    # the two gradients differ by more than rtol 1e-4 the first update
    # (~lr·sign(g)) is not determined to rtol 1e-4: counted, not held
    states = []
    for p, g in ((card, gc), (host, gh)):
        opt = init_adamw(p)
        lr = warmup_cosine(opt.step, peak_lr=1e-3, warmup_steps=0,
                           total_steps=10_000)
        states.append(adamw_update_(p, g, opt, lr=lr, weight_decay=0.0))
    ok, p_err, loose = True, 0.0, 0
    for x, y, g, h in zip(tree_leaves(card), tree_leaves(host), gc, gh):
        h = h.to(dev)
        sure = (g - h).abs() <= 1e-4 * h.abs()
        loose += int((~sure).sum())
        good, err = close_nan(torch, x.detach()[sure],
                              y.detach().to(dev)[sure], 1e-4, 1e-5)
        ok &= good
        p_err = max(p_err, err)
    for x, y in zip(states[0].m + states[0].v, states[1].m + states[1].v):
        good, err = close_nan(torch, x, y.to(dev), 1e-4, 1e-5)
        ok &= good
        p_err = max(p_err, err)
    check(ok, f"[{tag}] after one AdamW update: parameters and moments == "
              f"the CPU's within rtol 1e-4 / atol 1e-5·max (max abs err "
              f"{p_err:.3e}; {loose:,} of {cfg.param_count():,} parameters "
              f"whose two gradients differ by more than rtol 1e-4 not held)")
    serve = TS.make_recsys_serve(cfg)
    retrieve = TS.make_recsys_retrieval(cfg)
    query = dict(query_ids=data["sparse_ids"][:1],
                 cand_ids=torch.from_numpy(rng.integers(
                     0, cfg.vocab_per_field, 100_000).astype(np.int32)))
    outs = {}
    for name, fn, inp in (("serve", serve, data), ("retrieval", retrieve,
                                                   query)):
        got = fn(card, {k: v.to(dev) for k, v in inp.items()})
        want = fn(host, inp)
        good, err = close_nan(torch, got, want.to(dev), 1e-5, 1e-6)
        outs[name] = err
        check(good, f"[{tag}] {name} on the card == the CPU within rtol "
                    f"1e-5 / atol 1e-6·max (max abs err {err:.3e}, "
                    f"{tuple(got.shape)})")
    return dict(loss_card=float(lc), loss_cpu=float(lh),
                grad_max_abs_err=worst, param_max_abs_err=p_err,
                params_not_held=loose, serve_max_abs_err=outs["serve"],
                retrieval_max_abs_err=outs["retrieval"],
                seconds=time.perf_counter() - t0)


def recsys_checks(args, torch, dev):
    """Phase 14: DeepFM's four cells at the full config through the
    ported step makers, each beside its roofline bound; the step's split;
    the card against the CPU; pull_rows at d = 10 and 1."""
    phase("14. RecSys family (DeepFM train, serve, retrieval at full "
          "config)")
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.pull_contrib import pull_contrib as pc
    from repro_torch.models.tree import tree_leaves
    from repro_torch.train import inputs as TI
    t_phase = time.perf_counter()
    spec = get_arch("deepfm")
    cfg = spec.config
    tag = "deepfm train_batch"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    batch = TI.build_inputs(spec, spec.shapes["train_batch"], concrete=True,
                            seed=1, device=dev)
    b = batch["sparse_ids"].shape[0]
    held = recsys_grad_checks(torch, dev, spec, batch)
    torch.cuda.empty_cache()
    # the main path: every count set to 0 just before, read just after
    pc.LAUNCH_COUNTS["pull_rows"] = 0
    pc.ROW_WIDTH_LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats()
    params, opt, steps = recsys_steps(torch, dev, spec, batch)
    peak_train = torch.cuda.max_memory_allocated()   # one run's
    again_params, again_opt, again = recsys_steps(torch, dev, spec, batch)
    same = (all(a["loss"] == c["loss"] for a, c in zip(steps, again))
            and all(bits_equal(torch, x.detach(), y.detach()) for x, y in
                    zip(tree_leaves(params) + opt.m + opt.v,
                        tree_leaves(again_params) + again_opt.m
                        + again_opt.v)))
    del again_params, again_opt, opt
    torch.cuda.empty_cache()
    serving = recsys_serve_cells(torch, dev, spec, params)
    launches = pc.LAUNCH_COUNTS["pull_rows"]
    by_width = dict(pc.ROW_WIDTH_LAUNCHES)
    # the main path's checks
    ms = ", ".join(f"{r['ms']:.2f}" for r in steps)
    check(all(math.isfinite(r["loss"]) for r in steps) and same,
          f"[{tag}] {RECSYS_STEPS} AdamW steps (losses "
          f"{[round(r['loss'], 6) for r in steps]}) run twice from the "
          f"seed: losses, {len(tree_leaves(params))} parameters and their "
          f"moments bitwise")
    check(all(r["host_syncs"] == 0 for r in steps + again),
          f"[{tag}] host syncs a step {[r['host_syncs'] for r in steps]} "
          f"(set_sync_debug_mode): none")
    n_steps = len(steps) + len(again)
    check(launches == 2 * n_steps
          and by_width == {cfg.embed_dim: n_steps, 1: n_steps},
          f"[{tag}] pull_rows launched {launches} times in {n_steps} steps "
          f"(by width {by_width}): the table's and table_w's gradients, "
          f"one each a step; none in serve or retrieval")
    train_bound = recsys_bound(spec, spec.shapes["train_batch"])
    print(f"  [{tag}] batch {b:,}, {cfg.param_count():,} parameters: a "
          f"step {ms} ms (first, later; {steps[-1]['samples_per_s']:,.0f} "
          f"samples/s after the first); peak {peak_train / 2**30:.2f} GiB; "
          f"{bound_text(train_bound)}", flush=True)
    for name in ("serve_p99", "serve_bulk", "retrieval_cand"):
        r = serving[name]
        r["bound"] = recsys_bound(spec, spec.shapes[name])
        check(r["finite"] and r.get("in_range", True),
              f"[deepfm {name}] output {r['shape']} finite"
              + (" and in [0, 1]" if "in_range" in r else ""))
    s99, bulk, ret = (serving[k] for k in ("serve_p99", "serve_bulk",
                                           "retrieval_cand"))
    print(f"  [deepfm serve_p99] batch {s99['batch']}: p50 "
          f"{s99['p50_ms']:.4f} ms, p99 {s99['p99_ms']:.4f} ms, max "
          f"{s99['max_ms']:.4f} over {s99['calls']} calls (host clock to a "
          f"sync); {bound_text(s99['bound'])}", flush=True)
    print(f"  [deepfm serve_bulk] batch {bulk['rows']:,}: {bulk['ms']:.4f} "
          f"ms ({bulk['per_s']:,.0f} samples/s); "
          f"{bound_text(bulk['bound'])}", flush=True)
    print(f"  [deepfm retrieval_cand] 1 query x {ret['rows']:,} "
          f"candidates: {ret['ms']:.4f} ms; {bound_text(ret['bound'])}",
          flush=True)
    split = recsys_split(torch, dev, spec, params, batch, steps)
    print(f"  [{tag}] where a step's {split['step_ms']:.2f} ms go: "
          f"gradients {split['grad_ms']:.2f} (slot order and plan "
          f"{split['order_plan_ms']:.2f}, pull_rows "
          f"{split['pull_rows_ms']:.2f}, the rest of the forward and backward "
          f"{split['forward_backward_rest_ms']:.2f}), AdamW "
          f"{split['adamw_ms']:.2f} (its 7 passes' bytes bound "
          f"{split['adamw_bytes_ms']:.2f})", flush=True)
    for d, k in split["kernels"].items():
        print(f"  [deepfm pull_rows d = {d}] {k['ms']:.4f} ms, plain "
              f"{k['plain_ms']:.4f}, index_add_ {k['library_ms']:.4f}, bound "
              f"{k['bound_ms']:.4f} ({k['bound_by']}), row path "
              f"{k['row_path']}, {k['lanes']} of 32 lanes a chunk; device by "
              f"launch {k['device_split_ms']}", flush=True)
    del params
    torch.cuda.empty_cache()
    cpu = recsys_cpu_case(torch, dev, spec)
    for d, err in held["by_width"].items():
        k = split["kernels"][d]
        k["max_abs_err"] = max(k["max_abs_err"], err)
        k["launches"] = by_width.get(d, 0)
    out = dict(train=dict(steps=steps, again=again, peak_bytes=peak_train,
                          bound=train_bound, pull_rows_check=held),
               serving=serving, split=split, cpu=cpu, launches=launches,
               kernels=split["kernels"],
               phase_s=time.perf_counter() - t_phase)
    print(f"  phase {out['phase_s']:.1f} s; pull_rows launched {launches} "
          f"times on the DeepFM steps", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 15: the dry-run
# ---------------------------------------------------------------------------

# the reference's dry-run test's four cells (one a family, and pagerank on
# the multi-pod mesh), run on the production multi mesh
DRYRUN_MULTI_CELLS = (("qwen2.5-3b", "decode_32k"),
                      ("graphsage-reddit", "minibatch_lg"),
                      ("deepfm", "train_batch"),
                      ("df-pagerank", "temporal_so"))
# the counting mode against the production mode on the card: full width
# in f32 at these depths, a batch of COUNTING_BATCH x COUNTING_SEQ tokens
COUNTING_LAYERS = {"qwen2.5-3b": 2, "qwen3-moe-30b-a3b": 1}
COUNTING_BATCH, COUNTING_SEQ, COUNTING_DECODE_STEPS = 1, 1024, 4
# the dry-run's peak a device over one step's on the card ((1, 1) mesh)
# (set from runs on an H100 80GB HBM3 at 700 W, which read 0.999-1.000 in
# all three)
DRYRUN_PEAK_BOUNDS = {("deepfm", "train_batch"): (0.95, 1.05),
                      ("deepfm", "serve_bulk"): (0.95, 1.05),
                      ("qwen2.5-3b", "train_4k"): (0.95, 1.05)}


def dryrun_sweep():
    """Phase 15 (a): the dry-run of every cell on the single mesh and of
    DRYRUN_MULTI_CELLS on the multi mesh, on ``meta`` positions (no device
    touched), in worker processes; every cell OK, or SKIP where its
    ``skip`` says, none FAIL; the roofline table of the records."""
    import shutil
    import tempfile
    from repro_torch.configs.registry import REGISTRY, all_cells
    from repro_torch.launch import dryrun as D
    from repro_torch.roofline import analysis as RA
    out = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    jobs = max(1, min(D.MAX_JOBS, os.cpu_count() or 1))
    t0 = time.perf_counter()
    pool = D.worker_pool(jobs)
    try:
        import concurrent.futures
        cells = dict(single=list(all_cells(include_pagerank=True)),
                     multi=[(REGISTRY[a], REGISTRY[a].shapes[c])
                            for a, c in DRYRUN_MULTI_CELLS])
        # both meshes' cells share the pool: the multi sweep's on a thread
        with concurrent.futures.ThreadPoolExecutor(1) as side:
            multi = side.submit(D.sweep, cells["multi"], "multi", out,
                                pool=pool)
            records = dict(single=D.sweep(cells["single"], "single", out,
                                          pool=pool),
                           multi=multi.result())
        for mesh_name, wanted in cells.items():
            recs = records[mesh_name]
            bad = [f"{spec.arch_id}/{cell.name}: {r['status']} "
                   f"{r.get('error', '')[:300]}"
                   for (spec, cell), r in zip(wanted, recs)
                   if r["status"] != ("SKIP" if cell.skip else "OK")
                   or (r["status"] == "OK" and not r["cost"]["flops"] > 0)]
            ok = sum(r["status"] == "OK" for r in recs)
            skip = sum(r["status"] == "SKIP" for r in recs)
            check(not bad and ok + skip == len(recs) == len(wanted),
                  f"[dry-run {mesh_name}] {ok} OK, {skip} SKIP (each where "
                  f"its cell says), 0 FAIL, FLOPs counted on every OK cell"
                  + "".join(f"; {b}" for b in bad))
        rows = RA.build_table(out)
        check(len(rows) == sum(len(c) for c in cells.values())
              and all(r.collective_s is None for r in rows
                      if r.status == "OK"),
              f"roofline.build_table reads the {len(rows)} records "
              f"(collective term n/a)")
        print(RA.to_markdown(rows), flush=True)
    finally:
        pool.shutdown(cancel_futures=True)
        shutil.rmtree(out, ignore_errors=True)
    seconds = time.perf_counter() - t0
    print(f"  dry-run: {len(records['single'])} cells on (16, 16), "
          f"{len(records['multi'])} on (2, 16, 16), {jobs} worker "
          f"processes, {seconds:.1f} s", flush=True)
    return dict(records=records, seconds=seconds, jobs=jobs,
                table=[dict(arch=r.arch, shape=r.shape, mesh=r.mesh,
                            status=r.status, dominant=r.dominant,
                            model_over_hlo=r.useful_ratio,
                            peak_gib=r.peak_gib) for r in rows])


def counting_checks(torch, dev):
    """Phase 15 (b): the LM's counting mode against its production mode on
    the card, full width in f32 (COUNTING_LAYERS), a batch of
    COUNTING_BATCH x COUNTING_SEQ: the loss (rtol 1e-5) and every gradient
    (rtol 1e-4 / atol 1e-5·max), prefill logits and COUNTING_DECODE_STEPS
    decode steps (rtol 1e-4 / atol 1e-5·max); the embedding's backward a
    ``pull_rows`` kernel in both modes."""
    import dataclasses
    import numpy as np
    from repro_torch.configs.registry import REGISTRY
    from repro_torch.kernels.pull_contrib import pull_contrib as pc
    from repro_torch.models import transformer as T
    from repro_torch.train import steps as TS
    rows = []
    for arch, layers in COUNTING_LAYERS.items():
        spec = REGISTRY[arch]
        t0 = time.perf_counter()
        cfg = dataclasses.replace(spec.config, n_layers=layers,
                                  dtype="float32")
        counted = dataclasses.replace(cfg, counting=True)
        tag = f"{arch} f32 x {layers} layer(s), counting mode"
        params = lm_init(torch, dev, spec, cfg)
        toks = np.random.default_rng(SEED).integers(
            0, cfg.vocab, (COUNTING_BATCH, COUNTING_SEQ + 1))
        data = {k: torch.from_numpy(v.astype(np.int32)).to(dev) for k, v in
                (("tokens", toks[:, :-1]), ("labels", toks[:, 1:]))}
        launches = {}
        got = {}
        for mode, c in (("production", cfg), ("counting", counted)):
            before = pc.LAUNCH_COUNTS["pull_rows"]
            got[mode] = TS.value_and_grad(
                lambda p, b, c=c: T.lm_loss(c, p, b["tokens"], b["labels"]),
                params, data)
            launches[mode] = pc.LAUNCH_COUNTS["pull_rows"] - before
        (lp, gp), (lc, gc) = got["production"], got["counting"]
        ok, _ = close_nan(torch, lc, lp, 1e-5, 0.0)
        worst = 0.0
        for x, y in zip(gc, gp):
            good, err = close_nan(torch, x, y, 1e-4, 1e-5)
            ok &= good
            worst = max(worst, err)
        del got, gp, gc
        check(ok and launches["counting"] > 0 and launches["production"] > 0,
              f"[{tag}] == the production mode on the card: loss "
              f"{float(lc):.6f} vs {float(lp):.6f} (rtol 1e-5), gradients "
              f"rtol 1e-4 / atol 1e-5·max (max abs err {worst:.3e}); "
              f"pull_rows launched {launches['counting']} (counting) and "
              f"{launches['production']} (production) times")
        before = pc.LAUNCH_COUNTS["pull_rows"]
        tokens = data["tokens"]
        pre = [TS.make_lm_prefill(c)(params, tokens) for c in (cfg, counted)]
        ok, pre_err = close_nan(torch, pre[1], pre[0], 1e-4, 1e-5)
        caches = [T.init_cache(c, COUNTING_BATCH, 2 * COUNTING_DECODE_STEPS,
                               device=dev) for c in (cfg, counted)]
        dec_err = 0.0
        for t in range(COUNTING_DECODE_STEPS):
            outs = []
            for i, c in enumerate((cfg, counted)):
                logits, caches[i] = TS.make_lm_decode_step(c)(
                    params, caches[i], tokens[:, t:t + 1])
                outs.append(logits)
            good, err = close_nan(torch, outs[1], outs[0], 1e-4, 1e-5)
            ok &= good
            dec_err = max(dec_err, err)
        row = dict(arch=arch, layers=layers, loss_counting=float(lc),
                   loss_production=float(lp), grad_max_abs_err=worst,
                   prefill_max_abs_err=pre_err, decode_max_abs_err=dec_err,
                   launches=sum(launches.values())
                   + pc.LAUNCH_COUNTS["pull_rows"] - before,
                   seconds=time.perf_counter() - t0)
        check(ok, f"[{tag}] prefill logits and {COUNTING_DECODE_STEPS} "
              f"decode steps == the production mode's within rtol 1e-4 / "
              f"atol 1e-5·max (max abs err {pre_err:.3e}, {dec_err:.3e}); "
              f"{row['seconds']:.1f} s")
        rows.append(row)
        del params, caches, pre, outs
        torch.cuda.empty_cache()
    return rows


def card_step(torch, dev, spec, cell):
    """One step of ``cell`` on the card from the seed: (peak bytes over
    what was allocated before its arguments, step ms, pull_rows
    launches).  The arguments are made first; the step's peak counts
    them."""
    from repro_torch.kernels.pull_contrib import pull_contrib as pc
    from repro_torch.optim.adamw import init_adamw
    from repro_torch.train import inputs as TI
    from repro_torch.train import steps as TS
    arch, cfg = spec.arch_id, spec.config
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    batch = TI.build_inputs(spec, cell, concrete=True, seed=1, device=dev)
    if spec.family == "recsys":
        params = recsys_init(torch, dev, cfg)
        if cell.kind == "recsys_train":
            opt = init_adamw(params)
            step = TS.make_recsys_train_step(cfg)
            run = lambda: step(params, opt, batch)        # noqa: E731
        else:
            serve = TS.make_recsys_serve(cfg)
            run = lambda: serve(params, batch)            # noqa: E731
    else:
        params = lm_init(torch, dev, spec, cfg)
        opt = init_adamw(params,
                         moment_dtype=TI.MOMENT_DTYPE.get(arch, torch.float32),
                         factored=TI.FACTORED_V.get(arch, False))
        step = TS.make_lm_train_step(
            cfg, n_microbatches=TI.MICROBATCHES[arch],
            factored=TI.FACTORED_V.get(arch, False),
            accum_dtype=TI.ACCUM_DTYPE.get(arch, torch.float32))
        run = lambda: step(params, opt, batch)            # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = pc.LAUNCH_COUNTS["pull_rows"]
    start, stop = cuda_events(torch)
    start.record()
    out = run()
    stop.record()
    stop.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out, params, batch
    return peak, start.elapsed_time(stop), \
        pc.LAUNCH_COUNTS["pull_rows"] - before


def dryrun_vs_card(torch, dev, smi):
    """Phase 15 (c): each DRYRUN_PEAK_BOUNDS cell's dry-run on a (1, 1)
    mesh of ``meta`` positions against one step on the card: the predicted
    peak a device over ``max_memory_allocated`` within its bounds, and
    the predicted FLOPs over the step's time as TFLOP/s."""
    import dataclasses
    from repro_torch.configs.registry import REGISTRY
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_meta_mesh
    mesh = make_meta_mesh((1, 1))
    rows = []
    for (arch, name), (lo, hi) in DRYRUN_PEAK_BOUNDS.items():
        spec = REGISTRY[arch]
        cell = spec.shapes[name]
        cut = ""
        if arch in LM_CELLS:                   # phase 13's cut
            cfg, cell = lm_cut(spec, name, *LM_CELLS[arch][name])
            spec = dataclasses.replace(spec, config=cfg)
            cut = f" ({lm_cut_text(REGISTRY[arch], cfg, cell)})"
        rec = D.run_cell(spec, cell, mesh, "card", verbose=False)
        check(rec["status"] == "OK", f"[dry-run {arch} {name}] on a (1, 1) "
              f"mesh: {rec['status']} {rec.get('error', '')[:300]}")
        predicted = rec["memory"]["peak_per_device_bytes"]
        flops = rec["cost"]["flops"]       # the production step's
        peak, ms, launches = card_step(torch, dev, spec, cell)
        ratio = predicted / peak
        row = dict(arch=arch, cell=name, cut=cut, predicted_peak=predicted,
                   card_peak=peak, ratio=ratio, flops=flops, step_ms=ms,
                   tflops=flops / (ms / 1e3) / 1e12, launches=launches,
                   bounds=(lo, hi), card=smi)
        check(lo <= ratio <= hi,
              f"[dry-run vs card] {arch} {name}{cut}: predicted peak "
              f"{predicted / 2**30:.2f} GiB, the card's "
              f"{peak / 2**30:.2f} GiB, ratio {ratio:.3f} within "
              f"[{lo}, {hi}]; predicted {flops:.4g} FLOP in a "
              f"{ms:.2f} ms step: {row['tflops']:.2f} TFLOP/s; card: {smi}")
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def dryrun_checks(args, torch, dev, smi):
    """Phase 15: the dry-run (a), the counting mode on the card (b), the
    dry-run against the card (c)."""
    phase("15. dry-run (meta device), counting mode, dry-run vs card")
    t_phase = time.perf_counter()
    sweep = dryrun_sweep()
    counting = counting_checks(torch, dev)
    versus = dryrun_vs_card(torch, dev, smi)
    out = dict(sweep=sweep, counting=counting, versus=versus,
               launches=sum(r["launches"] for r in counting + versus),
               phase_s=time.perf_counter() - t_phase)
    print(f"  phase {out['phase_s']:.1f} s (the sweep {sweep['seconds']:.1f}"
          f" s); pull_rows launched {out['launches']} times; card: {smi}",
          flush=True)
    return out


def peak_memory(torch, name: str) -> None:
    """Print the phase's peak of allocated device memory, then reset it."""
    print(f"  phase {name} peak memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    torch.cuda.reset_peak_memory_stats()


def write_out(args, record) -> None:
    """``--out FILE``: every measurement of the run as JSON."""
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1, default=str)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--out", default=None,
                    help="also write every measurement as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="trace the last serve step of each engine and of "
                         "the PPR phase with torch.profiler (its latency "
                         "then includes the tracing)")
    ap.add_argument("--gnn-kernels-only", action="store_true",
                    help="run only the set-up and phase 6's pull_rows and "
                         "gated_spmm kernel cases; prints their JSON last "
                         "and no summary")
    ap.add_argument("--replicas-only", action="store_true",
                    help="run only the set-up and phase 9 (replicas, the "
                         "iteration budget, Gauss-Seidel); prints its "
                         "launches last and no summary")
    ap.add_argument("--mesh-only", action="store_true",
                    help="run only the set-up and phase 10 (the tuner, "
                         "the sharded engines); prints its launches last "
                         "and no summary")
    ap.add_argument("--ppr-mesh-only", action="store_true",
                    help="run only the set-up and phase 11 (the sharded "
                         "walk index); prints its launches last and no "
                         "summary")
    ap.add_argument("--train-only", action="store_true",
                    help="run only the set-up and phase 12 (GNN "
                         "training); prints its launches last and no "
                         "summary")
    ap.add_argument("--lm-only", action="store_true",
                    help="run only the build, the device and phase 13 (the "
                         "LM family; no R-MAT set-up); prints its launches "
                         "last and no summary")
    ap.add_argument("--dryrun-only", action="store_true",
                    help="run only the build, the device and phase 15 (the "
                         "dry-run, the counting mode, the dry-run against "
                         "the card; no R-MAT set-up); prints its launches "
                         "last and no summary")
    ap.add_argument("--recsys-only", action="store_true",
                    help="run only the build, the device and phase 14 (the "
                         "recsys family; no R-MAT set-up); prints its "
                         "launches last and no summary")
    ap.add_argument("--spmv-kernels-only", action="store_true",
                    help="run only the set-up, phase 3's frontier_spmv and "
                         "phase 3b's pull_contrib and edge-slot count "
                         "kernel cases; prints their JSON last and no "
                         "summary")
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
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    # the kernel engine tunes its geometry at bootstrap: its cache lives
    # in a temporary directory of this run (the launch drivers this run
    # starts in subprocesses inherit it), never under the home directory
    import shutil
    import tempfile
    tune_dir = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    os.environ["REPRO_TORCH_TUNE_CACHE"] = os.path.join(tune_dir,
                                                        "kernel_tune.json")
    try:
        return run(args, torch, dev, t_start)
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)


def run(args, torch, dev, t_start) -> int:
    """Every phase (or the one that ``args`` asks for) on the card."""
    builds = build_kernels()
    name, smi = device_info(torch)
    if args.lm_only:
        only = lm_checks(args, torch, dev)
        peak_memory(torch, "13")
        print(f"  wall {time.perf_counter() - t_start:.1f} s; card: {smi}")
        write_out(args, dict(device=name, nvidia_smi=smi, args=vars(args),
                             lm=only))
        print(json.dumps({"lm_launches": only["launches"]}))
        return 0
    if args.dryrun_only:
        only = dryrun_checks(args, torch, dev, smi)
        peak_memory(torch, "15")
        print(f"  wall {time.perf_counter() - t_start:.1f} s; card: {smi}")
        write_out(args, dict(device=name, nvidia_smi=smi, args=vars(args),
                             dryrun=only))
        print(json.dumps({"dryrun_launches": only["launches"]}))
        return 0
    if args.recsys_only:
        only = recsys_checks(args, torch, dev)
        peak_memory(torch, "14")
        print(f"  wall {time.perf_counter() - t_start:.1f} s; card: {smi}")
        write_out(args, dict(device=name, nvidia_smi=smi, args=vars(args),
                             recsys=only))
        print(json.dumps({"recsys_launches": only["launches"]}))
        return 0
    phase("setup: graph")
    edges, n, graph = make_graph(torch, dev)
    if args.gnn_kernels_only:
        only = gnn_kernel_cases(args, torch, dev, edges, n, graph)
        print(f"  wall {time.perf_counter() - t_start:.1f} s; card: {smi}")
        write_out(args, dict(device=name, nvidia_smi=smi, args=vars(args),
                             gnn=only))
        print(json.dumps({"gnn_cases": only["cases"],
                          "row_cases": only["row_sum"]["cases"]}))
        return 0
    if args.mesh_only:
        only = mesh_checks(args, torch, dev, edges, n, graph)
        peak_memory(torch, "10")
        print(f"  wall {time.perf_counter() - t_start:.1f} s; card: {smi}")
        write_out(args, dict(device=name, nvidia_smi=smi, args=vars(args),
                             mesh=only))
        print(json.dumps({"mesh_launches": only["launches"]}))
        return 0
    if args.ppr_mesh_only:
        only = ppr_mesh_checks(args, torch, dev, edges, n, graph)
        peak_memory(torch, "11")
        print(f"  wall {time.perf_counter() - t_start:.1f} s; card: {smi}")
        write_out(args, dict(device=name, nvidia_smi=smi, args=vars(args),
                             ppr_mesh=only))
        print(json.dumps({"ppr_mesh_launches": only["launches"]}))
        return 0
    if args.train_only:
        only = train_checks(args, torch, dev, edges, n, graph)
        peak_memory(torch, "12")
        print(f"  wall {time.perf_counter() - t_start:.1f} s; card: {smi}")
        write_out(args, dict(device=name, nvidia_smi=smi, args=vars(args),
                             train=only))
        print(json.dumps({"train_launches": only["launches"]}))
        return 0
    if args.replicas_only:
        only = replica_checks(args, torch, dev, edges, n, graph)
        peak_memory(torch, "9")
        print(f"  wall {time.perf_counter() - t_start:.1f} s; card: {smi}")
        write_out(args, dict(device=name, nvidia_smi=smi, args=vars(args),
                             replicas=only))
        print(json.dumps({"replica_launches": only["launches"]}))
        return 0
    cases, max_err, spmv_kernel = kernel_checks(torch, dev, graph)
    peak_memory(torch, "3")
    contrib = contrib_checks(torch, dev, graph)
    counts = count_checks(torch, dev, graph)
    peak_memory(torch, "3b")
    if args.spmv_kernels_only:
        print(f"  wall {time.perf_counter() - t_start:.1f} s; card: {smi}")
        write_out(args, dict(device=name, nvidia_smi=smi, args=vars(args),
                             build={k: dict(seconds=v["seconds"],
                                            log=v["log"])
                                    for k, v in builds.items()},
                             spmv=spmv_kernel, spmv_cases=cases,
                             contrib=contrib, counts=counts))
        print(json.dumps({"spmv_cases": cases}))
        return 0
    serve = serve_checks(args, torch, dev, edges, n, graph)
    peak_memory(torch, "4")
    torch.cuda.empty_cache()              # phase 4's engines are gone
    ppr = ppr_checks(args, torch, dev, edges, n, graph)
    peak_memory(torch, "5")
    torch.cuda.empty_cache()              # phase 5's walk index is gone
    gnn = gnn_checks(args, torch, dev, edges, n, graph)
    peak_memory(torch, "6")
    torch.cuda.empty_cache()              # phase 6's features are gone
    paper = paper_checks(args, torch, dev, edges, n, graph)
    peak_memory(torch, "7")
    torch.cuda.empty_cache()
    observ = obs_checks(args, torch, dev, edges, n, graph, serve)
    peak_memory(torch, "8")
    torch.cuda.empty_cache()
    replicas = replica_checks(args, torch, dev, edges, n, graph)
    peak_memory(torch, "9")
    torch.cuda.empty_cache()
    mesh = mesh_checks(args, torch, dev, edges, n, graph)
    peak_memory(torch, "10")
    torch.cuda.empty_cache()
    ppr_mesh = ppr_mesh_checks(args, torch, dev, edges, n, graph,
                               unsharded=ppr)
    peak_memory(torch, "11")
    torch.cuda.empty_cache()
    train = train_checks(args, torch, dev, edges, n, graph)
    peak_memory(torch, "12")
    del edges, graph
    torch.cuda.empty_cache()
    lm = lm_checks(args, torch, dev)
    peak_memory(torch, "13")
    torch.cuda.empty_cache()
    recsys = recsys_checks(args, torch, dev)
    peak_memory(torch, "14")
    torch.cuda.empty_cache()
    dry = dryrun_checks(args, torch, dev, smi)
    peak_memory(torch, "15")
    extra = replicas["launches"]           # phase 9's launches

    phase("16. summary")
    main_case = next(c for c in cases
                     if c["frac"] == 0.05 and c["dtype"] == "float32")
    kernels = [dict(
        name="frontier_spmv", route="cuda",
        source="src/repro_torch/kernels/pagerank_spmv/csrc/frontier_spmv.cu",
        replaces="src/repro/kernels/pagerank_spmv/pagerank_spmv.py:239",
        launches=serve["kernel"]["launches"].get("frontier_spmv", 0)
        + extra["frontier_spmv"] + mesh["launches"]
        + ppr_mesh["launches"]["frontier_spmv"],
        max_abs_err=max(max_err, mesh["tune"]["max_abs_err"],
                        mesh["shard_kernels"]["max_abs_err"]),
        ms=main_case["ms"],
        plain_ms=main_case["plain_ms"], bound_ms=main_case["bound_ms"],
        bound_by=main_case["bound_by"],
        library_ms=main_case["library_ms"]), dict(
        name="walk_repair", route="cuda",
        source="src/repro_torch/kernels/walk_repair/csrc/walk_repair.cu",
        replaces="src/repro/kernels/walk_repair/walk_repair.py:72",
        launches=ppr["launches"]["walk_repair"] + extra["walk_repair"]
        + ppr_mesh["launches"]["walk_repair"],
        max_abs_err=ppr["kernel"]["max_abs_err"], ms=ppr["kernel"]["ms"],
        plain_ms=ppr["kernel"]["plain_ms"],
        bound_ms=ppr["kernel"]["bound_ms"],
        bound_by=ppr["kernel"]["bound_by"], library_ms=None)]
    gnn_case = next(c for c in gnn["cases"] if c["case"] == "batch")
    kernels.append(dict(
        name="gated_spmm", route="cuda",
        source="src/repro_torch/kernels/segment_ops/csrc/gated_spmm.cu",
        replaces="src/repro/kernels/segment_ops/segment_matmul.py:55",
        launches=gnn["launches"], max_abs_err=gnn["max_abs_err"],
        ms=gnn_case["ms"], plain_ms=gnn_case["plain_ms"],
        bound_ms=gnn_case["bound_ms"], bound_by=gnn_case["bound_by"],
        library_ms=gnn_case["library_ms"]))
    contrib_case = next(c for c in contrib["cases"] if c["case"] == "all")
    kernels.append(dict(
        name="pull_contrib", route="cuda",
        source="src/repro_torch/kernels/pull_contrib/csrc/pull_contrib.cu",
        replaces="none: the port's own kernel, the fixed-order f64 pull "
                 "sum of src/repro_torch/core/pagerank.py _contrib",
        launches=serve["kernel"]["launches"]["pull_contrib"]
        + extra["pull_contrib"],
        max_abs_err=contrib["max_abs_err"], ms=contrib_case["ms"],
        plain_ms=contrib_case["plain_ms"], bound_ms=contrib_case["bound_ms"],
        bound_by=contrib_case["bound_by"],
        library_ms=contrib_case["library_ms"]))
    def case(kernel, name):
        return next(c for c in counts["cases"]
                    if c["kernel"] == kernel and c["case"] == name)
    count_case = case("slot_count", "out_degree")
    kernels.append(dict(
        name="slot_count", route="cuda",
        source="src/repro_torch/kernels/slot_count/csrc/slot_count.cu",
        replaces="none: the port's own kernel, the int32 index_add_ "
                 "that counted the degrees and push_or of "
                 "src/repro_torch/graph/structure.py",
        launches=sum(r["launches"]["slot_count"] for r in paper["runs"])
        + extra["slot_count"],
        max_abs_err=0.0, ms=count_case["ms"],
        plain_ms=count_case["plain_ms"], bound_ms=count_case["bound_ms"],
        bound_by=count_case["bound_by"],
        library_ms=count_case["library_ms"]))
    for kname, label, replaces in (
            ("segment_bounds", "order",
             "none: the port's own kernel, slot_count's atomic count by dst "
             "(in_degree) of src/repro_torch/graph/structure.py"),
            ("segment_or", "~50 %",
             "none: the port's own kernel, slot_count's gathered atomic "
             "count by dst (push_or) of src/repro_torch/graph/structure.py")):
        c = case(kname, label)
        kernels.append(dict(
            name=kname, route="cuda",
            source="src/repro_torch/kernels/slot_count/csrc/slot_count.cu",
            replaces=replaces,
            launches=serve["kernel"]["launches"].get(kname, 0)
            + extra[kname],
            max_abs_err=0.0, ms=c["ms"], plain_ms=c["plain_ms"],
            bound_ms=c["bound_ms"], bound_by=c["bound_by"],
            library_ms=c["library_ms"]))
    row_case = gnn["row_sum"]["cases"][0]
    kernels.append(dict(
        name="pull_rows", route="cuda",
        source="src/repro_torch/kernels/pull_contrib/csrc/pull_contrib.cu",
        replaces="none: the port's own kernel, the f32 index_add_ of "
                 "src/repro_torch/models/gnn.py neighbor_sum, and the "
                 "train step's segment sums and gather backwards "
                 "(src/repro_torch/models/message.py), with the LM's "
                 "embedding backward and MoE combine and DeepFM's table "
                 "gradients",
        launches=gnn["row_launches"] + train["launches"] + lm["launches"]
        + recsys["launches"] + dry["launches"],
        max_abs_err=gnn["row_sum"]["max_abs_err"], ms=row_case["ms"],
        plain_ms=row_case["plain_ms"], bound_ms=row_case["bound_ms"],
        bound_by=row_case["bound_by"], library_ms=row_case["library_ms"]))
    for d, k in sorted(recsys["kernels"].items(), reverse=True):
        kernels.append(dict(
            name=f"pull_rows d={d}", route="cuda",
            source="src/repro_torch/kernels/pull_contrib/csrc/"
                   "pull_contrib.cu",
            replaces="none: the port's own kernel at DeepFM's table width "
                     f"d = {d}, the gather backward of "
                     "src/repro_torch/models/recsys.py (phase 14's launches; "
                     "also counted on the pull_rows line)",
            launches=k["launches"], max_abs_err=k["max_abs_err"],
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"]))
    wall = time.perf_counter() - t_start
    print(f"  wall {wall:.1f} s; card: {smi}")
    write_out(args, dict(device=name, nvidia_smi=smi, args=vars(args),
                         build={k: dict(seconds=v["seconds"], log=v["log"])
                                for k, v in builds.items()},
                         spmv=spmv_kernel, spmv_cases=cases,
                         contrib=contrib, counts=counts,
                         serve={k: v for k, v in serve.items()
                                if k != "final_ranks"},
                         ppr=ppr, gnn=gnn, paper=paper, obs=observ,
                         replicas=replicas, mesh=mesh, ppr_mesh=ppr_mesh,
                         train=train, lm=lm, recsys=recsys, dryrun=dry,
                         kernels=kernels, wall_s=wall))
    print(json.dumps({"kernels": kernels}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
