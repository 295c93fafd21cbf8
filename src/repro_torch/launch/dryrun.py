"""Dry-run: build and run every (arch × shape × mesh) cell on the ``meta``
device (twin of ``repro.launch.dryrun``).

The reference lowers each cell for a partitioned XLA program on 256 or
512 TPU devices and reads FLOPs, bytes and memory from the compiled
program.  The port has one controller and no partitioner, so a cell is
built (``lower_cell``: its abstract state, inputs and shardings, at the
full config) and run once on the ``meta`` device: nothing is allocated,
nothing drawn, and no device is touched.  This is by design, not a
fallback: no entry point that runs a model changes its device rule.  The
run goes under ``Counter``, one ``TorchDispatchMode`` that counts three
things at once (one mode, not three, for the time a meta op takes):

  * the products' FLOPs, by ``torch.utils.flop_counter``'s formulas (what
    ``FlopCounterMode`` counts), and matrix-vector and dot products,
    which those leave out;
  * each aten op's input and output bytes (views and allocations move
    none);
  * the bytes of live storages and their peak (what ``MemTracker`` of
    ``torch.distributed._tools`` tracks).

The port's hand-written kernels run their launch path on ``meta`` with no
launch (``kernels.work``): their scratch is allocated, so the tracked peak
holds it, and each adds its own adds and bytes, the ones ``chip_smoke.py``
prices its bounds with, to the counts.

Records keep the reference's schema (``dryrun_<mesh>.json``), so
``roofline.analysis.build_table`` reads them: ``status`` (OK, SKIP where
``cell.skip`` says, FAIL), ``memory`` (``argument_size_in_bytes``,
``temp_size_in_bytes``, ``peak_per_device_bytes``), ``cost`` (``flops``,
``bytes accessed``), for the LM family ``cost_counting`` and
``counting_method`` (the reference's L = 1 / L = 2 delta of the counting
mode, extrapolated to full depth), ``t_lower_s`` (building the cell) and
``t_compile_s`` (its meta run).  How the port's numbers differ from the
reference's:

  * **FLOPs** count products (``FlopCounterMode``) and the kernels' adds;
    XLA counts elementwise operations too.
  * **Bytes** are unfused, each op's inputs and outputs: an upper bound on
    XLA's fused count.
  * **Per device**, FLOPs, bytes and temporaries are the global program's
    divided by the mesh's devices: the ideal split GSPMD aims at.
    Arguments are exact: each leaf's bytes divided by the sizes of the
    axes its ``ShardSpec`` names (``dist/sharding.py``).
  * **Collectives**: there is no partitioned program to read them from, so
    ``collectives`` is null (``build_table`` prints n/a and never picks
    it as the dominant term).  ``collective_bytes`` ports as it is, the
    parser of optimised HLO text.
  * The pagerank cells run one sweep (``max_iter=1``), as XLA's cost
    analysis counts a while body once.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --arch all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi \\
      --arch gemma3-12b --shape train_4k --out results

``REPRO_DRYRUN_DEVICES=N`` (read when a mesh is built) shrinks the meshes
to N positions, as the reference's test hook does: (N/2, 2), and
(2, N/4, 2) for ``multi``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys
import time
import weakref
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.registry import all_cells
from repro_torch.dist import sharding as SH
from repro_torch.dist.constraints import use_mesh
from repro_torch.dist.pagerank_dist import (build_distributed_step,
                                            distributed_in_shardings,
                                            distributed_input_specs)
from repro_torch.kernels import work
from repro_torch.launch.mesh import data_axes, make_meta_mesh
from repro_torch.models import transformer as T
from repro_torch.models.tree import ParamTree, tree_leaves
from repro_torch.train import inputs as I
from repro_torch.train import steps as S

__all__ = ["Counter", "Lowered", "collective_bytes", "count",
           "depth_counts", "lower_cell", "make_mesh", "run_cell", "sweep",
           "worker_pool", "main"]

_OP_RE = re.compile(
    r"=\s+(\(?[a-z0-9\[\],{}\s]*?\)?)\s*"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(-start|-done)?\(")
_SHAPE_RE = re.compile(r"(bf16|f16|f32|f64|s32|u32|s8|u8|pred|s64|u64)"
                       r"\[([\d,]*)\]")
_BYTES = dict(bf16=2, f16=2, f32=4, f64=8, s32=4, u32=4, s8=1, u8=1,
              pred=1, s64=8, u64=8)


def collective_bytes(hlo_text: str) -> dict:
    """Sum result bytes of every collective op in optimised HLO text (the
    reference's parser, as it is).  Ops inside while/scan bodies are
    counted once."""
    out: dict = {k: 0 for k in ("all-gather", "all-reduce", "reduce-scatter",
                                "all-to-all", "collective-permute")}
    counts: dict = {k: 0 for k in out}
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m:
            continue
        if m.group(3) == "-done":      # start/done pairs: count starts only
            continue
        kind = m.group(2)
        nbytes = 0
        for dt, dims in _SHAPE_RE.findall(m.group(1)):
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            nbytes += n * _BYTES[dt]
        out[kind] += nbytes
        counts[kind] += 1
    out["total"] = sum(out.values())
    out["op_counts"] = counts
    return out


# ---------------------------------------------------------------------------
# the counters
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
# ops that move no bytes: allocations (a kernel's scratch, an output not
# yet written) and aliases
_NO_BYTES = {_aten.empty.memory_format, _aten.empty_strided.default,
             _aten.empty_like.default, _aten.new_empty.default,
             _aten.new_empty_strided.default, _aten.detach.default,
             _aten.alias.default, _aten.lift_fresh.default}


# products the flop_counter formulas leave out: a matrix-vector product
# (DeepFM's retrieval score) and a dot product
_MORE_FLOPS = {
    _aten.mv: lambda a, v, *_, **__: 2 * a.numel(),
    _aten.addmv: lambda c, a, v, *_, **__: 2 * a.numel(),
    _aten.dot: lambda a, b, *_, **__: 2 * a.numel(),
}


def _tensors(tree) -> list:
    """The ``meta`` tensors of a tree: the program's own (host scalars it
    reads, such as a layer's window, are no device work)."""
    leaves, _ = tree_flatten(tree)
    return [t for t in leaves if isinstance(t, torch.Tensor) and t.is_meta]


class Counter(TorchDispatchMode):
    """The dry-run's counters in one dispatch mode: the FLOPs of products
    by ``torch.utils.flop_counter``'s own formulas (``flop_registry``, as
    ``FlopCounterMode`` counts them), each aten op's input and output
    bytes (unfused; views and allocations move none) and, with
    ``memory``, the bytes of live storages and their peak (as
    ``MemTracker`` tracks them: each storage once, from its first tensor
    to its release); ``meta`` tensors only, ops on host tensors alone are
    no device work.  ``tracked`` are tensors made before the run (its
    arguments), live from the start."""

    def __init__(self, memory: bool = True, tracked=()):
        super().__init__()
        self.flops = self.bytes = 0
        self.memory = memory
        self.live = self.peak = 0
        self._storages = {}
        for t in tracked:
            self._track(t)

    def _release(self, key) -> None:
        self.live -= self._storages.pop(key)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        self._storages[key] = st.nbytes()
        self.live += st.nbytes()
        weakref.finalize(st, self._release, key)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        meta = _tensors((args, kwargs, out))
        if not meta:
            return out
        if packet in flop_registry:
            if func._overloadname == "dtype":   # mm / bmm with out_dtype
                args, kwargs = args[:2], {}
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        elif packet in _MORE_FLOPS:
            self.flops += _MORE_FLOPS[packet](*args, **kwargs)
        if not func.is_view and func not in _NO_BYTES:
            self.bytes += sum(t.numel() * t.element_size() for t in meta)
        if self.memory:
            for t in _tensors(out):
                self._track(t)
        return out


class Lowered(NamedTuple):
    """A built cell: ``fn(*args)`` is its step, ``specs`` the arguments'
    ``ShardSpec`` trees (None for a python value)."""

    fn: Callable
    args: tuple
    specs: tuple


def _leaves(tree) -> list:
    if isinstance(tree, ParamTree):
        tree = tree.tree
    return tree_leaves(tree)


def _spec_leaves(tree) -> list:
    """A spec tree's ``ShardSpec``s in flatten order (Nones dropped)."""
    if tree is None:
        return []
    if isinstance(tree, SH.ShardSpec):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    return [s for t in tree for s in _spec_leaves(t)]


def argument_bytes(lowered: Lowered) -> tuple:
    """(global, per device) bytes of the cell's tensor arguments, each
    leaf split as its spec says."""
    total = per_dev = 0
    for arg, spec in zip(lowered.args, lowered.specs):
        leaves = [t for t in _leaves(arg) if isinstance(t, torch.Tensor)]
        specs = _spec_leaves(spec)
        if len(leaves) != len(specs):
            raise ValueError(f"{len(specs)} specs for {len(leaves)} leaves")
        for t, s in zip(leaves, specs):
            total += t.numel() * t.element_size()
            per_dev += s.device_bytes(t)
    return total, per_dev


def count(lowered: Lowered, mesh, memory: bool = True) -> dict:
    """Run the built cell once on ``meta`` under the ``Counter``: global
    ``flops`` (products and the kernels' adds), ``bytes`` (unfused, with
    the kernels' own) and, with ``memory``, the ``peak`` of live storages
    (the arguments among them)."""
    tensors = [t for a in lowered.args for t in _leaves(a)
               if isinstance(t, torch.Tensor)]
    work.reset()
    counter = Counter(memory, tensors)
    with use_mesh(mesh), counter:
        lowered.fn(*lowered.args)
    return dict(flops=counter.flops + work.WORK["flops"],
                bytes=counter.bytes + work.WORK["bytes"],
                peak=counter.peak if memory else None,
                kernels={k: v for k, v in work.WORK.items()
                         if k not in ("flops", "bytes", "int_ops")})


# ---------------------------------------------------------------------------
# cell lowering
# ---------------------------------------------------------------------------

def _devices(mesh) -> int:
    return int(mesh.devices.size)


def lower_cell(spec, cell, mesh, counting: bool = False,
               n_layers: Optional[int] = None, all_global: bool = False,
               micro: Optional[int] = None) -> Lowered:
    """Build one (arch × shape) cell for ``mesh``: its abstract state and
    inputs on ``meta`` at the full config, and their shardings.

    ``counting`` (LM family): the counting mode (layers unchecked,
    attention in one chunk, the full-logit loss) and a single microbatch.
    ``n_layers`` overrides the depth, ``all_global`` drops a sliding
    window (every layer global) and ``micro`` runs that many of the
    production train step's microbatches (a batch of their rows):
    ``depth_counts`` extrapolates full counts from such cells.  The
    production variant (checkpointed layers, the arch's microbatches)
    proves memory.
    """
    family = spec.family
    if family == "pagerank":
        d = cell.dims
        fn = build_distributed_step(mesh, n_vertices=d["n_vertices"],
                                    max_iter=1)
        args = distributed_input_specs(mesh, d["n_vertices"],
                                       d["edge_capacity"])
        return Lowered(fn, args, distributed_in_shardings(mesh))

    cfg = I.effective_config(spec, cell, smoke=False)
    if counting and family == "lm":
        cfg = dataclasses.replace(cfg, counting=True)
    if n_layers is not None and family == "lm":
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if all_global and family == "lm":
        cfg = dataclasses.replace(cfg, window=None)
    spec = dataclasses.replace(spec, config=cfg)
    n_micro = 1 if counting else I.MICROBATCHES.get(spec.arch_id, 1)
    if micro is not None and family == "lm" and cell.kind == "train" \
            and not counting:
        rows = cell.dims["batch"] // n_micro
        cell = dataclasses.replace(cell, dims={**cell.dims,
                                               "batch": rows * micro})
        n_micro = micro
    batch = I.build_inputs(spec, cell, concrete=False, smoke=False)

    if family == "lm":
        if cell.kind == "train":
            params, opt = I.abstract_state(spec, cell)
            pspec, bspec, ospec = SH.family_shardings(
                "lm", mesh, params, batch, opt)
            fn = S.make_lm_train_step(
                cfg, n_microbatches=n_micro,
                factored=I.FACTORED_V.get(spec.arch_id, False),
                accum_dtype=I.ACCUM_DTYPE.get(spec.arch_id, torch.float32))
            return Lowered(fn, (params, opt, batch), (pspec, ospec, bspec))
        if cell.kind == "prefill":
            params, _ = I.abstract_state(spec, cell, with_opt=False)
            pspec, bspec, _ = SH.family_shardings("lm", mesh, params, batch)
            return Lowered(S.make_lm_prefill(cfg), (params, batch["tokens"]),
                           (pspec, bspec["tokens"]))
        # decode
        params, _ = I.abstract_state(spec, cell, with_opt=False)
        cache = I.abstract_cache(spec, cell)
        pspec, _, _ = SH.family_shardings(
            "lm", mesh, params, dict(tokens=batch["tokens"]))
        cspec = SH.lm_cache_specs(mesh, cache, cell.dims["batch"])
        dp = data_axes(mesh)
        split = dp and cell.dims["batch"] % SH._axis_size(mesh, dp) == 0
        tok_spec = SH.ShardSpec(
            mesh, ((dp[0] if len(dp) == 1 else dp) if split else None,
                   None))
        return Lowered(S.make_lm_decode_step(cfg),
                       (params, cache, batch["tokens"]),
                       (pspec, cspec, tok_spec))

    if family == "gnn":
        params, opt = I.abstract_state(spec, cell)
        pspec, bspec, ospec = SH.family_shardings(
            "gnn", mesh, params, batch, opt)
        fn = S.make_gnn_train_step(spec.arch_id, cfg)
        return Lowered(fn, (params, opt, batch), (pspec, ospec, bspec))

    # recsys
    if cell.kind == "recsys_train":
        params, opt = I.abstract_state(spec, cell)
        pspec, bspec, ospec = SH.family_shardings(
            "recsys", mesh, params, batch, opt)
        fn = S.make_recsys_train_step(cfg)
        return Lowered(fn, (params, opt, batch), (pspec, ospec, bspec))
    params, _ = I.abstract_state(spec, cell, with_opt=False)
    pspec, bspec, _ = SH.family_shardings("recsys", mesh, params, batch)
    fn = S.make_recsys_serve(cfg) if cell.kind == "recsys_serve" \
        else S.make_recsys_retrieval(cfg)
    return Lowered(fn, (params, batch), (pspec, bspec))


def _per_device(c: dict, ndev: int) -> dict:
    return {"flops": c["flops"] / ndev, "bytes accessed": c["bytes"] / ndev}


# a train step of more microbatches is counted from 2 and 3 of them
MICRO_RUN = 5


def _affine(a: dict, b: dict, steps: float) -> dict:
    """``a`` + ``steps`` · (``b`` − ``a``) of each count."""
    return {k: None if a[k] is None else a[k] + steps * (b[k] - a[k])
            for k in ("flops", "bytes", "peak")} | {"kernels": a["kernels"]}


def _micro_counts(spec, cell, mesh, counting: bool, **kw) -> dict:
    """Counts of an LM cell; a production train step of more than
    ``MICRO_RUN`` microbatches is counted from 2 and 3 of them: its
    microbatches are alike, so every count is affine in their number."""
    n = I.MICROBATCHES.get(spec.arch_id, 1)
    memory = not counting
    if counting or cell.kind != "train" or n <= MICRO_RUN:
        return count(lower_cell(spec, cell, mesh, counting, **kw), mesh,
                     memory)
    c2, c3 = (count(lower_cell(spec, cell, mesh, counting, micro=m, **kw),
                    mesh, memory) for m in (2, 3))
    return _affine(c2, c3, n - 2)


def depth_counts(spec, cell, mesh, counting: bool = False) -> tuple:
    """(counts, method): an LM cell's counts at full depth from cells of
    1 and 2 layers (and, for a config with a sliding window, 1 global
    layer), as the reference's L = 1 / L = 2 delta: the stack's layers
    are alike, so FLOPs, bytes and the tracked peak are affine in the
    number of each kind of layer.  A local layer skips the blocks past
    its window, so local and global layers are counted apart: ``base``
    (embedding, head, loss, optimizer) + n_local · local + n_global ·
    global.  The peak is the larger one-layer peak plus the per-layer
    increment for each further layer, from 1 and 2 layers or from 2 and
    3, whichever is larger: the peak of a phase of the step (the
    gradients', the optimizer update's) is affine in depth, but the
    phase that holds it may change between one layer and two."""
    cfg = spec.config
    L = cfg.n_layers
    c1, c2 = (_micro_counts(spec, cell, mesh, counting, n_layers=n)
              for n in (1, 2))
    keys = ("flops", "bytes")
    local = {k: c2[k] - c1[k] for k in keys}
    base = {k: c1[k] - local[k] for k in keys}
    n_local = int(T.layer_locality(cfg).sum())
    method = f"delta L=1/2 -> L={L}"
    cg = c1
    if cfg.window is not None:
        if int(T.layer_locality(dataclasses.replace(cfg, n_layers=2))
               .sum()) != 2:
            raise ValueError(f"{cfg.name}: layers 0 and 1 must both be "
                             "local to count the two kinds apart")
        cg = _micro_counts(spec, cell, mesh, counting, n_layers=1,
                           all_global=True)
        method += f" ({n_local} local, {L - n_local} global from a " \
                  "1-layer global cell)"
    if not counting and cell.kind == "train" \
            and I.MICROBATCHES.get(spec.arch_id, 1) > MICRO_RUN:
        method += f"; microbatches 2/3 -> " \
                  f"{I.MICROBATCHES[spec.arch_id]}"
    glob = {k: cg[k] - base[k] for k in keys} if cfg.window is not None \
        else local
    out = {k: base[k] + n_local * local[k] + (L - n_local) * glob[k]
           for k in keys}
    out["peak"] = None
    if not counting:
        # the peak is the larger of the gradients' phase and the optimizer
        # update's, each affine in depth; which holds it may change from
        # one layer to two, so from 3 layers on the peak is also
        # extrapolated from 2 and 3 and the larger taken
        lift = max(c1["peak"], cg["peak"]) - c1["peak"]
        out["peak"] = lift + c1["peak"] + (L - 1) * (c2["peak"]
                                                    - c1["peak"])
        if L >= 3:
            c3 = _micro_counts(spec, cell, mesh, counting, n_layers=3)
            out["peak"] = max(out["peak"], lift + c3["peak"] + (L - 3)
                              * (c3["peak"] - c2["peak"]))
            method += "; peak also from L=2/3"
    out["kernels"] = c1["kernels"]
    return out, method


def run_cell(spec, cell, mesh, mesh_name: str, verbose=True) -> dict:
    """One record of the reference's schema for the cell on ``mesh``."""
    rec = dict(arch=spec.arch_id, shape=cell.name, mesh=mesh_name,
               family=spec.family, kind=cell.kind)
    if cell.skip:
        rec["status"] = "SKIP"
        rec["skip_reason"] = cell.skip
        return rec
    ndev = _devices(mesh)
    t0 = time.time()
    try:
        lowered = lower_cell(spec, cell, mesh)
        t_lower = time.time() - t0
        if spec.family == "lm":
            c, method = depth_counts(spec, cell, mesh)
            rec["production_method"] = method
        else:
            c = count(lowered, mesh)
        t_compile = time.time() - t0 - t_lower
        arg_global, arg_dev = argument_bytes(lowered)
        temp = max(0, c["peak"] - arg_global) / ndev
        rec["memory"] = dict(argument_size_in_bytes=int(arg_dev),
                             temp_size_in_bytes=int(temp),
                             peak_per_device_bytes=int(arg_dev + temp))
        rec["cost"] = _per_device(c, ndev)
        rec["collectives"] = None
        rec["kernel_calls"] = c["kernels"]
        if spec.family == "lm":
            t1 = time.time()
            cc, method = depth_counts(spec, cell, mesh, counting=True)
            rec["cost_counting"] = _per_device(cc, ndev)
            rec["collectives_counting"] = None
            rec["counting_method"] = method
            rec["t_counting_s"] = round(time.time() - t1, 1)
        rec["status"] = "OK"
        rec["t_lower_s"] = round(t_lower, 1)
        rec["t_compile_s"] = round(t_compile, 1)
        if verbose:
            mem = rec["memory"]["peak_per_device_bytes"]
            print(f"  OK {spec.arch_id}/{cell.name}: "
                  f"peak/dev={mem / 2**30:.2f}GiB "
                  f"flops={rec['cost']['flops']:.3g} coll=n/a "
                  f"(build {t_lower:.1f}s run {t_compile:.1f}s)", flush=True)
    except Exception as e:  # noqa: BLE001 — report, don't abort the sweep
        rec["status"] = "FAIL"
        rec["error"] = repr(e)[:500]
        if verbose:
            print(f"  FAIL {spec.arch_id}/{cell.name}: {repr(e)[:200]}",
                  flush=True)
    return rec


def make_mesh(multi_pod: bool):
    """The dry-run's mesh of ``meta`` positions: the production (16, 16)
    or (2, 16, 16), or with ``REPRO_DRYRUN_DEVICES=N`` a small one,
    (N/2, 2) or (2, N/4, 2)."""
    small = os.environ.get("REPRO_DRYRUN_DEVICES")
    if not small:
        return make_meta_mesh((2, 16, 16) if multi_pod else (16, 16))
    n = int(small)
    if multi_pod:
        return make_meta_mesh((2, n // 4, 2))
    return make_meta_mesh((n // 2, 2))


def _cell_job(arch_id: str, shape: str, mesh_name: str) -> dict:
    """``run_cell`` in a worker process (its own mesh), printing its line
    there."""
    from repro_torch.configs.registry import get_arch
    torch.set_num_threads(1)
    spec = get_arch(arch_id)
    return run_cell(spec, spec.shapes[shape],
                    make_mesh(mesh_name == "multi"), mesh_name)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--include-pagerank", action="store_true")
    ap.add_argument("--out", default="results")
    args = ap.parse_args(argv)

    cells = [(spec, cell) for spec, cell in
             all_cells(include_pagerank=args.include_pagerank)
             if args.arch in ("all", spec.arch_id)
             and args.shape in ("all", cell.name)]
    # each cell runs on meta alone, so several run in worker processes
    jobs = min(MAX_JOBS, os.cpu_count() or 1, len(cells))
    pool = worker_pool(jobs) if jobs > 1 else None
    try:
        for mesh_name in ([args.mesh] if args.mesh != "both"
                          else ["single", "multi"]):
            sweep(cells, mesh_name, args.out, pool)
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)
    return 0


MAX_JOBS = 8                     # worker processes of a sweep at most


def worker_pool(jobs: int):
    """A pool of ``jobs`` worker processes for ``sweep`` (spawned: each
    imports the package afresh)."""
    import concurrent.futures
    import multiprocessing
    return concurrent.futures.ProcessPoolExecutor(
        jobs, mp_context=multiprocessing.get_context("spawn"))


def sweep(cells, mesh_name: str, out: str, pool=None) -> list:
    """The records of ``cells`` ((spec, cell) pairs) on one mesh, in
    their order, written to ``out/dryrun_<mesh>.json`` as each ends;
    cells already recorded OK or SKIP there are kept.  The cells run in
    ``pool`` (``worker_pool``) if given, else here, one after another."""
    os.makedirs(out, exist_ok=True)
    mesh = make_mesh(mesh_name == "multi")
    print(f"=== mesh {mesh_name}: {mesh.shape} ({_devices(mesh)} meta "
          f"positions) ===", flush=True)
    path = os.path.join(out, f"dryrun_{mesh_name}.json")
    done: dict[Any, dict] = {}
    if os.path.exists(path):
        with open(path) as f:
            for r in json.load(f):
                if r.get("status") in ("OK", "SKIP"):
                    done[(r["arch"], r["shape"])] = r
    results: dict[Any, Any] = {}
    for spec, cell in cells:
        key = (spec.arch_id, cell.name)
        if key in done:
            results[key] = done[key]
            print(f"  cached {spec.arch_id}/{cell.name}", flush=True)
        elif pool is not None and not cell.skip:
            results[key] = pool.submit(_cell_job, *key, mesh_name)
    records = []
    for spec, cell in cells:
        r = results.get((spec.arch_id, cell.name))
        if r is None:
            r = run_cell(spec, cell, mesh, mesh_name)
        elif not isinstance(r, dict):
            r = r.result()
        records.append(r)
        with open(path, "w") as f:
            json.dump(records, f, indent=1)
    ok = sum(r["status"] == "OK" for r in records)
    sk = sum(r["status"] == "SKIP" for r in records)
    fail = [r for r in records if r["status"] == "FAIL"]
    print(f"mesh {mesh_name}: {ok} OK, {sk} SKIP, {len(fail)} FAIL")
    for r in fail:
        print(f"  FAILED {r['arch']}/{r['shape']}: {r['error'][:120]}")
    return records


if __name__ == "__main__":
    sys.exit(main())
