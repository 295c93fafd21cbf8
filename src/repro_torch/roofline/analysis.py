"""Roofline: 3 terms per (arch × shape × mesh) from the dry-run artifacts
(twin of ``repro.roofline.analysis``), at the rates of one NVIDIA H100.

    compute    = FLOPs_per_device / peak_FLOPs            [s]
    memory     = bytes_per_device / HBM_bw                [s]
    collective = collective_bytes_per_device / link_bw    [s]

``build_table`` reads dry-run records in the reference's schema
(``dryrun_<mesh>.json``: ``cost`` / ``cost_counting`` with ``flops`` and
``bytes accessed``, ``collectives``, ``memory.peak_per_device_bytes``);
the terms are per device, so no ÷chips is applied to them.  The port's
own dry-run (``launch/dryrun.py``) records ``collectives`` as null: its
collective term is then n/a and never the dominant one.  The dominant
term is the bottleneck.  MODEL_FLOPS is the analytic useful-work count
(6·N·D dense LMs, 6·N_active·D MoE, per-family formulas below), the
reference's own arithmetic; MODEL/HLO per device catches
remat/redundancy/dispatch waste.

The port adds an analytic bytes count for the recsys family
(``recsys_model_bytes``) and ``analytic_bound``, the larger of its FLOP
and bytes terms on the card, which ``chip_smoke.py`` prints beside each
DeepFM cell.

The rates are the H100's (NVIDIA's data sheet, SXM part, dense rates, at
the card's full 700 W limit; ``nvidia-smi`` prints the card as
``NVIDIA H100 80GB HBM3, 700.00 W``): a card set below 700 W runs slower
under load than these bounds assume.
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Optional

# NVIDIA H100 80GB HBM3, 700.00 W (one card)
H100_PEAK_FLOPS_BF16 = 989e12     # dense bf16 tensor cores
H100_PEAK_FLOPS_F32 = 67e12       # f32 outside the tensor cores
H100_HBM_BW = 3.35e12             # B/s
H100_NVLINK_BW = 450e9            # B/s each way, to the other cards

PEAK_FLOPS = H100_PEAK_FLOPS_BF16
HBM_BW = H100_HBM_BW
LINK_BW = H100_NVLINK_BW
# devices of the dry-run's two meshes (the records' ``mesh``): the
# reference's production meshes, which divide its model FLOPs per device
CHIPS = dict(single=256, multi=512)


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: Optional[float]     # None: the record has no collectives
    dominant: str
    model_flops: float
    hlo_flops: float
    useful_ratio: float
    peak_gib: float
    status: str
    note: str = ""

    @property
    def bound_time(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s or 0.0)

    @property
    def roofline_fraction(self) -> float:
        """compute_s / max-term: 1.0 = compute-bound at peak."""
        t = self.bound_time
        return self.compute_s / t if t > 0 else 0.0


# ---------------------------------------------------------------------------
# analytic MODEL_FLOPS (useful work) per family
# ---------------------------------------------------------------------------

def lm_model_flops(spec, cell) -> float:
    cfg = spec.config
    d = cell.dims
    n_active = cfg.active_param_count()
    if cell.kind == "train":
        tokens = d["batch"] * d["seq"]
        return 6.0 * n_active * tokens
    if cell.kind == "prefill":
        tokens = d["batch"] * d["seq"]
        return 2.0 * n_active * tokens
    # decode: one token per sequence + attention over the cache
    tokens = d["batch"]
    attn = (2.0 * cfg.n_layers * d["batch"] * d["ctx"]
            * cfg.n_heads * cfg.hd * 2)
    return 2.0 * n_active * tokens + attn


def gnn_model_flops(spec, cell) -> float:
    cfg = spec.config
    d = cell.dims
    if cell.kind == "gnn_minibatch":
        n = d["batch_nodes"] * (1 + d["fanout0"]
                                + d["fanout0"] * d["fanout1"])
        e = d["batch_nodes"] * d["fanout0"] * (1 + d["fanout1"])
    elif cell.kind == "gnn_molecule":
        n = d["n_nodes"] * d["batch"]
        e = d["n_edges"] * d["batch"]
    else:
        n, e = d["n_nodes"], d["n_edges"]
    a = spec.arch_id
    if a == "graphsage-reddit":
        din = d.get("d_feat", cfg.d_in)
        f = 2.0 * n * din * cfg.d_hidden * 2 + 2.0 * e * din
    elif a == "pna":
        f = cfg.n_layers * (2.0 * e * 2 * cfg.d_hidden * cfg.d_hidden
                            + 13 * 2.0 * n * cfg.d_hidden * cfg.d_hidden)
    elif a == "nequip":
        c = cfg.channels
        f = cfg.n_layers * e * (2.0 * cfg.n_rbf * 32 + 2.0 * 32 * 6 * c
                                + 30.0 * c)
    else:  # graphcast
        dh = cfg.d_hidden
        f = (2.0 * n * cfg.n_vars * dh
             + cfg.n_layers * (2.0 * e * 2 * dh * dh
                               + 2.0 * n // 4 * 2 * dh * dh)
             + 2.0 * n * 2 * dh * cfg.n_vars)
    return 3.0 * f if cell.kind != "serve" else f   # fwd+bwd ≈ 3× fwd


def recsys_model_flops(spec, cell) -> float:
    cfg = spec.config
    d = cell.dims
    if cell.kind == "recsys_retrieval":
        return 2.0 * d["n_candidates"] * cfg.embed_dim
    b = d["batch"]
    d_in = cfg.n_sparse * cfg.embed_dim
    dims = (d_in,) + cfg.mlp_dims + (1,)
    mlp = sum(2.0 * a * bb for a, bb in zip(dims[:-1], dims[1:]))
    fm = 4.0 * cfg.n_sparse * cfg.embed_dim
    per = mlp + fm
    return b * per * (3.0 if cell.kind == "recsys_train" else 1.0)


def pagerank_model_flops(spec, cell) -> float:
    d = cell.dims
    # per iteration: one multiply-add per edge + ~5 flops per vertex
    return 2.0 * d["edge_capacity"] + 5.0 * d["n_vertices"]


def model_flops(spec, cell) -> float:
    return dict(lm=lm_model_flops, gnn=gnn_model_flops,
                recsys=recsys_model_flops,
                pagerank=pagerank_model_flops)[spec.family](spec, cell)


# ---------------------------------------------------------------------------
# analytic bytes and bound on one card (the port's)
# ---------------------------------------------------------------------------

def recsys_model_bytes(spec, cell) -> float:
    """Bytes a DeepFM cell must move in f32, each counted once: the ids,
    the table rows they gather (``embed_dim`` + 1 floats an id), the MLP's
    weights and the output; a train step adds the dense AdamW update of
    every parameter (p, g, m, v read, p, m, v written: the reference's
    step materialises the dense gradient).  Retrieval reads the query's
    rows and one row a candidate."""
    cfg = spec.config
    d = cell.dims
    if cell.kind == "recsys_retrieval":
        nc = d["n_candidates"]
        return 4.0 * (cfg.n_sparse * (1 + cfg.embed_dim)
                      + nc * (2 + cfg.embed_dim))
    b = d["batch"]
    n = cfg.param_count() + 1          # and the scalar bias it leaves out
    mlp = n - cfg.total_rows * (cfg.embed_dim + 1)
    per = cfg.n_sparse * (2 + cfg.embed_dim) + 1        # ids, rows, out
    if cell.kind == "recsys_train":
        return 4.0 * (b * (per + 1) + 7 * n)            # + labels
    return 4.0 * (b * per + mlp)


def analytic_bound(flops: float, nbytes: float,
                   peak_flops: float = H100_PEAK_FLOPS_F32,
                   hbm_bw: float = HBM_BW) -> dict:
    """The least time one card takes for ``flops`` operations and
    ``nbytes`` bytes: the larger of the two terms, and which it is."""
    compute_s, memory_s = flops / peak_flops, nbytes / hbm_bw
    return dict(compute_s=compute_s, memory_s=memory_s,
                bound_s=max(compute_s, memory_s),
                bound_by="operations" if compute_s > memory_s else "bytes")


# ---------------------------------------------------------------------------
# SpMV iteration costs (the dense loop; the gated kernel)
# ---------------------------------------------------------------------------

# random-access HBM traffic moves whole sectors regardless of element
# width: a gather/scatter of one f64 still transfers a 32B sector.  The
# dense engine pays this on every edge (gather r/d by src, scatter-add by
# dst); the packed kernel streams contiguous lanes at element width.
GATHER_SECTOR_BYTES = 32


def dense_spmv_iteration_cost(*, num_edges: int, num_vertices: int,
                              index_bytes: float = 8.0,
                              value_bytes: float = 8.0,
                              hbm_bw: float = HBM_BW) -> dict:
    """Roofline terms for ONE dense segment-sum PageRank iteration (the
    f64 engine's step): per edge, a random gather of the source
    contribution (one sector), the scatter-add's read+write (two
    sectors) and the sequential src/dst index stream; per vertex, ~6
    streamed f64 vectors (old/new ranks, inverse degree, frontier/prune
    masks, delta).  All traffic is charged at streaming bandwidth —
    sector inflation already accounts for the random-access penalty."""
    edge_bytes = num_edges * (3.0 * GATHER_SECTOR_BYTES + index_bytes)
    vertex_bytes = num_vertices * value_bytes * 6.0
    memory_s = (edge_bytes + vertex_bytes) / hbm_bw
    return dict(memory_s=memory_s, edge_bytes=edge_bytes,
                vertex_bytes=vertex_bytes, total_s=memory_s)


def gated_spmv_iteration_cost(*, total_entries: int, active_entries: float,
                              active_windows: float, be: int, vb: int,
                              v_rsc: int,
                              peak_flops: float = H100_PEAK_FLOPS_F32,
                              hbm_bw: float = HBM_BW) -> dict:
    """Roofline terms for ONE gated-SpMV iteration at a given geometry.

    The memory term is the reference's: only active entries are read
    (src, dst_rel, valid a lane), with the active output windows and the
    rsc vector, at the card's rate.  The compute term is not: the
    reference charges every entry of its static TPU grid a one-hot MXU
    step, which the Hopper kernel (``csrc/frontier_spmv.cu``) does not
    have.  It is priced as ``kernels/pagerank_spmv/tune.py``'s model of
    that kernel prices a call, from these totals in place of the pack's
    per-window entries: the device's floor for a call with active
    windows, an rsc gather a lane of an active entry, the rounds of
    chunks (at most ``CHUNK_ENTRIES`` entries a chunk, ``resident_blocks``
    a SM over the plan's slots) each as long as the longest active chunk
    (the active entries spread evenly over the active windows), and the
    partial rows of split windows; or, if larger, one f32 add a lane at
    ``peak_flops``.  ``total_s = max(compute_s, memory_s)``.
    """
    from repro_torch.kernels.pagerank_spmv import tune as T
    lane_bytes = active_entries * be * (4 + 4 + 4)      # src, dst_rel, valid
    out_bytes = active_windows * vb * 4.0
    rsc_bytes = float(v_rsc) * 4.0
    memory_s = (lane_bytes + out_bytes + rsc_bytes) / hbm_bw
    lanes = active_entries * be
    compute_s = lanes / peak_flops
    if active_windows > 0 and active_entries > 0:
        k = T.CHUNK_ENTRIES
        chunks = max(active_windows, math.ceil(active_entries / k))
        grid = min(active_windows + total_entries // k,
                   T.resident_blocks(vb) * T.SMS)
        longest = min(k, math.ceil(active_entries / active_windows)) * be
        tiles = math.ceil(longest / (T.BLOCK_WARPS * T.TILE_LANES))
        rounds = math.ceil(chunks / max(1, grid))
        device_s = (T.DEVICE_CALL_S + lanes * T.GATHER_S
                    + rounds * tiles * T.TILE_S
                    + (chunks - active_windows) * vb * T.PARTIAL_S)
        compute_s = max(compute_s, device_s)
    return dict(compute_s=compute_s, memory_s=memory_s,
                total_s=max(compute_s, memory_s))


# ---------------------------------------------------------------------------
# table builder
# ---------------------------------------------------------------------------

def _whatif(spec, rec) -> str:
    """One sentence: what would move the dominant term down."""
    hints = {
        ("lm", "compute"): "raise tensor-core utilisation: bf16 products "
                           "with fused attention, larger per-device "
                           "microbatch",
        ("lm", "memory"): "bf16 end-to-end + fused attention kernel to cut "
                          "HBM traffic; re-check remat policy",
        ("lm", "collective"): "sequence-parallel reduce-scatter instead of "
                              "TP all-reduce; overlap with compute via "
                              "async collectives",
        ("gnn", "memory"): "frontier-gated SpMM kernel (kernels/segment_ops)"
                           " + cache blocking of node features",
        ("gnn", "collective"): "partition by dst-range (2D) to turn gather "
                               "all-reduces into model-axis all-gathers",
        ("gnn", "compute"): "segment-matmul on the tensor cores instead of "
                            "scalar segment-sum",
        ("recsys", "memory"): "row-sharded embedding gather is HBM-bound: "
                              "pack multi-field lookups into one gather",
        ("recsys", "collective"): "shard batch over all axes; keep tables "
                                  "model-sharded to avoid replication",
        ("recsys", "compute"): "batch small MLP GEMMs",
        ("pagerank", "collective"): "all-gather only ACTIVE dst-window "
                                    "slices of R (frontier-compressed "
                                    "gather)",
        ("pagerank", "memory"): "block-gated SpMV skips inactive windows "
                                "(kernels/pagerank_spmv)",
        ("pagerank", "compute"): "closed-form DF-P update trims iterations",
    }
    return hints.get((spec.family, rec), "")


def build_table(results_dir: str = "results") -> list[RooflineRow]:
    from repro_torch.configs.registry import REGISTRY
    rows = []
    for mesh_name in ("single", "multi"):
        path = os.path.join(results_dir, f"dryrun_{mesh_name}.json")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            records = json.load(f)
        for r in records:
            spec = REGISTRY[r["arch"]]
            cell = spec.shapes[r["shape"]]
            if r["status"] != "OK":
                rows.append(RooflineRow(
                    r["arch"], r["shape"], mesh_name, 0, 0, 0, "-", 0, 0, 0,
                    0, r["status"], r.get("skip_reason",
                                          r.get("error", ""))[:90]))
                continue
            cost = r.get("cost_counting") or r.get("cost", {})
            coll = r.get("collectives_counting") or r.get("collectives")
            flops = float(cost.get("flops", 0.0))
            byts = float(cost.get("bytes accessed", 0.0))
            comp = flops / PEAK_FLOPS
            mem = byts / HBM_BW
            # the port's dry-run records no collectives (null): n/a, and
            # never the dominant term
            col = None if coll is None else \
                float(coll.get("total", 0.0)) / LINK_BW
            terms = [(comp, "compute"), (mem, "memory")]
            if col is not None:
                terms.append((col, "collective"))
            dom = max(terms)[1]
            mf = model_flops(spec, cell) / CHIPS[mesh_name]
            rows.append(RooflineRow(
                r["arch"], r["shape"], mesh_name, comp, mem, col, dom, mf,
                flops, (mf / flops if flops else 0.0),
                r.get("memory", {}).get("peak_per_device_bytes", 0) / 2**30,
                "OK", _whatif(spec, dom)))
    return rows


def to_markdown(rows: list[RooflineRow]) -> str:
    hdr = ("| arch | shape | mesh | compute s | memory s | collective s | "
           "dominant | MODEL/HLO | peak GiB | note |\n"
           "|---|---|---|---|---|---|---|---|---|---|")
    lines = [hdr]
    for r in rows:
        if r.status != "OK":
            lines.append(f"| {r.arch} | {r.shape} | {r.mesh} | - | - | - | "
                         f"{r.status} | - | - | {r.note} |")
            continue
        col = "n/a" if r.collective_s is None else f"{r.collective_s:.3e}"
        lines.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {r.compute_s:.3e} | "
            f"{r.memory_s:.3e} | {col} | **{r.dominant}** | "
            f"{r.useful_ratio:.2f} | {r.peak_gib:.2f} | {r.note} |")
    return "\n".join(lines)


if __name__ == "__main__":
    print(to_markdown(build_table()))
