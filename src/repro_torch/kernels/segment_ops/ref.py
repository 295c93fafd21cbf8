"""Plain PyTorch version of the gated blocked segment-SpMM (the twin of
``repro.kernels.segment_ops.ref``): GNN feature aggregation on the packed
structure of ``kernels.pagerank_spmv``.

    out[v, :] = Σ_{valid e: dst(e)=v} feats[src(e), :]   if window(v) active
    out[v, :] = 0                                          otherwise

It states the CUDA kernel's arithmetic: ``feats`` widened to f32, each
lane's row scaled by its gate (``valid`` times its window's activity) and
summed in f32.  On a CPU tensor the kernel's wrapper runs this function;
on the card ``chip_smoke.py`` holds the kernel against it.

The lanes are taken ``LANE_CHUNK`` at a time (whole entries), so the
gathered rows stay a bounded buffer at full feature width: at once they
would be NE·BE·D floats, 128 GB on the smoke's 53 M lanes at D = 602.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.segment_ops.plan import chunk_plan

# lanes gathered at once: 5 GB of f32 rows at D = 602, under 2**31 elements
LANE_CHUNK = 1 << 21


def gated_spmm_ref(src, dst_rel, valid, window, feats, active_window,
                   num_vertices: int, vb: int) -> torch.Tensor:
    """src/dst_rel: int32[NE, BE]; valid: f32[NE, BE]; window: int32[NE];
    feats: [>= num_vertices, D]; active_window: bool[NW].
    Returns f32[num_vertices, D] (rows of inactive windows zero)."""
    ne, be = src.shape
    nw = active_window.shape[0]
    feats = feats.to(torch.float32)
    out = torch.zeros(nw * vb, feats.shape[1], dtype=torch.float32,
                      device=feats.device)
    gate = valid * active_window[window.long()][:, None].to(torch.float32)
    step = max(1, LANE_CHUNK // max(be, 1))        # entries per chunk
    for e0 in range(0, ne, step):
        rows = slice(e0, e0 + step)
        x = feats[src[rows].reshape(-1).long()]
        x.mul_(gate[rows].reshape(-1, 1))
        flat_dst = window[rows, None].long() * vb + dst_rel[rows].long()
        out.index_add_(0, flat_dst.reshape(-1), x)
    return out[:num_vertices]


def gated_spmm_split_ref(src, dst_rel, valid, window, entry_start, feats,
                         active_window, num_vertices: int, vb: int,
                         k: int) -> torch.Tensor:
    """``gated_spmm_ref`` split as the CUDA kernel splits it: windows cut
    into chunks of at most ``k`` entries (``plan.chunk_plan``), chunk 0 of
    a window summed into its rows and chunk j >= 1 into a partial tile,
    then each split window's partials added to its rows in chunk order.
    Live lanes (valid != 0) only, as the kernel takes them.  Within a
    chunk it adds lane by lane, where the kernel sums a run of one row
    first and adds the run to the row, so the two agree at tolerance, not
    bit for bit."""
    ne, be = src.shape
    nw = active_window.shape[0]
    d = feats.shape[1]
    feats = feats.to(torch.float32)
    plan = chunk_plan(entry_start, ne, k)
    real = plan.window < nw
    # every entry's chunk: the real chunks cover the entries in order
    counts = (plan.end - plan.begin).long()[real]
    part = torch.repeat_interleave(plan.part.long()[real], counts)
    # rows of out, then the partial tiles, in one buffer
    buf = torch.zeros((nw + plan.num_partials) * vb, d, dtype=torch.float32,
                      device=feats.device)
    base = torch.where(part < 0, window.long(), nw + part) * vb
    live = (valid != 0) & active_window[window.long()][:, None]
    rows = (base[:, None] + dst_rel.long())[live]
    x = feats[src.long()[live]] * valid[live][:, None]
    buf.index_add_(0, rows, x)
    out, partial = buf[:nw * vb], buf[nw * vb:].reshape(-1, vb, d)
    for s in range(plan.split_window.shape[0]):
        w = int(plan.split_window[s])
        if w >= nw or not bool(active_window[w]):
            continue
        p0 = int(plan.split_part[s])
        tile = out[w * vb:(w + 1) * vb]
        for j in range(int(plan.split_count[s])):
            tile += partial[p0 + j]
    return out[:num_vertices]
