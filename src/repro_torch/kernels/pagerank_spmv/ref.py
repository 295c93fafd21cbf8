"""Plain PyTorch version of the frontier-gated blocked SpMV (the twin of
``repro.kernels.pagerank_spmv.ref``).

Given edges packed into (window, entry) blocks (``pack_blocks``), a scaled
rank vector ``rsc[u] = R[u]/d_u`` and an ``active_window`` mask:

    out[v] = Σ_{valid e: dst(e)=v}  rsc[src(e)]      if window(v) active
    out[v] = 0                                        otherwise

It states the CUDA kernel's arithmetic: ``rsc`` (f32 or bf16) is widened
to f32 and summed in f32.  On a CPU tensor the kernel's wrapper runs this
function; on the card ``chip_smoke.py`` holds the kernel against it.
``frontier_spmv_split_ref`` sums in the kernel's chunk and partial order.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.segment_ops.plan import chunk_plan


def frontier_spmv_ref_padded(src, dst_rel, valid, window, rsc,
                             active_window, vb: int) -> torch.Tensor:
    """src/dst_rel: int32[NE, BE]; valid: f32[NE, BE]; window: int32[NE];
    rsc: f32/bf16[>= NW*VB]; active_window: bool[NW].
    Returns f32[NW*VB] (inactive windows zero)."""
    ne, be = src.shape
    nw = active_window.shape[0]
    rsc = rsc.to(torch.float32)
    w = rsc[src.reshape(-1).long()].reshape(ne, be) * valid
    entry_active = active_window[window.long()]
    w = w * entry_active[:, None].to(torch.float32)
    flat_dst = window[:, None].long() * vb + dst_rel.long()
    out = torch.zeros(nw * vb, dtype=torch.float32, device=rsc.device)
    return out.index_add_(0, flat_dst.reshape(-1), w.reshape(-1))


def frontier_spmv_split_ref(packed, rsc, active_window,
                            k: int) -> torch.Tensor:
    """``frontier_spmv_ref_padded`` split as the CUDA kernel splits it:
    windows cut into chunks of at most ``k`` entries
    (``segment_ops.plan.chunk_plan``), chunk 0 of a window summed into its
    rows and chunk j >= 1 into a partial row, then each active split
    window's partials added to its rows in chunk order.  Live lanes
    (valid != 0) only, as the kernel takes them.  Within a chunk it adds
    lane by lane, where the kernel adds runs of one row summed by a scan
    of 32 lanes, warp by warp: the two agree at tolerance, not bit for
    bit.  packed: a ``PackedGraph``; rsc: f32/bf16[>= NW*VB];
    active_window: bool[NW].  Returns f32[NW*VB]."""
    src, dst_rel, valid, window = (packed.src, packed.dst_rel, packed.valid,
                                   packed.window)
    ne = src.shape[0]
    nw, vb = active_window.shape[0], packed.vb
    rsc = rsc.to(torch.float32)
    plan = chunk_plan(packed.entry_start, ne, k)
    real = plan.window < nw
    # every entry's chunk: the real chunks cover the entries in order
    counts = (plan.end - plan.begin).long()[real]
    part = torch.repeat_interleave(plan.part.long()[real], counts)
    # rows of out, then the partial rows, in one buffer
    buf = torch.zeros((nw + plan.num_partials) * vb, dtype=torch.float32,
                      device=rsc.device)
    base = torch.where(part < 0, window.long(), nw + part) * vb
    live = (valid != 0) & active_window[window.long()][:, None]
    rows = (base[:, None] + dst_rel.long())[live]
    buf.index_add_(0, rows, rsc[src.long()[live]] * valid[live])
    out, partial = buf[:nw * vb].view(nw, vb), buf[nw * vb:].view(-1, vb)
    # the second pass, chunk by chunk over every active split window
    split = plan.split_window < nw
    sw = plan.split_window.long()[split]
    keep = active_window[sw]
    sw = sw[keep]
    p0 = plan.split_part.long()[split][keep]
    count = plan.split_count.long()[split][keep]
    for j in range(int(count.max()) if count.numel() else 0):
        more = count > j
        out[sw[more]] += partial[p0[more] + j]
    return out.reshape(-1)
