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
