"""Plain PyTorch version of the frontier-gated blocked SpMV (the twin of
``repro.kernels.pagerank_spmv.ref``).

Given edges packed into (window, entry) blocks (``pack_blocks``), a scaled
rank vector ``rsc[u] = R[u]/d_u`` and an ``active_window`` mask:

    out[v] = Σ_{valid e: dst(e)=v}  rsc[src(e)]      if window(v) active
    out[v] = 0                                        otherwise

It states the CUDA kernel's arithmetic: ``rsc`` (f32 or bf16) is widened
to f32 and summed in f32.  On a CPU tensor the kernel's wrapper runs this
function; on the card ``chip_smoke.py`` holds the kernel against it.
"""
from __future__ import annotations

import torch


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

