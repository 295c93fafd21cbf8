"""Low-precision collectives over one controller's shards (twin of
``repro.dist.collectives``).

A collective here takes the list of per-shard tensors (shard order) and
returns the reduced tensor on the first shard's device; every shard
reads that one result, as every participant of an all-reduce does.
Reductions add in shard order, so results are the same bit for bit from
run to run.

``int8_psum`` is the reference's wire compression: per-row symmetric int8
quantization with the scale shared across the shards (the max of their
absmax), an int16 sum (up to ``MAX_WIRE_SHARDS`` = 256 shards of ±127
fit: 256·127 = 32,512 < 32,767), then dequantization.  The only error is
each shard's rounding, at most ``n_shards · max|x| / 127 / 2``.  On
{0, 1} flags the scale is 1/127 and the sum is exact, so
``bool_or_psum`` is a lossless OR.
"""
from __future__ import annotations

from typing import Sequence

import torch

MAX_WIRE_SHARDS = 256

__all__ = ["MAX_WIRE_SHARDS", "int8_psum", "bool_or_psum", "psum", "pmax"]


def _on(xs: Sequence[torch.Tensor], dev: torch.device) -> list:
    return [x.to(dev, non_blocking=True) for x in xs]


def psum(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Σ_s xs[s], added in shard order on the first shard's device."""
    xs = _on(xs, xs[0].device)
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def pmax(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The elementwise max over the shards, on the first shard's device."""
    xs = _on(xs, xs[0].device)
    out = xs[0]
    for x in xs[1:]:
        out = torch.maximum(out, x)
    return out


def int8_psum(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """psum over an int8-quantized wire with an int16 sum.

    Rows are the leading dims and the quantization group the last dim
    (the whole shard when 1-D); the scale of a row is shared across the
    shards (one extra max of the absmax), so the integer sum dequantizes
    consistently.  At most ``MAX_WIRE_SHARDS`` shards.
    """
    n = len(xs)
    if n > MAX_WIRE_SHARDS:
        raise ValueError(
            f"int8_psum over {n} shards would overflow the int16 wire "
            f"(max {MAX_WIRE_SHARDS}); reduce hierarchically")
    dtype = xs[0].dtype
    xf = [x.to(torch.float32) for x in _on(xs, xs[0].device)]
    if xf[0].dim() >= 2:
        amax = [x.abs().amax(dim=-1, keepdim=True) for x in xf]
    else:
        amax = [x.abs().amax() for x in xf]
    scale = torch.clamp(pmax(amax), min=1e-30) / 127.0
    q = [torch.clamp(torch.round(x / scale), -127.0, 127.0).to(torch.int8)
         for x in xf]
    wire = psum([t.to(torch.int16) for t in q])
    return (wire.to(torch.float32) * scale).to(dtype)


def bool_or_psum(flags: Sequence[torch.Tensor]) -> torch.Tensor:
    """OR of boolean masks over the int8 wire: {0, 1} quantizes exactly,
    so this is a lossless exchange at a quarter of an int32 sum's bytes."""
    return int8_psum([f.to(torch.float32) for f in flags]) > 0.5
