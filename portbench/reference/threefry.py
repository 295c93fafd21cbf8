"""Threefry-2x32 (Salmon, Moraes, Dror and Shaw, "Parallel random numbers:
as easy as 1, 2, 3", SC 2011) and the draws JAX makes from it, in plain
torch: what the walk index's configuration names as its generator.

  * ``threefry2x32(key, x)``: 20 rounds, rotations (13, 15, 26, 6) and
    (17, 29, 16, 24) in turn, the key schedule (k0, k1, k0 ^ k1 ^
    0x1BD11BDA) injected after every 4 rounds with the injection count;
  * ``PRNGKey(seed)``: the seed's 64 bits as (high word, low word);
  * ``fold_in(key, d)``: threefry2x32(key, (0, d));
  * ``uniform(key, (2,), float32)[i]``: bits = y0 ^ y1 of
    threefry2x32(key, (0, i)) (JAX's partitionable layout), then
    (bits >> 9) | 0x3F800000 read as a float32, minus 1.

Words are int64 tensors holding values in [0, 2**32).
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed: int):
    seed = int(seed)
    return (seed >> 32) & M32, seed & M32


def _rotl(x, r):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (torch.as_tensor(x0, dtype=torch.int64) + ks[0]) & M32
    x1 = (torch.as_tensor(x1, dtype=torch.int64) + ks[1]) & M32
    for i in range(5):
        for r in ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def fold_in(key, data):
    return threefry2x32(key[0], key[1], 0,
                        torch.as_tensor(data, dtype=torch.int64) & M32)


def uniform2(key) -> torch.Tensor:
    """f32[..., 2] in [0, 1): ``jax.random.uniform(key, (2,))``."""
    out = []
    for i in range(2):
        y0, y1 = threefry2x32(key[0], key[1], 0, i)
        bits = (y0 ^ y1) >> 9 | 0x3F800000
        out.append(bits.to(torch.int32).view(torch.float32) - 1.0)
    return torch.stack(out, dim=-1)
