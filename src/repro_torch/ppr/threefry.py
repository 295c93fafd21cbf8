"""Threefry-2x32 in plain torch: the bits ``jax.random`` draws.

The walk index's randomness is ``fold_in(fold_in(key, walk id), hop)``
followed by ``uniform(key, (2,), float32)`` (``ppr/walks.py``).  Walks are
bitwise equal to the reference package's only if these bits are, so this
module reproduces JAX's default threefry PRNG exactly, under its
partitionable bit layout (``jax_threefry_partitionable``, on by default
since jax 0.5):

  * ``threefry2x32(k0, k1, x0, x1)`` — the Threefry-2x32 hash, 20 rounds
    with key injection every 4 (Salmon et al., *Parallel random numbers: as
    easy as 1, 2, 3*, SC 2011);
  * ``fold_in(key, d) = threefry2x32(key, (0, d))``;
  * ``uniform(key)[i]`` for i in {0, 1}: ``bits = y0 ^ y1`` of
    ``threefry2x32(key, (0, i))``, then ``(bits >> 9) | 0x3F800000``
    bit-cast to float32, minus 1.0 — a float in [0, 1).

Torch's ``uint32`` has no arithmetic, so words are int64 tensors holding
values in [0, 2**32), masked after every add and shift.  A key is a pair
of such words: Python ints or int64 tensors that broadcast together.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

Word = Union[int, torch.Tensor]
Key = Tuple[Word, Word]

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)``: the seed's 64 bits as (high, low)."""
    seed = int(seed)
    return (seed >> 32) & MASK, seed & MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0: Word, k1: Word, x0: Word, x1: Word
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counter words (x0, x1) under key (k0, k1);
    every argument is a word (an int64 tensor or int in [0, 2**32)), and
    the two results broadcast over all of them."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = torch.as_tensor(x0, dtype=torch.int64)
    x1 = torch.as_tensor(x1, dtype=torch.int64)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def fold_in(key: Key, data: Word) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.fold_in(key, data)`` for 32-bit ``data``."""
    return threefry2x32(key[0], key[1], 0, torch.as_tensor(data) & MASK)


def random_bits(key: Key, i: int) -> torch.Tensor:
    """Word ``i`` of ``jax.random.bits(key, shape)`` for a 1-D shape
    (partitionable layout: counter (0, i), the two outputs xor-ed)."""
    y0, y1 = threefry2x32(key[0], key[1], 0, i)
    return y0 ^ y1


def bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """The 23 high bits as the mantissa of a float32 in [1, 2), minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform2(key: Key) -> torch.Tensor:
    """``jax.random.uniform(key, (2,), float32)``: f32[..., 2] in [0, 1)."""
    return torch.stack([bits_to_unit_float(random_bits(key, i))
                        for i in range(2)], dim=-1)
