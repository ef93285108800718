"""``jax.random``'s threefry2x32 draws in integer PyTorch, bit for bit.

The JAX package draws its bagging and GOSS masks with ``jax.random``
(``PRNGKey``, ``fold_in``, ``uniform``) under the default
``threefry2x32`` implementation with ``jax_threefry_partitionable``
on, as jax 0.9 sets it. The port cannot call JAX, so it computes the
same bits here: the Threefry-2x32 hash of 20 rounds
(``jax/_src/prng.py:_threefry2x32_lowering``), the key of an integer
seed (``threefry_seed``: the seed's high and low 32 bits), ``fold_in``
(the key hashed with the counter pair ``(0, data)``) and ``uniform``
(``jax/_src/random.py:_uniform``): element ``i`` of a shape-``(n,)``
draw hashes the counter pair ``(i >> 32, i & 0xffffffff)`` (the
partitionable scheme), its two output words are xor'ed, the top 23
bits become the mantissa of a float32 in [1, 2), and 1 is subtracted.

Keys are host integer pairs. The hash runs on int64 tensors holding
uint32 values, masked after every add and shift (PyTorch has no uint32
shifts on CUDA); the same function hashes host ints. Draws are made in
chunks of ``CHUNK`` elements to bound the int64 temporaries.
"""

from __future__ import annotations

from typing import Tuple

import torch

MASK = 0xFFFFFFFF
CHUNK = 1 << 22
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[int, int]


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(key: Key, x0, x1):
    """The Threefry-2x32 hash of the counter pairs ``(x0, x1)`` (uint32
    values in host ints or int64 tensors) under ``key``."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: the seed is
    taken as an int32 (wrapped), its logical shift by 32 is 0, and its
    low 32 bits are the second word."""
    s32 = ((int(seed) + (1 << 31)) & MASK) - (1 << 31)
    return (0, s32 & MASK)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``: ``key`` hashed with the seed
    words ``(0, data)`` of the uint32 ``data``."""
    return threefry2x32(key, 0, int(data) & MASK)


def uniform(key: Key, n: int, device) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))``: float32 [n] in [0, 1)."""
    out = torch.empty(n, dtype=torch.float32, device=device)
    for lo in range(0, n, CHUNK):
        hi = min(lo + CHUNK, n)
        i = torch.arange(lo, hi, dtype=torch.int64, device=device)
        b0, b1 = threefry2x32(key, i >> 32, i & MASK)
        bits = ((b0 ^ b1) >> 9) | 0x3F800000
        out[lo:hi] = bits.to(torch.int32).view(torch.float32) - 1.0
    return out
