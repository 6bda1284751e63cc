"""Threefry-2x32 random numbers in plain PyTorch: the benchmark's frozen copy
of the draws the simulated network takes (the legacy, non-partitionable
stream of `jax.random`), so the reference rebuilds the connectivity, the
per-tick keys and the soft-WTA noise from the seed alone.

A key is an int64 tensor (..., 2) of two uint32 words; uint32 arithmetic
runs in int64 masked with 0xFFFFFFFF. A draw of n words hashes the counts
0..n-1 in pairs (i, i + n/2); `bits_block` computes any range of them, so
a draw of 2.2e8 words (the rodent network's connectivity) never holds
more than a block of temporaries.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x1, x2):
    """The 20-round Threefry-2x32 block function on broadcast int64 words."""
    k3 = k1 ^ k2 ^ 0x1BD11BDA
    ks = (k1, k2, k3)
    x1 = (x1 + k1) & M32
    x2 = (x2 + k2) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x1, x2


def key_from_seed(seed: int, device=None) -> torch.Tensor:
    """The two words of a benchmark seed (any whole number below 2**64):
    (seed >> 32, seed mod 2**32)."""
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed must lie in [0, 2**64), got {seed}")
    return torch.tensor([(seed >> 32) & M32, seed & M32], dtype=torch.int64,
                        device=device)


def fold_in(key, data):
    """Fold an integer (or an integer tensor broadcast against the key
    batch) into the key."""
    if not torch.is_tensor(data):
        data = torch.tensor(data, device=key.device)
    d = data.to(torch.int64) & M32
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([o1, o2], dim=-1)


def _hash_small(key, n: int):
    """The n words of the count vector 0..n-1 under each key of the batch:
    the counts are paired (i, i + half) after padding to even length, and
    the two output halves concatenated. key (..., 2) -> (..., n)."""
    count = torch.arange(n, dtype=torch.int64, device=key.device)
    if n % 2:
        count = torch.cat([count, count.new_zeros(1)])
    half = count.shape[0] // 2
    o1, o2 = threefry2x32(key[..., 0:1], key[..., 1:2], count[:half],
                          count[half:])
    return torch.cat([o1, o2], dim=-1)[..., :n]


def split(key, num: int = 2):
    """key (..., 2) -> (..., num, 2)."""
    return _hash_small(key, 2 * num).reshape(tuple(key.shape[:-1]) + (num, 2))


def bits_block(key, n: int, lo: int, hi: int):
    """Words lo..hi-1 of the n-word draw under one key (2,), as int64,
    computed from just the pairs that hold them."""
    half = (n + (n % 2)) // 2
    k1, k2 = key[0], key[1]
    out = torch.empty(hi - lo, dtype=torch.int64, device=key.device)
    # words below half are the first outputs of pairs (i, i + half); the
    # others the second outputs of pairs (i - half, i); an odd count is
    # padded with a zero
    def pair(i):
        j = i + half
        return threefry2x32(k1, k2, i, torch.where(j < n, j, 0))

    a, b = lo, min(hi, half)
    if a < b:
        out[:b - a] = pair(torch.arange(a, b, dtype=torch.int64,
                                        device=key.device))[0]
    a, b = max(lo, half), hi
    if a < b:
        out[a - lo:] = pair(torch.arange(a - half, b - half, dtype=torch.int64,
                                         device=key.device))[1]
    return out


def uniform_from_bits(bits):
    """float32 uniforms in [0, 1) from 32-bit words: the top 23 bits as the
    mantissa under the exponent of 1.0, minus 1."""
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fbits.view(torch.float32) - 1.0


def uniform(key, n: int):
    """n float32 uniforms in [0, 1) under each key of the batch."""
    floats = uniform_from_bits(_hash_small(key, n))
    lo = torch.tensor(0.0, dtype=torch.float32)
    hi = torch.tensor(1.0, dtype=torch.float32)
    return torch.clamp(floats * (hi - lo) + lo, min=lo.item())


def gumbel(key, n: int):
    """n float32 Gumbel draws under each key: -log(-log(u)), u uniform in
    [tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    floats = uniform_from_bits(_hash_small(key, n))
    lo = torch.tensor(tiny, dtype=torch.float32)
    hi = torch.tensor(1.0, dtype=torch.float32)
    u = torch.clamp(floats * (hi - lo) + lo, min=lo.item())
    return -torch.log(-torch.log(u))


def randint_block(keys2, n: int, lo: int, hi: int, minval: int, maxval: int):
    """Entries lo..hi-1 of an n-entry int32 draw in [minval, maxval): two
    words an entry (one from each key of ``keys2`` (2, 2)), folded modulo
    the span with uint32 arithmetic."""
    higher = bits_block(keys2[0], n, lo, hi)
    lower = bits_block(keys2[1], n, lo, hi)
    span = (maxval - minval) & M32 if maxval > minval else 1
    mult = (1 << 16) % span
    mult = ((mult * mult) & M32) % span
    off = ((higher % span) * mult) & M32
    off = ((off + lower % span) & M32) % span
    return (minval + off).to(torch.int32)
