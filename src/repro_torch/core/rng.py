"""Threefry-2x32 random numbers, bit-exact to `jax.random` in its legacy
(``jax_threefry_partitionable=False``) mode.

The JAX package draws the connectivity, the network's base key, the per-tick
per-HCU keys and the soft-WTA noise from `jax.random`; the port reproduces
those streams bit for bit so that its fired history can equal the JAX
package's. This is a transcription of `jax/_src/prng.py` (`threefry_2x32`,
`_threefry_split_original`, `threefry_fold_in`,
`_threefry_random_bits_original`) and `jax/_src/random.py` (`_uniform`,
`_randint`, `_gumbel` in mode "low", `categorical`).

A key is an int64 tensor of shape (..., 2) holding two uint32 words. All
uint32 arithmetic runs in int64 and is masked with 0xFFFFFFFF, which is
exact on the CPU and on CUDA alike (int64 products wrap two's-complement,
which keeps the low 32 bits right). Every function accepts a batch of keys
in the leading dimensions: the batch is what JAX gets from `vmap`.
Nothing here reads or advances a global generator.
"""
from __future__ import annotations

import torch

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M


def _threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block function (20 rounds) on broadcast int64
    tensors of uint32 words; returns the two output words."""
    k3 = k1 ^ k2 ^ 0x1BD11BDA
    ks = (k1, k2, k3)
    x1 = (x1 + k1) & _M
    x2 = (x2 + k2) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M
    return x1, x2


def _hash(key, count):
    """`threefry_2x32(key, count)` for a flat (N,) count vector: the count
    is split in halves (zero-padded to even length), hashed pairwise, and
    the two output halves are concatenated. key (..., 2) -> (..., N)."""
    n = count.shape[0]
    if n % 2:
        count = torch.cat([count, count.new_zeros(1)])
    half = count.shape[0] // 2
    k1, k2 = key[..., 0:1], key[..., 1:2]
    o1, o2 = _threefry2x32(k1, k2, count[:half], count[half:])
    return torch.cat([o1, o2], dim=-1)[..., :n]


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` with 32-bit integers: (0, seed mod 2^32)."""
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed must fit int32, got {seed}")
    return torch.tensor([0, seed & _M], dtype=torch.int64, device=device)


def fold_in(key, data):
    """`jax.random.fold_in`. ``data`` is a Python int or an integer tensor
    broadcastable against the key batch; the result has their broadcast
    batch shape (+ (2,))."""
    if not torch.is_tensor(data):
        data = torch.tensor(data, device=key.device)
    d = data.to(torch.int64) & _M
    k1, k2 = key[..., 0], key[..., 1]
    o1, o2 = _threefry2x32(k1, k2, torch.zeros_like(d), d)
    return torch.stack([o1, o2], dim=-1)


def split(key, num: int = 2):
    """`jax.random.split` (legacy): key (..., 2) -> (..., num, 2)."""
    count = torch.arange(2 * num, dtype=torch.int64, device=key.device)
    return _hash(key, count).reshape(tuple(key.shape[:-1]) + (num, 2))


def random_bits(key, shape=()):
    """`_threefry_random_bits_original` for 32-bit words: (..., *shape)."""
    size = 1
    for s in shape:
        size *= s
    count = torch.arange(size, dtype=torch.int64, device=key.device)
    return _hash(key, count).reshape(tuple(key.shape[:-1]) + tuple(shape))


def uniform(key, shape=(), minval: float = 0.0, maxval: float = 1.0):
    """`jax.random.uniform` in float32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled to [minval, maxval)."""
    bits = random_bits(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    # float32 bounds as CPU scalars: no copy to the key's device
    lo = torch.tensor(minval, dtype=torch.float32)
    hi = torch.tensor(maxval, dtype=torch.float32)
    return torch.clamp(floats * (hi - lo) + lo, min=lo.item())


def randint(key, shape, minval: int, maxval: int):
    """`jax.random.randint` for int32 bounds: two words of bits per value,
    folded modulo the span with JAX's uint32 (wrapping) arithmetic."""
    k = split(key, 2)
    higher = random_bits(k[..., 0, :], shape)
    lower = random_bits(k[..., 1, :], shape)
    span = (maxval - minval) & _M if maxval > minval else 1
    mult = (1 << 16) % span
    mult = ((mult * mult) & _M) % span
    off = ((higher % span) * mult) & _M
    off = ((off + lower % span) & _M) % span
    return (minval + off).to(torch.int32)


def gumbel(key, shape=()):
    """`jax.random.gumbel` in float32, mode "low": -log(-log(u)) with u
    uniform in [tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = uniform(key, shape, minval=tiny, maxval=1.0)
    return -torch.log(-torch.log(u))


def categorical(key, logits):
    """`jax.random.categorical` along the last axis (Gumbel argmax; the
    first maximum wins, as in `jnp.argmax`). key (..., 2) pairs with the
    leading dims of logits, and each key draws the rest of logits' shape:
    keys (H, 2) with logits (H, C) draw (C,) each, one key (2,) draws all
    of (B, C), as `jax.random.categorical` does with one key. Returns
    int32 of logits' shape without its last axis."""
    g = gumbel(key, tuple(logits.shape[key.dim() - 1:]))
    return torch.argmax(g + logits, dim=-1).to(torch.int32)
