"""Threefry-2x32 random numbers, bit-exact to `jax.random` in its legacy
(``jax_threefry_partitionable=False``) mode.

The JAX package draws the connectivity, the network's base key, the per-tick
per-HCU keys and the soft-WTA noise from `jax.random`; the port reproduces
those streams bit for bit so that its fired history can equal the JAX
package's. This is a transcription of `jax/_src/prng.py` (`threefry_2x32`,
`_threefry_split_original`, `threefry_fold_in`,
`_threefry_random_bits_original`, with its 8- and 16-bit branches and its
blocks of 2^32 - 1 words) and `jax/_src/random.py` (`_uniform`,
`_bernoulli` and `_gumbel` in mode "low", `_randint`, `categorical`). The
floating draws take float32 or bfloat16, as JAX draws them: bfloat16 gets
8 random bits a value (it has 7 mantissa bits), and every operation after
the bits rounds to bfloat16, the bounds included.

A key is an int64 tensor of shape (..., 2) holding two uint32 words. All
uint32 arithmetic runs in int64 and is masked with 0xFFFFFFFF, which is
exact on the CPU and on CUDA alike (int64 products wrap two's-complement,
which keeps the low 32 bits right). Every function accepts a batch of keys
in the leading dimensions: the batch is what JAX gets from `vmap`.
Nothing here reads or advances a global generator.
"""
from __future__ import annotations

import numpy as np
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


def key_data(key) -> np.ndarray:
    """The key's two words as a numpy uint32 array: the JAX package's raw
    legacy key, the form a checkpoint stores (a copy on the host)."""
    return key.cpu().numpy().astype(np.uint32)


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


# words hashed under one key by `random_bits`: JAX's
# ``dtypes.iinfo(np.uint32).max``. A draw of more words is cut into blocks
# of this many, each under its own key. A module constant, so a test can
# shrink it to a size that it can draw.
BLOCK_WORDS = 0xFFFFFFFF


def random_bits(key, shape=(), bit_width: int = 32):
    """`_threefry_random_bits_original`: (..., *shape) words of
    ``bit_width`` bits (32, 16 or 8) as int64. A 16- or 8-bit draw takes
    the 32-bit words of ceil(bit_width * size / 32) counts and cuts each
    word into 32 // bit_width pieces, low bits first.

    Counts of BLOCK_WORDS words or more are cut as JAX cuts them: ``nblocks,
    rem = divmod(n_words, BLOCK_WORDS)``, the keys ``split(key, nblocks +
    1)``, each full block the hash of arange(BLOCK_WORDS) under its own key
    and the remainder that of arange(rem) under the last key, concatenated
    in order."""
    size = 1
    for s in shape:
        size *= s
    if bit_width not in (8, 16, 32):
        raise ValueError(f"bit_width must be 8, 16 or 32, got {bit_width}")
    per_word = 32 // bit_width
    n_words = -(-size // per_word)
    nblocks, rem = divmod(n_words, BLOCK_WORDS)
    if not nblocks:
        words = _hash(key, torch.arange(rem, dtype=torch.int64,
                                        device=key.device))
    else:
        keys = split(key, nblocks + 1)
        block = torch.arange(BLOCK_WORDS, dtype=torch.int64, device=key.device)
        words = torch.cat([_hash(keys[..., i, :], block)
                           for i in range(nblocks)]
                          + [_hash(keys[..., nblocks, :], block[:rem])], dim=-1)
    if per_word > 1:
        shifts = torch.arange(per_word, device=key.device) * bit_width
        words = ((words[..., None] >> shifts) & ((1 << bit_width) - 1))
        words = words.reshape(tuple(key.shape[:-1]) + (-1,))[..., :size]
    return words.reshape(tuple(key.shape[:-1]) + tuple(shape))


# dtype -> (bits, mantissa bits, the integer type its bits are viewed as,
# the bits of 1.0)
_FLOATS = {torch.float32: (32, 23, torch.int32, 0x3F800000),
           torch.bfloat16: (16, 7, torch.int16, 0x3F80)}


def uniform(key, shape=(), minval: float = 0.0, maxval: float = 1.0,
            dtype=torch.float32):
    """`jax.random.uniform`: random mantissa bits under the exponent of
    1.0, minus 1, scaled to [minval, maxval), each step rounded to
    ``dtype`` (float32 or bfloat16)."""
    if dtype not in _FLOATS:
        raise ValueError(f"uniform takes float32 or bfloat16, got {dtype}")
    nbits, nmant, view, one = _FLOATS[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    bits = random_bits(key, shape, rng_bits)
    fbits = ((bits >> (rng_bits - nmant)) | one).to(view)
    floats = fbits.view(dtype) - 1.0
    # the bounds in ``dtype`` as CPU scalars: no copy to the key's device
    lo = torch.tensor(minval, dtype=dtype)
    hi = torch.tensor(maxval, dtype=dtype)
    return torch.clamp(floats * (hi - lo) + lo, min=lo.item())


def bernoulli(key, p: float, shape=()):
    """`jax.random.bernoulli` in mode "low": ``uniform(key, shape) < p``,
    with ``p`` rounded to float32 as JAX converts it. Returns bool."""
    # a zero-dimensional CPU tensor: applied to CUDA tensors as a scalar
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32)


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


def gumbel(key, shape=(), dtype=torch.float32):
    """`jax.random.gumbel`, mode "low": -log(-log(u)) with u uniform in
    [tiny, 1), in ``dtype`` (float32 or bfloat16)."""
    tiny = torch.finfo(dtype).tiny
    u = uniform(key, shape, minval=tiny, maxval=1.0, dtype=dtype)
    return -torch.log(-torch.log(u))


def categorical(key, logits):
    """`jax.random.categorical` along the last axis (Gumbel argmax; the
    first maximum wins, as in `jnp.argmax`), its noise drawn in the
    logits' dtype. key (..., 2) pairs with the leading dims of logits,
    and each key draws the rest of logits' shape: keys (H, 2) with logits
    (H, C) draw (C,) each, one key (2,) draws all of (B, C), as
    `jax.random.categorical` does with one key. Returns int32 of logits'
    shape without its last axis."""
    g = gumbel(key, tuple(logits.shape[key.dim() - 1:]), logits.dtype)
    return torch.argmax(g + logits, dim=-1).to(torch.int32)
