"""The port's threefry RNG (`repro_torch.core.rng`) is bit-exact to
`jax.random` in legacy mode (jax_threefry_partitionable=False), and the
port's connectivity equals the head fixtures' connectivity arrays.

The JAX side runs in a child process (tests/torch_jax_ref.py)."""
import pathlib

import numpy as np
import pytest
import torch

from torch_jax_ref import run_jax
from repro_torch.core import rng
from repro_torch.core.network import make_connectivity
from repro_torch.core.params import test_scale as tiny_scale

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
SEEDS = np.concatenate([np.arange(200), [2**31 - 1, -1, -12345, 0x5EED]])
FOLD_DATA = np.array([0, 1, 7, 0x5EED, 2**31 - 1, 123456789], np.int64)
SHAPES = [(), (1,), (7,), (16,), (3, 70)]
SPANS = [(0, 4), (0, 64), (0, 1200), (0, 10000), (3, 70000)]

_JAX_BODY = """
seeds = IN["seeds"]
keys = jnp.stack([jax.random.PRNGKey(int(s)) for s in seeds])
OUT["keys"] = keys
OUT["fold"] = jax.vmap(lambda k: jax.vmap(
    lambda d: jax.random.fold_in(k, d))(jnp.asarray(IN["fold_data"], jnp.uint32)))(keys)
for n in (2, 3):
    OUT[f"split{n}"] = jax.vmap(lambda k: jax.random.split(k, n))(keys)
for i, shape in enumerate(SHAPES):
    OUT[f"uniform{i}"] = jax.vmap(lambda k: jax.random.uniform(k, shape))(keys)
    for s, (lo, hi) in enumerate(SPANS):
        OUT[f"randint{i}_{s}"] = jax.vmap(
            lambda k: jax.random.randint(k, shape, lo, hi, jnp.int32))(keys)
OUT["categorical"] = jax.vmap(jax.random.categorical)(keys, IN["logits"])
OUT["gumbel"] = jax.vmap(lambda k: jax.random.gumbel(k, (16,)))(keys)
for dt in ("bfloat16",):
    for i, shape in enumerate(SHAPES):
        OUT[f"uniform{i}_{dt}"] = np.asarray(jax.vmap(
            lambda k: jax.random.uniform(k, shape, dt))(keys)).view(np.uint16)
    OUT[f"gumbel_{dt}"] = np.asarray(jax.vmap(
        lambda k: jax.random.gumbel(k, (64,), dt))(keys)).view(np.uint16)
    OUT[f"categorical_{dt}"] = jax.vmap(jax.random.categorical)(
        keys, jnp.asarray(IN["logits"]).astype(dt))
"""


@pytest.fixture(scope="module")
def ref():
    logits = np.random.default_rng(0).normal(
        scale=3.0, size=(len(SEEDS), 16)).astype(np.float32)
    body = f"SHAPES = {SHAPES!r}\nSPANS = {SPANS!r}\n" + _JAX_BODY
    out = run_jax(body, {"seeds": SEEDS, "fold_data": FOLD_DATA,
                         "logits": logits})
    out["logits"] = logits
    return out


@pytest.fixture(scope="module")
def keys():
    return torch.stack([rng.PRNGKey(int(s)) for s in SEEDS])


def _u32(a):
    return np.asarray(a).astype(np.int64)


def test_prng_key(ref, keys):
    np.testing.assert_array_equal(keys.numpy(), _u32(ref["keys"]))


def test_fold_in(ref, keys):
    got = rng.fold_in(keys[:, None, :], torch.from_numpy(FOLD_DATA)[None, :])
    np.testing.assert_array_equal(got.numpy(), _u32(ref["fold"]))


@pytest.mark.parametrize("n", [2, 3])
def test_split(ref, keys, n):
    np.testing.assert_array_equal(rng.split(keys, n).numpy(),
                                  _u32(ref[f"split{n}"]))


@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_uniform_bits(ref, keys, i):
    got = rng.uniform(keys, SHAPES[i]).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  ref[f"uniform{i}"].view(np.int32))


@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_randint(ref, keys, i):
    for s, (lo, hi) in enumerate(SPANS):
        np.testing.assert_array_equal(rng.randint(keys, SHAPES[i], lo, hi).numpy(),
                                      ref[f"randint{i}_{s}"])


def test_categorical_and_gumbel(ref, keys):
    got = rng.categorical(keys, torch.from_numpy(ref["logits"]))
    np.testing.assert_array_equal(got.numpy(), ref["categorical"])
    # the Gumbel noise goes through log twice: torch's and XLA's float32
    # log differ by at most an ulp or so, which never moved an argmax here
    np.testing.assert_allclose(rng.gumbel(keys, (16,)).numpy(), ref["gumbel"],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("draw", ["uniform", "gumbel", "categorical"])
def test_bfloat16_draws(ref, keys, draw):
    """The bfloat16 draws, bit for bit: 8 random bits a value (bfloat16 has
    7 mantissa bits), and every step after the bits, the Gumbel noise's
    two logs included, rounded to bfloat16 as XLA rounds them."""
    bf16 = torch.bfloat16
    bits = lambda t: t.view(torch.int16).numpy().view(np.uint16)
    if draw == "uniform":
        for i, shape in enumerate(SHAPES):
            np.testing.assert_array_equal(
                bits(rng.uniform(keys, shape, dtype=bf16)),
                ref[f"uniform{i}_bfloat16"], err_msg=str(shape))
    elif draw == "gumbel":
        np.testing.assert_array_equal(bits(rng.gumbel(keys, (64,), bf16)),
                                      ref["gumbel_bfloat16"])
    else:
        got = rng.categorical(keys, torch.from_numpy(ref["logits"]).to(bf16))
        np.testing.assert_array_equal(got.numpy(), ref["categorical_bfloat16"])


@pytest.mark.parametrize("name", ["lazy_worklist", "lazy_dense"])
def test_connectivity_matches_fixture(name):
    d = np.load(FIXTURES / f"head_{name}.npz")
    key = rng.fold_in(rng.PRNGKey(0), 1)
    conn = make_connectivity(tiny_scale(4, 64, 16), key)
    np.testing.assert_array_equal(conn.dest_hcu.numpy(), d["conn_dest_hcu"])
    np.testing.assert_array_equal(conn.dest_row.numpy(), d["conn_dest_row"])
    np.testing.assert_array_equal(conn.delay.numpy(), d["conn_delay"])
