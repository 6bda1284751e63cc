"""The port's synthetic data streams (`repro_torch.data`) against the JAX
package's (`repro.data`), bit for bit.

Every stream is drawn from `numpy.random.default_rng` in the JAX
package's order, so the port's tensors must equal the JAX package's
arrays exactly: `MarkovLM.batch` (several seeds, steps, the branch
factor and host shards), `poisson_external_drive` (the default rate, an
explicit one and a narrow width), `pattern_drive` (with and without
noise rows) and `make_patterns`; `lm_batch_spec` gives the same shapes
and dtypes. The JAX package runs once, in a child process
(`tests/torch_jax_ref.py`).
"""
import numpy as np
import pytest
import torch

from torch_jax_ref import run_jax
from repro_torch.core.params import test_scale as tiny_scale
from repro_torch.data import (MarkovLM, lm_batch_spec, make_patterns,
                              pattern_drive, poisson_external_drive)

# name -> (vocab, seed, branch, step, batch, seq, shard, n_shards)
MARKOV = {
    "seed0": (512, 0, 4, 0, 4, 16, 0, 1),
    "step7": (512, 0, 4, 7, 4, 16, 0, 1),
    "seed3_branch2": (1000, 3, 2, 5, 6, 33, 0, 1),
    "shard1_of_2": (512, 1, 4, 11, 8, 16, 1, 2),
    "wide_vocab": (151_936, 0, 4, 2, 2, 64, 0, 1),
}
P_ARGS = (6, 40, 16)          # test_scale(n_hcu, rows, cols)
# name -> (n_ticks, seed, width, lam)
POISSON = {"default_rate": (5, 0, 8, None), "lam2.5": (7, 3, 8, 2.5),
           "width4": (4, 1, 4, 9.0)}
# name -> (noise, seed)
PATTERN = {"clean": (0.0, 0), "noisy": (0.5, 2)}
SCHEDULE = [0, -1, 2, 1, 1, -1, 0, 2]
N_PATTERNS = 3

BODY = """
from repro.core.params import test_scale
from repro.data import (MarkovLM, lm_batch_spec, make_patterns, pattern_drive,
                        poisson_external_drive)

for name, (vocab, seed, branch, step, b, s, shard, n) in MARKOV.items():
    out = MarkovLM(vocab, seed=seed, branch=branch).batch(step, b, s, shard, n)
    OUT[f"markov/{name}/tokens"] = out["tokens"]
    OUT[f"markov/{name}/labels"] = out["labels"]
spec = lm_batch_spec(4, 16)
OUT["spec"] = np.array([[*spec[k].shape, spec[k].dtype == jnp.int32]
                        for k in ("tokens", "labels")])
p = test_scale(*P_ARGS)
for name, (T, seed, width, lam) in POISSON.items():
    OUT[f"poisson/{name}"] = np.stack(list(poisson_external_drive(
        p, T, seed=seed, width=width, lam=lam)))
pats = make_patterns(p, N_PATTERNS, seed=4)
OUT["patterns"] = pats
for name, (noise, seed) in PATTERN.items():
    OUT[f"pattern/{name}"] = np.stack(list(pattern_drive(
        p, pats, SCHEDULE, noise=noise, seed=seed)))
"""


@pytest.fixture(scope="module")
def ref():
    head = (f"MARKOV = {MARKOV!r}\nP_ARGS = {P_ARGS!r}\nPOISSON = {POISSON!r}\n"
            f"PATTERN = {PATTERN!r}\nSCHEDULE = {SCHEDULE!r}\n"
            f"N_PATTERNS = {N_PATTERNS}\n")
    return run_jax(head + BODY)


def _equal(got, want):
    assert got.dtype == torch.int32
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", MARKOV)
def test_markov_lm_matches_jax(ref, name):
    vocab, seed, branch, step, b, s, shard, n = MARKOV[name]
    out = MarkovLM(vocab, seed=seed, branch=branch).batch(
        step, b, s, shard, n, device="cpu")
    assert out["tokens"].shape == (b // n, s)
    _equal(out["tokens"], ref[f"markov/{name}/tokens"])
    _equal(out["labels"], ref[f"markov/{name}/labels"])


def test_lm_batch_spec_matches_jax(ref):
    spec = lm_batch_spec(4, 16)
    for k, row in zip(("tokens", "labels"), ref["spec"]):
        assert spec[k].device.type == "meta"
        assert tuple(spec[k].shape) == tuple(row[:2])
        assert spec[k].dtype == torch.int32 and row[2]


@pytest.mark.parametrize("name", POISSON)
def test_poisson_external_drive_matches_jax(ref, name):
    T, seed, width, lam = POISSON[name]
    ticks = list(poisson_external_drive(tiny_scale(*P_ARGS), T, seed=seed,
                                        width=width, lam=lam, device="cpu"))
    assert len(ticks) == T
    _equal(torch.stack(ticks), ref[f"poisson/{name}"])


def test_make_patterns_matches_jax(ref):
    np.testing.assert_array_equal(
        make_patterns(tiny_scale(*P_ARGS), N_PATTERNS, seed=4), ref["patterns"])


@pytest.mark.parametrize("name", PATTERN)
def test_pattern_drive_matches_jax(ref, name):
    noise, seed = PATTERN[name]
    p = tiny_scale(*P_ARGS)
    ticks = list(pattern_drive(p, make_patterns(p, N_PATTERNS, seed=4),
                               SCHEDULE, noise=noise, seed=seed, device="cpu"))
    _equal(torch.stack(ticks), ref[f"pattern/{name}"])


@pytest.mark.parametrize("stream", ["markov", "poisson", "pattern"])
def test_streams_default_to_cuda(stream):
    p = tiny_scale(*P_ARGS)
    make = {"markov": lambda: MarkovLM(64).batch(0, 2, 4)["tokens"],
            "poisson": lambda: next(poisson_external_drive(p, 1)),
            "pattern": lambda: next(pattern_drive(
                p, make_patterns(p, 1), [0]))}[stream]
    if torch.cuda.is_available():
        assert make().is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
