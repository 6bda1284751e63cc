"""Deterministic synthetic data streams (the port of
`repro.data.synthetic`): no external dataset.

LM: an order-1 Markov token stream, predictable from context, so a model
trained on it shows a real loss decrease. BCPNN: Poisson spike streams
and stored-pattern drives for the associative-memory protocol.

Every stream is drawn from `numpy.random.default_rng` in the JAX
package's order, so its values equal the JAX package's bit for bit; the
tensors go to ``device`` where the JAX package calls `jnp.asarray` (None
means CUDA, and raises where there is none, as every entry point of the
port). Both pipelines are host-sharded: each process makes only its
slice of the global batch, keyed by (seed, step, shard).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.device import resolve_device


# -------------------------------- LM stream ---------------------------------

@dataclasses.dataclass
class MarkovLM:
    """Order-1 Markov chain over `vocab` with low-entropy transitions."""
    vocab: int
    seed: int = 0
    branch: int = 4          # out-degree per state: log2(branch) bits/token

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.next_tokens = rng.integers(0, self.vocab,
                                        (self.vocab, self.branch))

    def batch(self, step: int, batch: int, seq: int, shard: int = 0,
              n_shards: int = 1, device=None):
        """{tokens, labels}, each (batch // n_shards, seq) int32 on
        ``device``: this host's slice of the batch."""
        device = resolve_device(device)
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + shard)
        b_local = batch // n_shards
        toks = np.empty((b_local, seq + 1), np.int64)
        toks[:, 0] = rng.integers(0, self.vocab, b_local)
        choices = rng.integers(0, self.branch, (b_local, seq))
        for t in range(seq):
            toks[:, t + 1] = self.next_tokens[toks[:, t], choices[:, t]]
        as_t = lambda a: torch.from_numpy(a.astype(np.int32)).to(device)
        return {"tokens": as_t(toks[:, :-1]), "labels": as_t(toks[:, 1:])}


def lm_batch_spec(batch: int, seq: int):
    """The batch's shapes and dtypes as meta-device tensors (the JAX
    package's `jax.ShapeDtypeStruct`s)."""
    spec = lambda: torch.empty((batch, seq), dtype=torch.int32, device="meta")
    return {"tokens": spec(), "labels": spec()}


# ------------------------------ BCPNN streams -------------------------------

def poisson_external_drive(p, n_ticks: int, seed: int = 0, width: int = 8,
                           lam: float | None = None, device=None):
    """Yields (H, width) int32 external spike rows, Poisson(lam) per HCU;
    unused slots hold the ``p.rows`` sentinel."""
    device = resolve_device(device)
    lam = lam if lam is not None else min(p.in_rate, width / 2)
    rng = np.random.default_rng(seed)
    for _ in range(n_ticks):
        out = np.full((p.n_hcu, width), p.rows, np.int32)
        for h in range(p.n_hcu):
            n = min(width, rng.poisson(lam))
            out[h, :n] = rng.integers(0, p.rows, n)
        yield torch.from_numpy(out).to(device)


def pattern_drive(p, patterns: np.ndarray, schedule, width: int = 8,
                  noise: float = 0.0, seed: int = 0, device=None):
    """Drive the network with stored patterns (associative-memory training).

    patterns: (n_patterns, n_hcu) winning-row index per HCU per pattern.
    schedule: iterable of pattern ids (or -1 for silence) per tick.
    Each active tick, every HCU receives a spike on its pattern row (plus
    optional noise rows).
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    for pid in schedule:
        out = np.full((p.n_hcu, width), p.rows, np.int32)
        if pid >= 0:
            out[:, 0] = patterns[pid]
            if noise > 0:
                for h in range(p.n_hcu):
                    if rng.random() < noise:
                        out[h, 1] = rng.integers(0, p.rows)
        yield torch.from_numpy(out).to(device)


def make_patterns(p, n_patterns: int, seed: int = 0) -> np.ndarray:
    """(n_patterns, n_hcu) random pattern rows, a numpy array as in the
    JAX package."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, p.rows, (n_patterns, p.n_hcu))
