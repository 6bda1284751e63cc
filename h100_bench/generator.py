"""The benchmark's one traffic generator. A traffic mix is a JSON file under
``traffic/`` whose ``driver`` names the driver that runs it (`drivers/`)
and whose other keys are the law's parameters; everything is drawn from
the run's seed, so the same seed gives the same traffic on the same device.

* `DriveStream` (driver ``sim``): the external drive of a simulated
  network. Each tick every HCU receives min(Poisson(lam), width) spikes on
  rows drawn uniformly from its R rows; unused slots hold the sentinel R.
  Drawn on the device, a chunk of ticks at a time, from a `torch.Generator`
  seeded with the seed: the program and the reference draw the same chunks
  in the same order.
* `recall_traffic` (driver ``recall``): open-loop recall sessions at
  ``rate_per_s`` over a window of the run's length: the gaps are the
  quantiles of the exponential law of that rate, in an order shuffled by
  the seed, so every seed offers the same number of sessions and the same
  gaps; each cue is one of ``patterns`` stored patterns, drawn uniformly,
  driving each HCU with probability ``cue_fraction``. The patterns
  themselves (a row per HCU) are drawn from the seed too.
"""
from __future__ import annotations

import dataclasses
import math

import torch

SEED_MASK = (1 << 63) - 1


class DriveStream:
    """Chunks (L, n, width) int32 of a drive mix, in order."""

    def __init__(self, mix: dict, n_hcu: int, rows: int, seed: int, device):
        self.lam = float(mix["lam"])
        self.width = int(mix["width"])
        self.n, self.rows, self.device = n_hcu, rows, torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed & SEED_MASK)

    def next(self, L: int) -> torch.Tensor:
        rate = torch.full((L, self.n), self.lam, dtype=torch.float32,
                          device=self.device)
        count = torch.clamp(torch.poisson(rate, generator=self.gen),
                            max=self.width).to(torch.int32)
        rows = torch.randint(0, self.rows, (L, self.n, self.width),
                             generator=self.gen, dtype=torch.int32,
                             device=self.device)
        slot = torch.arange(self.width, dtype=torch.int32, device=self.device)
        return torch.where(slot < count[..., None], rows, self.rows)


@dataclasses.dataclass
class Session:
    rid: int
    due_s: float             # seconds after the window opens
    pattern: int
    cue_mask: torch.Tensor   # (n,) bool


def recall_traffic(mix: dict, n_hcu: int, rows: int, seed: int,
                   seconds: float):
    """(patterns (P, n) int64 rows, sessions in order of arrival) of a
    recall mix over a window of ``seconds``, drawn on the host."""
    g = torch.Generator().manual_seed(seed & SEED_MASK)
    P = int(mix["patterns"])
    patterns = torch.randint(0, rows, (P, n_hcu), generator=g)
    rate = float(mix["rate_per_s"])
    N = max(1, round(rate * seconds))
    gaps = [-math.log(1.0 - (i + 0.5) / N) / rate for i in range(N)]
    order = torch.randperm(N, generator=g).tolist()
    which = torch.randint(0, P, (N,), generator=g).tolist()
    masks = torch.rand((N, n_hcu), generator=g) < float(mix["cue_fraction"])
    t, out = 0.0, []
    for i in range(N):
        t += gaps[order[i]]
        out.append(Session(i, t, which[i], masks[i]))
    return patterns, out


def cue_frame(pattern_rows, cue_mask, rows: int, width: int):
    """One (n, width) int32 frame: the pattern's row in slot 0 of each cued
    HCU, the sentinel everywhere else."""
    frame = torch.full((pattern_rows.shape[0], width), rows, dtype=torch.int32)
    frame[:, 0] = torch.where(cue_mask, pattern_rows.to(torch.int32), rows)
    return frame
