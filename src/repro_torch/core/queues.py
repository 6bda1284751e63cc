"""Spike-queue dimensioning math (paper §IV, Fig 7).

Pure analysis utilities — the runtime queues themselves live in network.py.
The port's own copy of `repro.core.queues` (pure Python), which the port
may not import.
Reproduces:
  * EQ1: P(x or more spikes in a ms) for Poisson(lambda=10) arrivals,
  * the queue-size-36 operating point (~30% chance of one drop per month),
  * the induced worst-case bandwidth / compute load (§IV.A):
      - 640 KB/HCU/ms synaptic traffic, 0.5 MFLOP/ms/HCU (paper's numbers
        are reproduced analytically in benchmarks/table1_requirements.py).
"""
from __future__ import annotations

import math


def p_x_or_more(x: int, lam: float) -> float:
    """Complement CDF: probability of >= x spikes in one ms (paper EQ1)."""
    # 1 - sum_{k=0}^{x-1} e^-lam lam^k / k!
    acc = 0.0
    term = math.exp(-lam)
    for k in range(x):
        acc += term
        term *= lam / (k + 1)
    return max(0.0, 1.0 - acc)


def drop_probability_per_ms(queue_size: int, lam: float) -> float:
    """Probability that at least one spike is dropped in a given ms."""
    return p_x_or_more(queue_size + 1, lam)


def expected_drops_per_month(queue_size: int, lam: float) -> float:
    ms_per_month = 1000.0 * 3600.0 * 24.0 * 30.0
    return drop_probability_per_ms(queue_size, lam) * ms_per_month


def min_queue_for_monthly_drop_budget(lam: float, budget: float = 1.0,
                                      max_q: int = 128) -> int:
    """Smallest queue size with expected drops/month <= budget (paper: 36)."""
    for q in range(1, max_q):
        if expected_drops_per_month(q, lam) <= budget:
            return q
    return max_q


def worst_case_ms_load(p) -> dict:
    """Worst-case per-ms load for queue-size spikes (paper §IV.A, EQ2).

    Returns bytes moved to/from synaptic storage and cell updates required.
    """
    q = p.active_queue
    cell_b = p.cell_bytes
    row_cells = p.cols
    col_cells = p.rows
    # rows: fetch+update+writeback; column: same; periodic: local SRAM only
    cells = q * row_cells + col_cells
    rw_bytes = 2 * cells * cell_b
    return {
        "worst_case_spikes": q,
        "cells_touched": cells,
        "bytes_per_ms": rw_bytes,
        "bandwidth_GBs": rw_bytes / 1e6,          # per ms -> per s is x1000
        "flops_per_ms": cells * FLOPS_PER_CELL,
    }


# FLOPs of one fused lazy cell update, counted from the closed-form datapath
# (traces.decay_zep + Hebbian increment + bayesian_weight):
#   3 exp (8 flop each by convention), 1 log (8), 1 div (4),
#   muls/adds of the closed form: ~20  -> ~60 flop/cell.
# The paper's 0.5 MFLOP/ms/HCU over ~13.6k worst-case cells implies ~40-110
# flop/cell depending on transcendental accounting — same order.
FLOPS_PER_CELL = 60
