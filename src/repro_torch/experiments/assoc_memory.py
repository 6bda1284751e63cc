"""Associative-memory train/cue/recall protocol (paper §I-II), reusable (the
port of `repro.experiments.assoc_memory`).

  train_assoc       present P patterns repeatedly; record each pattern's
                    attractor (winning MCU per HCU)
  recall_accuracy   cue with partial patterns from the trained state and
                    count undriven HCUs that complete to their attractor —
                    with an optional `corrupt` hook applied to the state
                    before each recall (the DRAM-retention fault experiment
                    plugs `repro_torch.runtime.inject_retention_faults` in
                    here)

Chance level is 1/C (C = MCUs per HCU); a working associative memory scores
far above it. Every presentation is one `Simulator.run` on the
Simulator's device: on CUDA a replay of the chunk graph of its length,
captured once on the held state. A recall therefore copies its start state
into the held tensors in place instead of rebinding them, which keeps the
graphs (and the bits: a copy is exact).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import network as N
from repro_torch.core.device import resolve_device
from repro_torch.core.params import BCPNNParams


def assoc_params() -> BCPNNParams:
    """The small associative-memory network the example and the resilience
    benchmark share (12 HCUs, 8 MCUs each, slow P traces)."""
    return BCPNNParams(n_hcu=12, rows=64, cols=8, fanout=12, active_queue=16,
                       max_delay=4, mean_delay=1.5, out_rate=1.0,
                       wta_temp=0.25, tau_p=400.0)


def drive_frame(p: BCPNNParams, pattern_rows, active_mask, width: int = 4,
                device=None) -> torch.Tensor:
    """One (H, width) int32 external-input frame on ``device`` (CUDA
    unless the caller passes the CPU): pattern row in slot 0 for active
    HCUs, padding (row index == p.rows) everywhere else."""
    ext = np.full((p.n_hcu, width), p.rows, np.int32)
    for h in range(p.n_hcu):
        if active_mask[h]:
            ext[h, 0] = pattern_rows[h]
    return torch.from_numpy(ext).to(resolve_device(device))


def winners_from_fired(fired) -> np.ndarray:
    """Last WTA winner per HCU from a (T, H) fired history (-1 where the
    HCU never fired); a tensor is read to the host."""
    if torch.is_tensor(fired):
        fired = fired.cpu().numpy()
    fired = np.asarray(fired)
    winners = np.full((fired.shape[1],), -1, np.int64)
    for f in fired:
        upd = f >= 0
        winners[upd] = f[upd]
    return winners


def _present(sim, frame, n_ticks: int) -> np.ndarray:
    """Run one presentation through the chunked driver (bitwise the same
    trajectory as per-tick `sim.tick` calls — the engine contract)."""
    ext = frame.expand((n_ticks,) + tuple(frame.shape))
    return winners_from_fired(sim.run(ext))


def train_assoc(sim, patterns, *, reps: int = 30, present_ms: int = 6,
                gap_ms: int = 2) -> np.ndarray:
    """Present every pattern `reps` times (with `gap_ms` of silence between
    sweeps so Z traces decay); returns the (P, H) attractor — each pattern's
    winning MCU per HCU on the final presentation. Leaves `sim.state` as the
    trained state."""
    p = sim.p
    n_patterns = len(patterns)
    all_on = np.ones(p.n_hcu, bool)
    silence = drive_frame(p, patterns[0], np.zeros(p.n_hcu, bool),
                          device=sim.device)
    frames = [drive_frame(p, patterns[pid], all_on, device=sim.device)
              for pid in range(n_patterns)]
    attractor = np.zeros((n_patterns, p.n_hcu), np.int64)
    for rep in range(reps):
        for pid in range(n_patterns):
            winners = _present(sim, frames[pid], present_ms)
            if rep == reps - 1:
                attractor[pid] = winners
        _present(sim, silence, gap_ms)
    return attractor


def sram_loss(state, p: BCPNNParams):
    """Reset the volatile j-side state (zj/ej/pj vectors and the support
    membrane h) to its init values, keeping the synaptic ij planes and lazy
    i-vectors — the state after a power cycle in the paper's memory split:
    j-vectors live in (volatile) SRAM, the big planes in 3D DRAM.

    Recall from an `sram_loss` state is carried by the DRAM planes ALONE:
    without the reset, the trained pj bias can dominate the WTA support and
    recall survives arbitrary plane corruption — measuring nothing. The
    retention-fault experiment always applies this before corrupting the
    planes. Returns a new state (new j-side tensors, the rest shared)."""
    h = state.hcus
    return state._replace(hcus=h._replace(
        zj=torch.zeros_like(h.zj), ej=torch.zeros_like(h.ej),
        pj=torch.full_like(h.pj, p.p_init), h=torch.zeros_like(h.h)))


def recall_accuracy(sim, trained_state, patterns, attractor, *,
                    cue_fraction: float = 0.6, recall_ms: int = 12,
                    rng=None, corrupt=None) -> tuple[int, int]:
    """Partial-cue pattern completion score: (correct, total) over the
    undriven HCUs of every pattern.

    Each recall starts from a fresh copy of `trained_state` (a NetworkState
    of tensors on any device, e.g. a CPU snapshot) on the Simulator's
    device. `corrupt(state) -> state`, if given, is applied to that copy
    before the cue — the fault-injection hook. The result is copied into
    the Simulator's held tensors in place (`network.copy_into`), so the
    chunk graphs captured on them serve every recall.
    """
    p = sim.p
    rng = rng if rng is not None else np.random.default_rng(0)
    correct = total = 0
    for pid in range(len(patterns)):
        cue_mask = rng.random(p.n_hcu) < cue_fraction
        frame = drive_frame(p, patterns[pid], cue_mask, device=sim.device)
        state = N.tree_map(lambda a: torch.as_tensor(a).to(sim.device,
                                                            copy=True),
                           trained_state)
        if corrupt is not None:
            state = corrupt(state)
        N.copy_into(sim.state, state)
        del state
        winners = _present(sim, frame, recall_ms)
        probe = ~cue_mask & (winners >= 0) & (attractor[pid] >= 0)
        correct += int((winners[probe] == attractor[pid][probe]).sum())
        total += int(probe.sum())
    return correct, total
