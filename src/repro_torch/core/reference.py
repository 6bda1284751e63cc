"""Eager dense BCPNN reference — the golden model (the port of
`repro.core.reference`).

Every tick, every trace of the (R, C) matrix is decayed and every weight
recomputed: no lazy evaluation, no timestamps. Eager and lazy paths use the
same exponential integrator per gap, so the lazy system must match this
reference up to float rounding (tests/test_torch_engine.py holds the two
together, as tests/test_lazy_vs_eager.py does for the JAX package).

It runs on whole planes with plain torch ops and has no kernel; the drive
is a plain batched matrix product (`torch.matmul`, which runs in full
float32 unless TF32 is switched on for matmuls).
"""
from __future__ import annotations

import torch

from repro_torch.core import hcu as H
from repro_torch.core.params import BCPNNParams
from repro_torch.core.traces import ZEP, decay_zep


def eager_tick(st: H.HCUState, rows, now, key, p: BCPNNParams):
    """One dense 1 ms tick of every HCU of the batched (H, R, C) state,
    with semantics identical to the lazy pipeline. Returns (st' (new
    tensors), fired_j (H,) int32)."""
    n = rows.shape[0]
    R = p.rows
    # 1. j-vector decay (identical to lazy)
    st = H._decay_jvec(st, p)

    # 2. dense decay of ALL ij cells and the whole i-vector by dt
    zep_ij = decay_zep(ZEP(st.zij, st.eij, st.pij), p.dt_ms, H.coeffs_ij(p))
    zep_i = decay_zep(ZEP(st.zi, st.ei, st.pi), p.dt_ms, H.coeffs_i(p))

    # 3. row spike increments (duplicates aggregate, same as dedup_rows);
    #    padding rows (== R) land in a spare column that is cut off
    rows_u, counts = H.dedup_rows(rows, R)
    spike_vec = torch.zeros((n, R + 1), dtype=st.zi.dtype, device=rows.device)
    spike_vec = spike_vec.scatter_add_(1, rows_u.long(), counts)[:, :R]
    zi = zep_i.z + spike_vec
    zij = zep_ij.z + spike_vec[..., None] * st.zj[:, None, :]

    # 4. dense Bayesian weight recompute
    wij = torch.log((zep_ij.p + p.eps**2)
                    / ((zep_i.p[..., None] + p.eps) * (st.pj[:, None, :] + p.eps)))

    # 5. periodic support + WTA (same RNG stream as lazy)
    drive = torch.matmul(spike_vec[:, None, :], wij)[:, 0, :]     # (H, C)
    h, fired_j = H.wta(st.h, st.pj, drive, key, p)

    # 6. column update for the fired MCU (dense state: only Z jumps; E/P/W
    #    were already brought current by the dense decay above)
    active = fired_j >= 0
    safe_j = torch.clamp(fired_j, min=0)
    onehot = (torch.arange(p.cols, device=rows.device)[None, :]
              == safe_j[:, None]) & active[:, None]                # (H, C)
    zij = zij + torch.where(onehot[:, None, :], zi[..., None], 0.0)
    st = st._replace(zij=zij, eij=zep_ij.e, pij=zep_ij.p, wij=wij,
                     tij=torch.zeros_like(st.tij) + now,
                     zi=zi, ei=zep_i.e, pi=zep_i.p,
                     ti=torch.zeros_like(st.ti) + now,
                     zj=st.zj + onehot.to(st.zj.dtype), h=h)
    return st, fired_j
