"""Plain-PyTorch oracle for the fused BCPNN lazy cell update (the port of
`repro.kernels.bcpnn_ref`).

One call performs, per synaptic cell:

  1. integrated lazy decay of the (Zij, Eij, Pij) cascade across the gap
     ``now - Tij`` (closed form, see repro_torch.core.traces),
  2. the Hebbian spike increment  Zij += dz,
  3. the Bayesian weight recompute  Wij = log(Pij / (Pi * Pj)),
  4. timestamp update Tij = now.

`cell_math` is the arithmetic in the exact operation order of
`repro.kernels.bcpnn_update._cell_math`; the CUDA kernels in
`csrc/bcpnn_update.cu` repeat it cell by cell, and the plain versions in
`bcpnn_update.py` call it. These functions are pure: they return new
tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core.traces import DecayCoeffs


def cell_math(z, e, p, dt, dz, p_pre, p_post, k: DecayCoeffs, eps: float):
    """Shared per-cell arithmetic; mirrors traces.decay_zep + bayesian_weight.
    Returns (z1, e1, p1, w1)."""
    ez = torch.exp(-dt * k.inv_tau_z)
    ee = torch.exp(-dt * k.inv_tau_e)
    ep_ = torch.exp(-dt * k.inv_tau_p)
    e1 = e * ee + z * (ez - ee) * k.c_ze
    p1 = (p * ep_
          + (e - z * k.c_ze) * (ee - ep_) * k.c_ep
          + z * k.c_ze * (ez - ep_) * k.c_zp)
    z1 = z * ez + dz
    w1 = torch.log((p1 + eps * eps) / ((p_pre + eps) * (p_post + eps)))
    return z1, e1, p1, w1


def cell_update_ref(zij, eij, pij, tij, now, dz, p_pre, p_post,
                    coeffs: DecayCoeffs, eps: float):
    """Fused lazy decay + Hebbian increment + Bayesian weight.

    zij/eij/pij float32 and tij int32 of one shape; ``now`` an int or an
    int32 tensor; dz, p_pre, p_post broadcastable. Returns
    (zij', eij', pij', wij', tij') with tij' = now everywhere.
    """
    dt = (now - tij).to(zij.dtype)
    z1, e1, p1, w1 = cell_math(zij, eij, pij, dt, dz, p_pre, p_post,
                               coeffs, eps)
    t1 = torch.zeros_like(tij) + now
    return z1, e1, p1, w1, t1


def row_update_ref(zij, eij, pij, tij, now, counts, zj, p_i, p_j,
                   coeffs: DecayCoeffs, eps: float):
    """Row update: blocks (..., S, C), rank-1 increment counts ⊗ zj.

    counts (..., S), zj (..., C), p_i (..., S), p_j (..., C); leading
    dimensions (one per HCU) batch the JAX package's per-HCU form.
    """
    dz = counts[..., :, None] * zj[..., None, :]
    return cell_update_ref(zij, eij, pij, tij, now, dz,
                           p_i[..., :, None], p_j[..., None, :], coeffs, eps)


def col_update_ref(zij, eij, pij, tij, now, zi_t, p_i, p_j_scalar,
                   coeffs: DecayCoeffs, eps: float):
    """Column update: full-rank increment zi_t and presynaptic p_i, both
    shaped like the column block; p_j_scalar is the fired MCU's P trace."""
    return cell_update_ref(zij, eij, pij, tij, now, zi_t,
                           p_i, p_j_scalar, coeffs, eps)
