"""Closed-form lazy evaluation of the BCPNN Z -> E -> P trace cascade.

The ODE system between spikes (paper Fig. 2):

    tau_z dZ/dt = -Z                 (Z decays exponentially)
    tau_e dE/dt =  Z - E
    tau_p dP/dt =  E - P

has the exact solution over a gap of ``dt`` (all in ms):

    ez = exp(-dt/tau_z), ee = exp(-dt/tau_e), ep = exp(-dt/tau_p)
    Z(dt) = Z0 * ez
    E(dt) = E0 * ee + Z0 * (ez - ee) * tau_z/(tau_z - tau_e)
    P(dt) = P0 * ep + (E0 - Z0*a) * (ee - ep) * tau_e/(tau_e - tau_p)
                    + Z0 * a * (ez - ep) * tau_z/(tau_z - tau_p)
    with a = tau_z/(tau_z - tau_e)

The operation order is that of `repro.core.traces`: the tests hold the two
against each other, and the CUDA kernels in `repro_torch.kernels.csrc`
repeat it cell by cell. Coefficients are Python floats; multiplying a
float32 tensor by one rounds it to float32 first, as JAX's weak typing does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class ZEP(NamedTuple):
    """A Z->E->P trace triplet (tensors broadcast together)."""
    z: torch.Tensor
    e: torch.Tensor
    p: torch.Tensor


class DecayCoeffs(NamedTuple):
    """Precomputed per-(tau_z,tau_e,tau_p) rational coefficients."""
    inv_tau_z: float
    inv_tau_e: float
    inv_tau_p: float
    c_ze: float   # tau_z / (tau_z - tau_e)
    c_ep: float   # tau_e / (tau_e - tau_p)
    c_zp: float   # tau_z / (tau_z - tau_p)


def make_coeffs(tau_z: float, tau_e: float, tau_p: float) -> DecayCoeffs:
    return DecayCoeffs(
        inv_tau_z=1.0 / tau_z,
        inv_tau_e=1.0 / tau_e,
        inv_tau_p=1.0 / tau_p,
        c_ze=tau_z / (tau_z - tau_e),
        c_ep=tau_e / (tau_e - tau_p),
        c_zp=tau_z / (tau_z - tau_p),
    )


def decay_zep(zep: ZEP, dt, k: DecayCoeffs, exp=torch.exp) -> ZEP:
    """Propagate a ZEP triplet across a silent gap of ``dt`` ms (closed form).

    ``dt`` is a float32 tensor broadcastable with the traces, or a Python
    number. A number becomes a float32 scalar on the CPU: torch applies a
    zero-dimensional CPU tensor to CUDA tensors as a scalar, so the decay
    factors are computed in float32 without a copy to the device.
    dt == 0 is the exact identity. ``exp`` computes the three decay
    factors (`exp_rounded` for merged mode's ring segments).
    """
    if not torch.is_tensor(dt):
        dt = torch.tensor(dt, dtype=torch.float32)
    ez = exp(-dt * k.inv_tau_z)
    ee = exp(-dt * k.inv_tau_e)
    ep = exp(-dt * k.inv_tau_p)
    z0, e0, p0 = zep
    e1 = e0 * ee + z0 * (ez - ee) * k.c_ze
    p1 = (p0 * ep
          + (e0 - z0 * k.c_ze) * (ee - ep) * k.c_ep
          + z0 * k.c_ze * (ez - ep) * k.c_zp)
    return ZEP(z0 * ez, e1, p1)


def exp_rounded(x: torch.Tensor) -> torch.Tensor:
    """exp of a float32 tensor computed in float64 and rounded once: the
    correctly rounded value but for rare near-ties, so the same bits on
    the CPU and on CUDA, whose float32 expf is up to 2 ulp off."""
    return torch.exp(x.double()).to(x.dtype)


def bayesian_weight(p_ij, p_i, p_j, eps: float):
    """w_ij = log( P_ij / (P_i * P_j) ), regularized (paper Fig. 1/2)."""
    return torch.log((p_ij + eps * eps) / ((p_i + eps) * (p_j + eps)))


def bias(p_j, eps: float):
    """b_j = log(P_j) — MCU prior activation."""
    return torch.log(p_j + eps)
