"""Hyper Column Unit (HCU) state and the per-HCU pieces of the BCPNN tick
(the port of the parts of `repro.core.hcu` that the worklist tick runs).

State is structure-of-arrays; the field set is the paper's cell: Zij, Eij,
Pij, Wij, Tij. The j-vector is decayed every tick; the i-vector and the ij
planes are lazy (timestamped). The network holds the HCUs in the flat
layout (`repro_torch.core.layout`): ij planes (H*R, C), i-vectors (H*R,),
j-vectors and support (H, C). Functions here take batched tensors: a
leading H dimension stands for JAX's `vmap` over HCUs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.params import BCPNNParams
from repro_torch.core.traces import ZEP, bias, decay_zep, make_coeffs
from repro_torch.core import rng


class HCUState(NamedTuple):
    # synaptic ij-matrix planes
    zij: torch.Tensor
    eij: torch.Tensor
    pij: torch.Tensor
    wij: torch.Tensor
    tij: torch.Tensor      # int32 timestamps (ms)
    # presynaptic i-vector — lazy, timestamped
    zi: torch.Tensor
    ei: torch.Tensor
    pi: torch.Tensor
    ti: torch.Tensor       # int32
    # postsynaptic j-vector — always current
    zj: torch.Tensor
    ej: torch.Tensor
    pj: torch.Tensor
    # support membrane
    h: torch.Tensor


def coeffs_ij(p: BCPNNParams):
    return make_coeffs(p.tau_z_ij, p.tau_e, p.tau_p)


def coeffs_i(p: BCPNNParams):
    return make_coeffs(p.tau_zi, p.tau_e, p.tau_p)


def coeffs_j(p: BCPNNParams):
    return make_coeffs(p.tau_zj, p.tau_e, p.tau_p)


def init_hcu_batch(p: BCPNNParams, n_hcu: int, device) -> HCUState:
    """Network HCU batch in the flat layout: ij planes (H*R, C), i-vectors
    (H*R,), j-vectors/support (H, C). Every HCU starts identical; the one
    initial weight is computed with the same float32 ops as the JAX
    package's `init_hcu_state`."""
    R, C, HR = p.rows, p.cols, n_hcu * p.rows
    f32 = dict(dtype=torch.float32, device=device)
    pij0 = torch.full((1, 1), p.p_init * p.p_init, **f32)
    pi0 = torch.full((1, 1), p.p_init, **f32)
    w0 = torch.log((pij0 + p.eps**2) / ((pi0 + p.eps) * (pi0 + p.eps)))
    zeros2 = lambda dt: torch.zeros((HR, C), dtype=dt, device=device)
    zeros1 = lambda dt: torch.zeros((HR,), dtype=dt, device=device)
    return HCUState(
        zij=zeros2(torch.float32), eij=zeros2(torch.float32),
        pij=pij0.expand(HR, C).clone(), wij=w0.expand(HR, C).clone(),
        tij=zeros2(torch.int32),
        zi=zeros1(torch.float32), ei=zeros1(torch.float32),
        pi=pi0.reshape(1).expand(HR).clone(), ti=zeros1(torch.int32),
        zj=torch.zeros((n_hcu, C), **f32), ej=torch.zeros((n_hcu, C), **f32),
        pj=torch.full((n_hcu, C), p.p_init, **f32),
        h=torch.zeros((n_hcu, C), **f32),
    )


def dedup_rows(rows: torch.Tensor, n_rows: int):
    """Aggregate duplicate row indices in fixed-size spike slot arrays.

    rows: (..., A) int32, padding slots == n_rows. Per last-axis array,
    returns (unique_rows, counts): sorted, duplicates merged into their
    first occurrence (count = multiplicity); later duplicates and padding
    become n_rows with count 0. Segment bounds come from a forward cummax
    and a reverse cummin over the sorted slots, as in the JAX package.
    """
    A = rows.shape[-1]
    a, _ = torch.sort(rows, dim=-1)
    idx = torch.arange(A, device=rows.device).expand_as(a)
    brk = a[..., 1:] != a[..., :-1]
    edge = torch.ones_like(a[..., :1], dtype=torch.bool)
    first = torch.cat([edge, brk], dim=-1)
    last = torch.cat([brk, edge], dim=-1)
    start = torch.cummax(torch.where(first, idx, 0), dim=-1).values
    end = torch.cummin(torch.where(last, idx + 1, A).flip(-1),
                       dim=-1).values.flip(-1)
    counts = (end - start).to(torch.float32)
    keep = first & (a < n_rows)
    rows_u = torch.where(keep, a, n_rows).to(torch.int32)
    counts_u = torch.where(keep, counts, 0.0)
    return rows_u, counts_u


def ivec_decay(zi_g, ei_g, pi_g, ti_g, now, p: BCPNNParams) -> ZEP:
    """Lazy decay of gathered i-vector traces to `now`."""
    d_i = (now - ti_g).to(zi_g.dtype)
    return decay_zep(ZEP(zi_g, ei_g, pi_g), d_i, coeffs_i(p))


def periodic_math(h_vec, pj, w_rows, counts, key, p: BCPNNParams):
    """Support integration + soft WTA for a batch of HCUs.

    h_vec, pj (H, C); w_rows (H, A, C); counts (H, A); key (H, 2).
    Returns (h', fired_j (H,) int32), fired_j == -1 where the HCU stays
    silent. Same RNG stream as the JAX package's `periodic_math`.
    """
    # a zero-dimensional CPU tensor: applied to CUDA tensors as a scalar
    decay_m = torch.exp(torch.tensor(-p.dt_ms / p.tau_m, dtype=torch.float32))
    drive = torch.sum(counts[..., None] * w_rows, dim=-2)          # (H, C)
    h = h_vec * decay_m + drive
    s = h + bias(pj, p.eps)
    k = rng.split(key)
    fire = rng.uniform(k[..., 0, :]) < p.out_rate * p.dt_ms
    winner = rng.categorical(k[..., 1, :], s / p.wta_temp)
    fired_j = torch.where(fire, winner, -1).to(torch.int32)
    return h, fired_j


def flush(st: HCUState, now, p: BCPNNParams) -> HCUState:
    """Bring every lazy trace of a batched (H, R, C) state current to `now`
    (inspection and tests); returns new tensors."""
    kij, ki = coeffs_ij(p), coeffs_i(p)
    d_ij = (now - st.tij).to(st.zij.dtype)
    zep = decay_zep(ZEP(st.zij, st.eij, st.pij), d_ij, kij)
    d_i = (now - st.ti).to(st.zi.dtype)
    zi = decay_zep(ZEP(st.zi, st.ei, st.pi), d_i, ki)
    w = torch.log((zep.p + p.eps**2)
                  / ((zi.p[..., :, None] + p.eps) * (st.pj[..., None, :] + p.eps)))
    return st._replace(
        zij=zep.z, eij=zep.e, pij=zep.p, wij=w,
        tij=torch.zeros_like(st.tij) + now,
        zi=zi.z, ei=zi.e, pi=zi.p, ti=torch.zeros_like(st.ti) + now)
