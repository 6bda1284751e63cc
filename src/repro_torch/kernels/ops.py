"""Device dispatch for the BCPNN update kernels (the port of
`repro.kernels.ops`).

The tensors' device decides, and nothing else: planes on the CPU take the
plain PyTorch version (the caller asked for the CPU); planes anywhere else
go to the CUDA kernel, which launches or raises. There is no switch and no
fallback from the kernel to the plain version.

Unlike the JAX wrappers, these pad nothing and copy no plane: the kernels
take the unpadded (H*R, C) planes and rewrite them in place.
"""
from __future__ import annotations

import torch

from repro_torch.core.traces import DecayCoeffs
from repro_torch.kernels import bcpnn_update as BU


def _now(now, device):
    if torch.is_tensor(now):
        return now.to(device=device, dtype=torch.int32)
    return torch.tensor(now, dtype=torch.int32, device=device)


def fused_row_update(zij, eij, pij, wij, tij, zi, ei, pi, ti, rows, now,
                     counts, zj, p_i, pj, zi_new, ei_new, pi_new,
                     coeffs: DecayCoeffs, eps: float):
    """Fused worklist row phase over the flat planes.

    rows (W,) int32: SLOT-ordered flat row indices, with the H*R sentinel
    on padding and duplicate slots. counts / p_i / zi_new / ei_new / pi_new
    (W,), zj / pj (W, C): per-slot operands. ``now`` is an int or an int32
    tensor. The five ij planes and four i-vectors are rewritten in place;
    returns the (W, C) weight rows (zero on sentinel slots) for the WTA.
    """
    fn = (BU.fused_row_update_plain if zij.device.type == "cpu"
          else BU.fused_row_update_kernel)
    return fn(zij, eij, pij, wij, tij, zi, ei, pi, ti, rows,
              _now(now, zij.device), counts, zj, p_i, pj, zi_new, ei_new,
              pi_new, coeffs, eps)


def fused_col_update(zij, eij, pij, wij, tij, h_idx, j_idx, now, zi_t, p_i,
                     pj_sc, coeffs: DecayCoeffs, eps: float, n_hcu: int,
                     rows: int):
    """Fused worklist column phase over the flat planes.

    h_idx / j_idx (K,) int32: the compacted fired batch of
    `network.select_fired` (padding entries carry h_idx == n_hcu). zi_t /
    p_i (K, rows): per-entry presynaptic traces at ``now``; pj_sc (K,):
    per-entry postsynaptic P. The five ij planes are rewritten in place.
    """
    fn = (BU.fused_col_update_plain if zij.device.type == "cpu"
          else BU.fused_col_update_kernel)
    fn(zij, eij, pij, wij, tij, h_idx, j_idx, _now(now, zij.device), zi_t,
       p_i, pj_sc, coeffs, eps, n_hcu, rows)
