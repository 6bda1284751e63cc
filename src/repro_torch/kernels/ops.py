"""Device dispatch for the port's kernels (the port of `repro.kernels.ops`):
the BCPNN update kernels and flash attention.

The tensors' device decides, and nothing else: planes on the CPU take the
plain PyTorch version (the caller asked for the CPU); planes anywhere else
go to the CUDA kernel, which launches or raises. There is no switch and no
fallback from the kernel to the plain version.

Unlike the JAX wrappers, these pad nothing and copy no plane: the
worklist kernels take the planes as they are stored (flat (H*R, C) or
column-blocked tiles, `repro_torch.core.layout`) and rewrite them in
place, and the block kernels take the gathered blocks as they are (no
junk rows, no (R/128, 128) reshape). The block entries are batched: one
call covers every HCU (`row_update`) or every fired-batch entry
(`col_update`) where the JAX package vmaps a per-HCU call.
"""
from __future__ import annotations

import torch

from repro_torch.core.traces import DecayCoeffs
from repro_torch.kernels import bcpnn_update as BU
from repro_torch.kernels import flash_attention as FA


def _now(now, device):
    if torch.is_tensor(now):
        return now.to(device=device, dtype=torch.int32)
    return torch.tensor(now, dtype=torch.int32, device=device)


def _dispatch(plain, kernel, device):
    return plain if device.type == "cpu" else kernel


def fused_row_update(zij, eij, pij, wij, tij, zi, ei, pi, ti, rows, now,
                     counts, zj, p_i, pj, zi_new, ei_new, pi_new,
                     coeffs: DecayCoeffs, eps: float, layout=None):
    """Fused worklist row phase over the stored planes.

    rows (W,) int32: SLOT-ordered global flat row indices, A = W / H slots
    per HCU, with the H*R sentinel on padding and duplicate slots.
    counts / p_i / zi_new / ei_new / pi_new (W,): per-slot operands; zj / pj
    (H, C): the j-vectors, read at HCU slot // A. ``now`` is an int or an
    int32 tensor; ``layout`` the planes' stored layout (None: flat). The
    five ij planes and four i-vectors are rewritten in place; returns the
    (W, C) weight rows (zero on sentinel slots) for the WTA.
    """
    fn = _dispatch(BU.fused_row_update_plain, BU.fused_row_update_kernel,
                   zij.device)
    return fn(zij, eij, pij, wij, tij, zi, ei, pi, ti, rows,
              _now(now, zij.device), counts, zj, p_i, pj, zi_new, ei_new,
              pi_new, coeffs, eps, layout=layout)


def fused_col_update(zij, eij, pij, wij, tij, zi, ei, pi, ti, pj, h_idx,
                     j_idx, now, coeffs: DecayCoeffs, coeffs_i: DecayCoeffs,
                     eps: float, n_hcu: int, rows: int, layout=None):
    """Fused worklist column phase over the stored planes.

    h_idx / j_idx (K,) int32: the compacted fired batch of
    `network.select_fired` (padding entries carry h_idx == n_hcu). zi / ei
    / pi / ti (H*rows,): the i-vectors as they stand, brought to ``now``
    inside (``coeffs_i``, not written back); pj (H, C): the j-vector P.
    The five ij planes (stored in ``layout``, None: flat) are rewritten in
    place.
    """
    fn = _dispatch(BU.fused_col_update_plain, BU.fused_col_update_kernel,
                   zij.device)
    fn(zij, eij, pij, wij, tij, zi, ei, pi, ti, pj, h_idx, j_idx,
       _now(now, zij.device), coeffs, coeffs_i, eps, n_hcu, rows,
       layout=layout)


def worklist_row_update(zij, eij, pij, wij, tij, g_row, order, nv, now,
                        counts, zj, p_i, pj, coeffs: DecayCoeffs, eps: float,
                        layout=None):
    """Unfused worklist row update over the stored planes, read through
    the compaction.

    g_row (W,) int32: SLOT-ordered global flat row indices, A = W / H
    slots per HCU, the H*R sentinel on padding slots; order (W,) int32:
    the compaction, valid slots first (`worklist.build_worklist`); entries
    at or past ``nv`` (an int32 tensor) are ignored whatever ``order``
    holds there. counts / p_i (W,): per-slot operands; zj / pj (H, C): the
    j-vectors, read at HCU slot // A. The five ij planes (stored in
    ``layout``, None: flat) are rewritten in place; the i-vectors are the
    caller's.
    """
    fn = _dispatch(BU.worklist_row_update_plain,
                   BU.worklist_row_update_kernel, zij.device)
    fn(zij, eij, pij, wij, tij, g_row, order, nv.reshape(1).to(torch.int32),
       _now(now, zij.device), counts, zj, p_i, pj, coeffs, eps,
       layout=layout)


def row_update(zij, eij, pij, tij, now, counts, zj, p_i, pj,
               coeffs: DecayCoeffs, eps: float):
    """Fused lazy row update on gathered row blocks, batched over HCUs.

    zij / eij / pij / tij (H, A, C); counts / p_i (H, A); zj / pj (H, C).
    Returns new (zij', eij', pij', wij', tij') blocks.
    """
    fn = _dispatch(BU.row_update_plain, BU.row_update_kernel, zij.device)
    return fn(zij, eij, pij, tij, _now(now, zij.device), counts, zj, p_i, pj,
              coeffs, eps)


def col_update(zij, eij, pij, tij, now, zi_t, p_i, pj_sc,
               coeffs: DecayCoeffs, eps: float):
    """Fused lazy column update on gathered columns, batched over the fired
    batch.

    zij / eij / pij / tij / zi_t / p_i (K, R); pj_sc (K,). Returns new
    (zij', eij', pij', wij', tij') blocks.
    """
    fn = _dispatch(BU.col_update_plain, BU.col_update_kernel, zij.device)
    return fn(zij, eij, pij, tij, _now(now, zij.device), zi_t, p_i, pj_sc,
              coeffs, eps)


def flash_attention(q, k, v, *, scale: float, causal: bool = True,
                    window=None, softcap=None, kv_len=None):
    """Forward attention on the model's layout: q (B, Sq, H, hd), k / v
    (B, Skv, Kv, hd) with H % Kv == 0 (query head h reads kv head
    h // (H // Kv)) -> o (B, Sq, H, hd) in q's dtype. Each input may be a
    strided view with a contiguous last dim, so a KV cache (B, max_len, Kv,
    hd) goes in as it lies, with ``kv_len`` (a Python int, default Skv)
    bounding its valid keys; Sq and Skv multiples of 128. The JAX-shaped
    call, (BH, S, hd) tensors, is the case H = Kv = 1. A DTensor (a
    sharded prefill, which is not ported) raises: neither the kernel nor its
    plain version takes one."""
    from torch.distributed.tensor import DTensor
    for name, t in (("q", q), ("k", k), ("v", v)):
        if isinstance(t, DTensor):
            raise TypeError(f"flash_attention: {name} is a DTensor; the "
                            "kernel takes the local tensors of one rank")
    fn = _dispatch(FA.flash_attention_plain, FA.flash_attention_kernel,
                   q.device)
    return fn(q, k, v, scale=scale, causal=causal, window=window,
              softcap=softcap, kv_len=kv_len)
