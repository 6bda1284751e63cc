"""The worklist row and column phases of the lazy BCPNN tick: the two
Hopper kernels (`csrc/bcpnn_update.cu`), their ctypes wrappers and their
plain PyTorch versions.

Every function here rewrites the five (H*R, C) ij planes (and, for the row
phase, the four (H*R,) i-vectors) IN PLACE, where the JAX package's
kernels returned aliased new arrays. The plain versions compute the same
function with vectorised torch ops (gather, `bcpnn_ref.cell_math`, masked
scatter); the CPU path and the tests use them, and `chip_smoke.py` holds
each kernel against its plain version on the card.

Each wrapper counts its launches in `launches[name]`: one per kernel
launch, nowhere else, so a run can show that its main path went through
the kernels.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.traces import DecayCoeffs
from repro_torch.kernels import _build
from repro_torch.kernels.bcpnn_ref import cell_math

launches = {"fused_row_update": 0, "fused_col_update": 0}

_P = ctypes.c_void_p
_ROW_ARGTYPES = [_P] * 19 + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong] \
    + [ctypes.c_float] * 8 + [_P]
_COL_ARGTYPES = [_P] * 11 + [ctypes.c_int] * 4 + [ctypes.c_float] * 8 + [_P]


@functools.cache
def _lib():
    lib = _build.load("bcpnn_update")
    lib.bcpnn_fused_row_update.argtypes = _ROW_ARGTYPES
    lib.bcpnn_fused_row_update.restype = ctypes.c_int
    lib.bcpnn_fused_col_update.argtypes = _COL_ARGTYPES
    lib.bcpnn_fused_col_update.restype = ctypes.c_int
    return lib


def _check(name, t, dtype, shape, device):
    if not torch.is_tensor(t):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_planes(planes, ivecs=None):
    zij = planes[0]
    if zij.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {zij.device}")
    if zij.dim() != 2:
        raise ValueError(f"planes must be (H*R, C), got {tuple(zij.shape)}")
    dev, shape = zij.device, tuple(zij.shape)
    for nm, t in zip(("zij", "eij", "pij", "wij"), planes[:4]):
        _check(nm, t, torch.float32, shape, dev)
    _check("tij", planes[4], torch.int32, shape, dev)
    if ivecs is not None:
        for nm, t in zip(("zi", "ei", "pi"), ivecs[:3]):
            _check(nm, t, torch.float32, shape[:1], dev)
        _check("ti", ivecs[3], torch.int32, shape[:1], dev)
    return dev, shape


def _coeff_args(k: DecayCoeffs, eps: float):
    return (k.inv_tau_z, k.inv_tau_e, k.inv_tau_p, k.c_ze, k.c_ep, k.c_zp,
            eps, eps * eps)


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")


# --------------------------------------------------------------------------
# row phase
# --------------------------------------------------------------------------

def fused_row_update_kernel(zij, eij, pij, wij, tij, zi, ei, pi, ti, rows,
                            now, counts, zj, p_i, pj, zi_new, ei_new, pi_new,
                            coeffs: DecayCoeffs, eps: float):
    """The worklist row phase as one CUDA launch (`fused_row_kernel`).

    Replaces `repro/kernels/bcpnn_update.py:fused_row_update_kernel_call`
    (`_fused_row_kernel`). For each of the W slot-ordered entries it applies
    the cell math to the plane row ``rows[s]`` with dz = counts[s]*zj[s],
    p_pre = p_i[s] and p_post = pj[s], stamps Tij = now, writes
    zi/ei/pi_new[s] into the i-vectors, stamps ti = now, and emits the
    weight row into the returned (W, C) buffer. Sentinel slots
    (rows[s] >= H*R) write nothing but a zero weight row.

    Bound on the H100: bytes. A valid slot moves 12*C*4 bytes (reads z, e,
    p, t, zj, pj; writes z, e, p, w, t, wrow) for ~33 float32 ops (4
    transcendentals among them) per cell. Design: one
    warp per slot walking its contiguous C-cell row, so every plane access
    is coalesced and a row is read and written exactly once; the TPU's
    (8, 128) tiles, junk row and per-call `_pad2` copies of the planes are
    gone (masking is a bounds check on the row index).

    Planes (H*R, C) and i-vectors (H*R,) are rewritten in place. rows (W,)
    int32, now an int32 one-element tensor (read on the device), counts /
    p_i / *_new (W,) and zj / pj (W, C) float32, all contiguous on one CUDA
    device. Launches on the current stream and never synchronises.
    """
    planes, ivecs = (zij, eij, pij, wij, tij), (zi, ei, pi, ti)
    dev, (HR, C) = _check_planes(planes, ivecs)
    W = rows.shape[0] if torch.is_tensor(rows) else -1
    _check("rows", rows, torch.int32, (W,), dev)
    _check("now", now, torch.int32, tuple(now.shape), dev)
    if now.numel() != 1:
        raise ValueError("now: expected one element")
    for nm, t in (("counts", counts), ("p_i", p_i), ("zi_new", zi_new),
                  ("ei_new", ei_new), ("pi_new", pi_new)):
        _check(nm, t, torch.float32, (W,), dev)
    _check("zj", zj, torch.float32, (W, C), dev)
    _check("pj", pj, torch.float32, (W, C), dev)
    wrow = torch.empty((W, C), dtype=torch.float32, device=dev)
    if W == 0:
        return wrow
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (*planes, *ivecs, rows, now, counts, zj,
                                   p_i, pj, zi_new, ei_new, pi_new, wrow)]
    rc = _lib().bcpnn_fused_row_update(*ptrs, W, C, HR,
                                       *_coeff_args(coeffs, eps), stream)
    _raise_on(rc, "fused_row_update")
    launches["fused_row_update"] += 1
    return wrow


def fused_row_update_plain(zij, eij, pij, wij, tij, zi, ei, pi, ti, rows,
                           now, counts, zj, p_i, pj, zi_new, ei_new, pi_new,
                           coeffs: DecayCoeffs, eps: float):
    """Plain PyTorch version of `fused_row_update_kernel` (same arguments,
    same in-place effect, same returned weight rows): gather the valid
    slots' rows, run the cell math, scatter back."""
    HR, C = zij.shape
    sel = torch.nonzero((rows >= 0) & (rows < HR)).squeeze(1)
    r = rows[sel].long()
    dt = (now - tij[r]).to(torch.float32)
    z1, e1, p1, w1 = cell_math(zij[r], eij[r], pij[r], dt,
                               counts[sel, None] * zj[sel], p_i[sel, None],
                               pj[sel], coeffs, eps)
    zij[r], eij[r], pij[r], wij[r] = z1, e1, p1, w1
    tij[r] = now.to(tij.dtype).reshape(())
    zi[r], ei[r], pi[r] = zi_new[sel], ei_new[sel], pi_new[sel]
    ti[r] = now.to(ti.dtype).reshape(())
    wrow = torch.zeros((rows.shape[0], C), dtype=torch.float32,
                       device=zij.device)
    wrow[sel] = w1
    return wrow


# --------------------------------------------------------------------------
# column phase
# --------------------------------------------------------------------------

def fused_col_update_kernel(zij, eij, pij, wij, tij, h_idx, j_idx, now, zi_t,
                            p_i, pj_sc, coeffs: DecayCoeffs, eps: float,
                            n_hcu: int, rows: int):
    """The worklist column phase as one CUDA launch (`fused_col_kernel`).

    Replaces `repro/kernels/bcpnn_update.py:fused_col_update_kernel_call`
    (`_fused_col_kernel`). For each fired entry e with h_idx[e] < n_hcu it
    updates the ``rows`` cells of column j_idx[e] in HCU h_idx[e] with
    dz = zi_t[e, r], p_pre = p_i[e, r] and p_post = pj_sc[e], and stamps
    Tij = now. Padding entries (h_idx == n_hcu) return at once.

    Bound on the H100: bytes, and worse than the cell count says: the R
    cells of a column lie C*4 bytes apart, so each of the 9 plane accesses
    per cell (read z, e, p, t; write z, e, p, w, t) moves a whole 32-byte
    sector for 4 useful bytes. Design: a (row-block, entry) grid with one
    thread per cell and plain bounds checks, on the unpadded planes; the
    TPU's lane tiles, iota lane masks, junk row-block, per-call padded plane
    copies, transposed lane-padded trace buffers and the K <= 128 limit are
    gone. The strided access is accepted in this version; its cost against
    the bound is in PERF.md (the column-blocked layout is the known fix).

    Planes (H*R, C) are rewritten in place. h_idx, j_idx (K,) int32; now an
    int32 one-element tensor; zi_t, p_i (K, rows) and pj_sc (K,) float32.
    Launches on the current stream and never synchronises.
    """
    planes = (zij, eij, pij, wij, tij)
    dev, (HR, C) = _check_planes(planes)
    if HR != n_hcu * rows:
        raise ValueError(f"planes hold {HR} rows, expected {n_hcu}*{rows}")
    K = h_idx.shape[0] if torch.is_tensor(h_idx) else -1
    _check("h_idx", h_idx, torch.int32, (K,), dev)
    _check("j_idx", j_idx, torch.int32, (K,), dev)
    _check("now", now, torch.int32, tuple(now.shape), dev)
    if now.numel() != 1:
        raise ValueError("now: expected one element")
    _check("zi_t", zi_t, torch.float32, (K, rows), dev)
    _check("p_i", p_i, torch.float32, (K, rows), dev)
    _check("pj_sc", pj_sc, torch.float32, (K,), dev)
    if K == 0 or rows == 0:
        return
    if K > 65535:
        raise ValueError(f"fired batch of {K} exceeds the grid's y limit")
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (*planes, h_idx, j_idx, now, zi_t, p_i,
                                   pj_sc)]
    rc = _lib().bcpnn_fused_col_update(*ptrs, K, rows, C, n_hcu,
                                       *_coeff_args(coeffs, eps), stream)
    _raise_on(rc, "fused_col_update")
    launches["fused_col_update"] += 1


def fused_col_update_plain(zij, eij, pij, wij, tij, h_idx, j_idx, now, zi_t,
                           p_i, pj_sc, coeffs: DecayCoeffs, eps: float,
                           n_hcu: int, rows: int):
    """Plain PyTorch version of `fused_col_update_kernel` (same arguments,
    same in-place effect): gather the valid entries' columns, run the cell
    math, scatter back."""
    C = zij.shape[1]
    ok = (h_idx >= 0) & (h_idx < n_hcu) & (j_idx >= 0) & (j_idx < C)
    sel = torch.nonzero(ok).squeeze(1)
    r_ix = h_idx[sel].long()[:, None] * rows \
        + torch.arange(rows, device=zij.device)[None, :]
    c_ix = j_idx[sel].long()[:, None].expand(-1, rows)
    dt = (now - tij[r_ix, c_ix]).to(torch.float32)
    z1, e1, p1, w1 = cell_math(zij[r_ix, c_ix], eij[r_ix, c_ix],
                               pij[r_ix, c_ix], dt, zi_t[sel], p_i[sel],
                               pj_sc[sel, None], coeffs, eps)
    zij[r_ix, c_ix], eij[r_ix, c_ix] = z1, e1
    pij[r_ix, c_ix], wij[r_ix, c_ix] = p1, w1
    tij[r_ix, c_ix] = now.to(tij.dtype).reshape(())
