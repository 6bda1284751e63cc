"""The BCPNN cell-update kernels of the lazy tick: the five Hopper kernels
(`csrc/bcpnn_update.cu`), their ctypes wrappers and their plain PyTorch
versions.

The worklist kernels (`fused_row_update`, `fused_col_update`,
`worklist_row_update`) rewrite the five (H*R, C) ij planes (and, for the
fused row phase, the four (H*R,) i-vectors) IN PLACE, where the JAX
package's kernels returned aliased new arrays. The block kernels
(`row_update`, `col_update`) take blocks the caller gathered from the
planes and return five new blocks, as the JAX kernels do. The plain
versions compute the same functions with vectorised torch ops (gather,
`bcpnn_ref.cell_math`, masked scatter); the CPU path and the tests use
them, and `chip_smoke.py` holds each kernel against its plain version on
the card.

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
from repro_torch.kernels.bcpnn_ref import (cell_math, col_update_ref,
                                            row_update_ref)

launches = {"fused_row_update": 0, "fused_col_update": 0,
            "worklist_row_update": 0, "row_update": 0, "col_update": 0}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_COEFFS = [ctypes.c_float] * 8
_ARGTYPES = {
    "bcpnn_fused_row_update": [_P] * 19 + [_I, _I, _LL] + _COEFFS + [_P],
    "bcpnn_fused_col_update": [_P] * 11 + [_I] * 4 + _COEFFS + [_P],
    "bcpnn_worklist_row_update": [_P] * 12 + [_I, _I, _LL] + _COEFFS + [_P],
    "bcpnn_row_update": [_P] * 14 + [_LL, _I, _I] + _COEFFS + [_P],
    "bcpnn_col_update": [_P] * 13 + [_LL, _I] + _COEFFS + [_P],
}


@functools.cache
def _lib():
    lib = _build.load("bcpnn_update")
    for name, argtypes in _ARGTYPES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
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


def _check_one(name, t, device):
    """An int32 one-element tensor that the kernel reads on the device."""
    if not torch.is_tensor(t) or t.numel() != 1:
        raise ValueError(f"{name}: expected a one-element tensor")
    _check(name, t, torch.int32, tuple(t.shape), device)


def _check_cuda(t):
    if not torch.is_tensor(t) or t.device.type != "cuda":
        where = t.device if torch.is_tensor(t) else type(t).__name__
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {where}")


def _check_planes(planes, ivecs=None):
    zij = planes[0]
    _check_cuda(zij)
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
    _check_one("now", now, dev)
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
    _check_one("now", now, dev)
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


# --------------------------------------------------------------------------
# unfused worklist row update
# --------------------------------------------------------------------------

def worklist_row_update_kernel(zij, eij, pij, wij, tij, rows, nv, now, counts,
                               zj, p_i, pj, coeffs: DecayCoeffs, eps: float):
    """The unfused worklist row update as one CUDA launch
    (`worklist_row_kernel`).

    Replaces `repro/kernels/bcpnn_update.py:worklist_update_kernel_call`
    (`_worklist_kernel`). The W entries are compacted valid-first: entry i
    is live when i < nv and rows[i] is a plane row, and then applies the
    cell math to that row with dz = counts[i]*zj[i], p_pre = p_i[i] and
    p_post = pj[i], and stamps Tij = now. Other entries write nothing,
    whatever their row holds. The i-vectors and the weight rows are the
    caller's.

    Bound on the H100: bytes. A live entry moves 11*C*4 bytes (reads z, e,
    p, t, zj, pj; writes z, e, p, w, t) for ~33 float32 ops per cell.
    Design: that of `fused_row_update_kernel` (one warp per entry walking
    its contiguous row, the same `row_walk` device function), with nv read
    on the device so the launch needs no host value; the TPU's junk row and
    per-call `_pad2` plane copies are gone.

    Planes (H*R, C) are rewritten in place. rows (W,) int32; nv and now
    int32 one-element tensors; counts / p_i (W,) and zj / pj (W, C)
    float32. Launches on the current stream and never synchronises.
    """
    planes = (zij, eij, pij, wij, tij)
    dev, (HR, C) = _check_planes(planes)
    W = rows.shape[0] if torch.is_tensor(rows) else -1
    _check("rows", rows, torch.int32, (W,), dev)
    _check_one("nv", nv, dev)
    _check_one("now", now, dev)
    _check("counts", counts, torch.float32, (W,), dev)
    _check("p_i", p_i, torch.float32, (W,), dev)
    _check("zj", zj, torch.float32, (W, C), dev)
    _check("pj", pj, torch.float32, (W, C), dev)
    if W == 0:
        return
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (*planes, rows, nv, now, counts, zj, p_i,
                                   pj)]
    rc = _lib().bcpnn_worklist_row_update(*ptrs, W, C, HR,
                                          *_coeff_args(coeffs, eps), stream)
    _raise_on(rc, "worklist_row_update")
    launches["worklist_row_update"] += 1


def worklist_row_update_plain(zij, eij, pij, wij, tij, rows, nv, now, counts,
                              zj, p_i, pj, coeffs: DecayCoeffs, eps: float):
    """Plain PyTorch version of `worklist_row_update_kernel` (same
    arguments, same in-place effect): gather the live entries' rows, run
    the cell math, scatter back."""
    HR = zij.shape[0]
    W = rows.shape[0]
    live = ((torch.arange(W, device=rows.device) < nv.reshape(()))
            & (rows >= 0) & (rows < HR))
    sel = torch.nonzero(live).squeeze(1)
    r = rows[sel].long()
    dt = (now - tij[r]).to(torch.float32)
    z1, e1, p1, w1 = cell_math(zij[r], eij[r], pij[r], dt,
                               counts[sel, None] * zj[sel], p_i[sel, None],
                               pj[sel], coeffs, eps)
    zij[r], eij[r], pij[r], wij[r] = z1, e1, p1, w1
    tij[r] = now.to(tij.dtype).reshape(())


# --------------------------------------------------------------------------
# gathered row and column blocks (the dense backend, the unfused columns)
# --------------------------------------------------------------------------

def _block_call(name, blocks, now, vecs, dims):
    """Launch one block kernel on the (z, e, p, t) blocks; returns the five
    new output blocks."""
    dev = blocks[0].device
    outs = tuple(torch.empty_like(b) for b in (*blocks[:3], blocks[0],
                                               blocks[3]))
    if blocks[0].numel() == 0:
        return outs
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (*blocks, *outs, now, *vecs)]
    rc = getattr(_lib(), f"bcpnn_{name}")(*ptrs, *dims, stream)
    _raise_on(rc, name)
    launches[name] += 1
    return outs


def _check_blocks(zij, eij, pij, tij):
    _check_cuda(zij)
    dev, shape = zij.device, tuple(zij.shape)
    for nm, t in (("zij", zij), ("eij", eij), ("pij", pij)):
        _check(nm, t, torch.float32, shape, dev)
    _check("tij", tij, torch.int32, shape, dev)
    return dev, shape


def row_update_kernel(zij, eij, pij, tij, now, counts, zj, p_i, pj,
                      coeffs: DecayCoeffs, eps: float):
    """The dense row update as one CUDA launch (`row_block_kernel`),
    batched over HCUs.

    Replaces `repro/kernels/bcpnn_update.py:row_update_kernel_call`
    (`_row_kernel`), which the JAX package calls once per HCU under `vmap`.
    On the (H, A, C) blocks gathered from the planes, cell (h, a, c) gets
    dz = counts[h, a]*zj[h, c], p_pre = p_i[h, a] and p_post = pj[h, c].
    Every slot is computed, padding included. Returns new blocks
    (z', e', p', w', t'), t' = now; the inputs are not written. The weight
    plane is never read (JAX passes it only to alias it), so it is not an
    argument.

    Bound on the H100: bytes, 9*4 per cell (reads z, e, p, t; writes z, e,
    p, w, t; counts, zj, p_i and pj are small and cached) for ~33 float32
    ops. Design: one thread per cell over the contiguous blocks, so every
    access is coalesced; the TPU's (8, 128) tiles and `_pad2`/`_pad1`
    copies are gone.

    zij / eij / pij (H, A, C) float32 and tij int32; now an int32
    one-element tensor; counts / p_i (H, A) and zj / pj (H, C) float32,
    all contiguous on one CUDA device. Launches on the current stream and
    never synchronises.
    """
    dev, (n, A, C) = _check_blocks(zij, eij, pij, tij)
    _check_one("now", now, dev)
    _check("counts", counts, torch.float32, (n, A), dev)
    _check("p_i", p_i, torch.float32, (n, A), dev)
    _check("zj", zj, torch.float32, (n, C), dev)
    _check("pj", pj, torch.float32, (n, C), dev)
    return _block_call("row_update", (zij, eij, pij, tij), now,
                       (counts, zj, p_i, pj), (n * A, A, C)
                       + _coeff_args(coeffs, eps))


def row_update_plain(zij, eij, pij, tij, now, counts, zj, p_i, pj,
                     coeffs: DecayCoeffs, eps: float):
    """Plain PyTorch version of `row_update_kernel` (same arguments, same
    results): the cell oracle on the whole blocks."""
    return row_update_ref(zij, eij, pij, tij, now.reshape(()), counts, zj,
                          p_i, pj, coeffs, eps)


def col_update_kernel(zij, eij, pij, tij, now, zi_t, p_i, pj_sc,
                      coeffs: DecayCoeffs, eps: float):
    """The column update as one CUDA launch (`col_block_kernel`), batched
    over the fired batch.

    Replaces `repro/kernels/bcpnn_update.py:col_update_kernel_call`
    (`_col_kernel`), which the JAX package calls once per fired-batch entry
    under `vmap`. On the (K, R) columns gathered from the planes, cell
    (k, r) gets dz = zi_t[k, r], p_pre = p_i[k, r] and p_post = pj_sc[k].
    Every entry is computed, padding included. Returns new blocks
    (z', e', p', w', t'), t' = now; the weight plane is never read and not
    an argument.

    Bound on the H100: bytes, 11*4 per cell (reads z, e, p, t, zi_t, p_i;
    writes z, e, p, w, t) for ~33 float32 ops. Design: one thread per cell
    of the contiguous (K, R) blocks; the TPU's (R/128, 128) lane reshape
    and padding copies are gone. The strided access of a column (cells C*4
    bytes apart in the planes) is paid by the caller's gather and scatter,
    not here.

    zij / eij / pij (K, R) float32 and tij int32; now an int32 one-element
    tensor; zi_t / p_i (K, R) and pj_sc (K,) float32. Launches on the
    current stream and never synchronises.
    """
    dev, (K, R) = _check_blocks(zij, eij, pij, tij)
    _check_one("now", now, dev)
    _check("zi_t", zi_t, torch.float32, (K, R), dev)
    _check("p_i", p_i, torch.float32, (K, R), dev)
    _check("pj_sc", pj_sc, torch.float32, (K,), dev)
    return _block_call("col_update", (zij, eij, pij, tij), now,
                       (zi_t, p_i, pj_sc), (K, R) + _coeff_args(coeffs, eps))


def col_update_plain(zij, eij, pij, tij, now, zi_t, p_i, pj_sc,
                     coeffs: DecayCoeffs, eps: float):
    """Plain PyTorch version of `col_update_kernel` (same arguments, same
    results): the cell oracle on the whole blocks."""
    return col_update_ref(zij, eij, pij, tij, now.reshape(()), zi_t, p_i,
                          pj_sc[:, None], coeffs, eps)
