"""The BCPNN cell-update kernels of the lazy tick: the five Hopper kernels
(`csrc/bcpnn_update.cu`), their ctypes wrappers and their plain PyTorch
versions.

The worklist kernels (`fused_row_update`, `fused_col_update`,
`worklist_row_update`) rewrite the five ij planes (and, for the fused row
phase, the four (H*R,) i-vectors) IN PLACE, where the JAX package's kernels
returned aliased new arrays. They take the planes in the layout they are
stored in (`repro_torch.core.layout`): flat (H*R, C) (``layout=None``) or
column-blocked (H*Tr, Tc, xr, xc) tiles (a `BlockedLayout`), and address
logical cell (h, r, j) at the layout's `cell_index`; pad cells are never
touched. The block kernels (`row_update`, `col_update`) take blocks the
caller gathered from the planes and return five new blocks, as the JAX
kernels do. The plain versions compute the same functions with vectorised
torch ops (the layout's index maps, `bcpnn_ref.cell_math`, scatter); the
CPU path and the tests use them, and `chip_smoke.py` holds each kernel
against its plain version on the card.

Each wrapper counts its launches in `launches[name]`: one per kernel
launch, nowhere else, so a run can show that its main path went through
the kernels.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import layout as L
from repro_torch.core.traces import ZEP, DecayCoeffs, decay_zep
from repro_torch.kernels import _build
from repro_torch.kernels.bcpnn_ref import (cell_math, col_update_ref,
                                            row_update_ref)

launches = {"fused_row_update": 0, "fused_col_update": 0,
            "worklist_row_update": 0, "row_update": 0, "col_update": 0}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_COEFFS = [_F] * 8
_TILING = [_I] * 6                       # R, C, xr, xc, Tr, Tc
_ARGTYPES = {
    "bcpnn_fused_row_update": [_P] * 19 + [_I, _I, _LL] + _TILING + [_I]
    + _COEFFS + [_P],
    "bcpnn_fused_col_update": [_P] * 13 + [_I, _I] + _TILING + _COEFFS
    + [_F] * 6 + [_P],
    "bcpnn_worklist_row_update": [_P] * 13 + [_I, _I, _LL] + _TILING + [_I]
    + _COEFFS + [_P],
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


def _geometry(zij, layout, rows: int | None = None):
    """The tile geometry of stored planes and their number of HCUs.

    Flat planes (``layout`` None or a FlatLayout) are (H*R, C), and their
    geometry is `layout.FlatLayout`, the tile (1, C); where ``rows`` (R) is
    not given, they are read as one HCU of H*R rows, which addresses the
    same cells. Blocked planes must have the layout's `plane_shape`."""
    lay = L.as_blocked(layout)
    if lay is None:
        if zij.dim() != 2:
            raise ValueError(f"flat planes must be (H*R, C), got "
                             f"{tuple(zij.shape)}")
        HR, C = zij.shape
        R = rows or HR
        if R <= 0 or HR % R:
            raise ValueError(f"flat planes of {HR} rows, not HCUs of {R}")
        return L.FlatLayout(R, C), HR // R
    if zij.dim() != 4 or tuple(zij.shape[1:]) != lay.plane_shape(1)[1:] \
            or zij.shape[0] % lay.row_tiles_n:
        raise ValueError(f"planes of shape {tuple(zij.shape)} are not stored "
                         f"in {lay}")
    if rows is not None and rows != lay.rows:
        raise ValueError(f"rows={rows}, the layout has {lay.rows}")
    return lay, zij.shape[0] // lay.row_tiles_n


def _check_planes(planes, layout, rows=None, ivecs=None):
    """Checks the five stored planes (and the four i-vectors); returns
    (device, geometry, number of HCUs)."""
    zij = planes[0]
    _check_cuda(zij)
    geom, n = _geometry(zij, layout, rows)
    dev, shape = zij.device, tuple(zij.shape)
    for nm, t in zip(("zij", "eij", "pij", "wij"), planes[:4]):
        _check(nm, t, torch.float32, shape, dev)
    _check("tij", planes[4], torch.int32, shape, dev)
    if ivecs is not None:
        HR = (n * geom.rows,)
        for nm, t in zip(("zi", "ei", "pi"), ivecs[:3]):
            _check(nm, t, torch.float32, HR, dev)
        _check("ti", ivecs[3], torch.int32, HR, dev)
    return dev, geom, n


def _tiling_args(geom):
    return (geom.rows, geom.cols, geom.xr, geom.xc, geom.row_tiles_n,
            geom.col_tiles_n)


def _vec_rows(geom, tensors) -> int:
    """1 where the row kernels may walk a row in 16-byte segments of 4
    cells: whole tiles of a multiple of 4 cells in a row (no padded
    columns) and 16-byte aligned operands; else 0 (cell by cell)."""
    return int(geom.xc % 4 == 0 and geom.cols % geom.xc == 0
               and all(t.data_ptr() % 16 == 0 for t in tensors))


def _coeff_args(k: DecayCoeffs, eps: float):
    return (k.inv_tau_z, k.inv_tau_e, k.inv_tau_p, k.c_ze, k.c_ep, k.c_zp,
            eps, eps * eps)


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")


def _flat(planes):
    """The stored planes as 1-D views, for the layout's index maps."""
    return tuple(t.view(-1) for t in planes)


# --------------------------------------------------------------------------
# row phase
# --------------------------------------------------------------------------

def fused_row_update_kernel(zij, eij, pij, wij, tij, zi, ei, pi, ti, rows,
                            now, counts, zj, p_i, pj, zi_new, ei_new, pi_new,
                            coeffs: DecayCoeffs, eps: float, layout=None):
    """The worklist row phase as one CUDA launch (`fused_row_kernel`).

    Replaces `repro/kernels/bcpnn_update.py:fused_row_update_kernel_call`
    (`_fused_row_kernel`). The W = H*A slot-ordered entries are A per HCU:
    slot s belongs to HCU s // A. Each valid slot applies the cell math to
    the logical row ``rows[s]`` (a global flat row index) with
    dz = counts[s]*zj[s // A], p_pre = p_i[s] and p_post = pj[s // A],
    stamps Tij = now, writes zi/ei/pi_new[s] into the i-vectors, stamps
    ti = now, and emits the weight row into the returned (W, C) buffer.
    Sentinel slots (rows[s] >= H*R) write nothing but a zero weight row.

    Bound on the H100: bytes. A valid slot moves 10*C*4 bytes (reads z, e,
    p, t; writes z, e, p, w, t and its weight row) for ~33 float32 ops (4
    transcendentals among them) per cell; the (H, C) j-vectors are read in
    place, once per HCU from DRAM. Design: one warp per slot, one lane per
    16-byte segment of 4 cells (float4 / int4), so a row of C <= 128 cells
    is one step of loads with no dependent iteration; on the flat layout a
    row is C/4 contiguous segments, on an (xr, 4) tile C/4 segments
    xr*16 bytes apart. Where a row does not split into whole 4-cell
    segments (a tile such as (7, 5)), the lanes walk single cells. The
    TPU's (8, 128) tiles, junk row and per-call `_pad2` copies of the planes
    are gone (masking is a bounds check on the row index).

    Planes (stored in ``layout``) and i-vectors (H*R,) are rewritten in
    place. rows (W,) int32, now an int32 one-element tensor (read on the
    device), counts / p_i / *_new (W,) and zj / pj (H, C) float32, all
    contiguous on one CUDA device. Launches on the current stream and
    never synchronises.
    """
    planes, ivecs = (zij, eij, pij, wij, tij), (zi, ei, pi, ti)
    dev, geom, n = _check_planes(planes, layout, ivecs=ivecs)
    C = geom.cols
    W = rows.shape[0] if torch.is_tensor(rows) else -1
    _check("rows", rows, torch.int32, (W,), dev)
    _check_one("now", now, dev)
    for nm, t in (("counts", counts), ("p_i", p_i), ("zi_new", zi_new),
                  ("ei_new", ei_new), ("pi_new", pi_new)):
        _check(nm, t, torch.float32, (W,), dev)
    H = zj.shape[0] if torch.is_tensor(zj) and zj.dim() == 2 else -1
    _check("zj", zj, torch.float32, (H, C), dev)
    _check("pj", pj, torch.float32, (H, C), dev)
    if H <= 0 or W % H:
        raise ValueError(f"{W} slots are not A per HCU of {H}")
    wrow = torch.empty((W, C), dtype=torch.float32, device=dev)
    if W == 0:
        return wrow
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (*planes, *ivecs, rows, now, counts, zj,
                                   p_i, pj, zi_new, ei_new, pi_new, wrow)]
    vec = _vec_rows(geom, (*planes, zj, pj, wrow))
    rc = _lib().bcpnn_fused_row_update(*ptrs, W, W // H, n * geom.rows,
                                       *_tiling_args(geom), vec,
                                       *_coeff_args(coeffs, eps), stream)
    _raise_on(rc, "fused_row_update")
    launches["fused_row_update"] += 1
    return wrow


def fused_row_update_plain(zij, eij, pij, wij, tij, zi, ei, pi, ti, rows,
                           now, counts, zj, p_i, pj, zi_new, ei_new, pi_new,
                           coeffs: DecayCoeffs, eps: float, layout=None):
    """Plain PyTorch version of `fused_row_update_kernel` (same arguments,
    same in-place effect, same returned weight rows): gather the valid
    slots' rows through the layout's index map, run the cell math, scatter
    back."""
    geom, n = _geometry(zij, layout)
    zf, ef, pf, wf, tf = _flat((zij, eij, pij, wij, tij))
    W = rows.shape[0]
    A = W // zj.shape[0]
    sel = torch.nonzero((rows >= 0) & (rows < n * geom.rows)).squeeze(1)
    g = rows[sel].long()
    idx = geom.row_index(g)                                      # (nv, C)
    h = sel // A
    dt = (now - tf[idx]).to(torch.float32)
    z1, e1, p1, w1 = cell_math(zf[idx], ef[idx], pf[idx], dt,
                               counts[sel, None] * zj[h], p_i[sel, None],
                               pj[h], coeffs, eps)
    zf[idx], ef[idx], pf[idx], wf[idx] = z1, e1, p1, w1
    tf[idx] = now.to(tf.dtype).reshape(())
    zi[g], ei[g], pi[g] = zi_new[sel], ei_new[sel], pi_new[sel]
    ti[g] = now.to(ti.dtype).reshape(())
    wrow = torch.zeros((W, geom.cols), dtype=torch.float32, device=zij.device)
    wrow[sel] = w1
    return wrow


# --------------------------------------------------------------------------
# column phase
# --------------------------------------------------------------------------

def fused_col_update_kernel(zij, eij, pij, wij, tij, zi, ei, pi, ti, pj,
                            h_idx, j_idx, now, coeffs: DecayCoeffs,
                            coeffs_i: DecayCoeffs, eps: float, n_hcu: int,
                            rows: int, layout=None):
    """The worklist column phase as one CUDA launch (`fused_col_kernel`).

    Replaces `repro/kernels/bcpnn_update.py:fused_col_update_kernel_call`
    (`_fused_col_kernel`) together with the column prologue around it
    (`repro/core/engine.py:_col_worklist_prologue`). For each fired entry e
    with h_idx[e] < n_hcu, with h = h_idx[e] and j = j_idx[e], the kernel
    brings HCU h's i-vector traces to ``now`` (Z_i and P_i of
    `traces.decay_zep` over now - ti, with ``coeffs_i``; the i-vectors are
    not written), then updates the ``rows`` cells of column j in HCU h with
    dz = Z_i[r], p_pre = P_i[r] and p_post = pj[h, j], and stamps
    Tij = now. Padding entries (h_idx == n_hcu) return at once.

    Bound on the H100: bytes. The function moves 52 bytes a cell (reads z,
    e, p, t and zi, ei, pi, ti; writes z, e, p, w, t), but the R cells of a
    column are not contiguous, and DRAM and L2 move 32-byte sectors. Flat,
    a column's cells lie C*4 bytes apart: each of the 9 plane accesses of a
    cell costs a sector for 4 useful bytes. On an (xr, 4) tile the column is
    R/xr runs of xr cells 16 bytes apart, contiguous xr*16-byte blocks, so
    a sector serves two cells. Design: one thread per row of an entry,
    neighbouring lanes on neighbouring rows (a warp reads runs of one tile
    column), its eight loads issued before its arithmetic; on the H100 one
    row a thread beat several rows a thread, whose extra loads in flight
    bought nothing while the grid lost blocks. Nothing is reused, so
    nothing is staged in shared memory. The (K, R) gathers and decay of
    the i-vectors that the prologue ran as separate launches are gone, as
    are the TPU's lane tiles, iota lane masks, junk row-block, padded plane
    copies and the K <= 128 limit.

    Planes (stored in ``layout``, HCUs of ``rows`` rows) are rewritten in
    place. zi / ei / pi (H*R,) float32 and ti int32; pj (H, C) float32;
    h_idx, j_idx (K,) int32; now an int32 one-element tensor. Launches on
    the current stream and never synchronises.
    """
    planes = (zij, eij, pij, wij, tij)
    dev, geom, n = _check_planes(planes, layout, rows, (zi, ei, pi, ti))
    if n != n_hcu:
        raise ValueError(f"planes hold {n} HCUs, expected {n_hcu}")
    K = h_idx.shape[0] if torch.is_tensor(h_idx) else -1
    _check("h_idx", h_idx, torch.int32, (K,), dev)
    _check("j_idx", j_idx, torch.int32, (K,), dev)
    _check_one("now", now, dev)
    _check("pj", pj, torch.float32, (n_hcu, geom.cols), dev)
    if K == 0 or rows == 0:
        return
    if K > 65535:
        raise ValueError(f"fired batch of {K} exceeds the grid's y limit")
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (*planes, zi, ei, pi, ti, pj, h_idx, j_idx,
                                   now)]
    rc = _lib().bcpnn_fused_col_update(*ptrs, K, n_hcu, *_tiling_args(geom),
                                       *_coeff_args(coeffs, eps),
                                       *_coeff_args(coeffs_i, 0.0)[:6],
                                       stream)
    _raise_on(rc, "fused_col_update")
    launches["fused_col_update"] += 1


def fused_col_update_plain(zij, eij, pij, wij, tij, zi, ei, pi, ti, pj,
                           h_idx, j_idx, now, coeffs: DecayCoeffs,
                           coeffs_i: DecayCoeffs, eps: float, n_hcu: int,
                           rows: int, layout=None):
    """Plain PyTorch version of `fused_col_update_kernel` (same arguments,
    same in-place effect): the valid entries' i-vectors decayed with
    `decay_zep` (the operation order of `hcu.ivec_decay`), their columns
    gathered through the layout's index map, the cell math, scatter
    back."""
    geom, _ = _geometry(zij, layout, rows)
    zf, ef, pf, wf, tf = _flat((zij, eij, pij, wij, tij))
    C = geom.cols
    ok = (h_idx >= 0) & (h_idx < n_hcu) & (j_idx >= 0) & (j_idx < C)
    sel = torch.nonzero(ok).squeeze(1)
    h, j = h_idx[sel].long(), j_idx[sel].long()
    idx = geom.col_index(h, j)                                   # (k, R)
    g = h[:, None] * rows + torch.arange(rows, device=zij.device)
    zep_i = decay_zep(ZEP(zi[g], ei[g], pi[g]),
                      (now - ti[g]).to(torch.float32), coeffs_i)
    dt = (now - tf[idx]).to(torch.float32)
    z1, e1, p1, w1 = cell_math(zf[idx], ef[idx], pf[idx], dt, zep_i.z,
                               zep_i.p, pj[h, j][:, None], coeffs, eps)
    zf[idx], ef[idx], pf[idx], wf[idx] = z1, e1, p1, w1
    tf[idx] = now.to(tf.dtype).reshape(())


# --------------------------------------------------------------------------
# unfused worklist row update
# --------------------------------------------------------------------------

def worklist_row_update_kernel(zij, eij, pij, wij, tij, g_row, order, nv,
                               now, counts, zj, p_i, pj, coeffs: DecayCoeffs,
                               eps: float, layout=None):
    """The unfused worklist row update as one CUDA launch
    (`worklist_row_kernel`).

    Replaces `repro/kernels/bcpnn_update.py:worklist_update_kernel_call`
    (`_worklist_kernel`), reading through the compaction instead of the
    per-entry copies the JAX engine gathers for it. The W = H*A slots are
    slot-ordered, A per HCU (slot s belongs to HCU s // A), and ``order``
    compacts the live ones first: entry i < nv takes slot s = order[i]
    and, when g_row[s] is a logical plane row, applies the cell math to
    that row with dz = counts[s]*zj[s // A], p_pre = p_i[s] and
    p_post = pj[s // A], and stamps Tij = now. Entries at or past nv
    write nothing, whatever ``order`` holds there. The i-vectors and the
    weight rows are the caller's.

    Bound on the H100: bytes and DRAM latency. A live entry reads z, e, p,
    t and writes z, e, p, w, t (9*C*4 bytes) plus its slot's index and
    scalars, for ~33 float32 ops a cell; the (H, C) j-vectors are read in
    place, each HCU's once from DRAM. A row's reads sit behind two
    dependent index loads (order, then g_row). Design: a grid of at most
    64 warps an SM, a warp an entry, striding over i < nv; a warp reads
    nv with its first slot, then the slot's row and scalars, then the
    row's cells (one lane a 16-byte segment of 4 cells, or single cells on
    a tile such as (7, 5)), and loads the next entry's slot, row and
    scalars while those cells are in flight. Blocks of 4 warps where rows
    share sectors (flat, (2, 4), (4, 4)), of 16 elsewhere (measured). nv
    and now are read on the device: the launch needs no host value.

    Planes (stored in ``layout``) are rewritten in place. g_row / order
    (W,) int32; nv and now int32 one-element tensors; counts / p_i (W,)
    and zj / pj (H, C) float32. Launches on the current stream and never
    synchronises.
    """
    planes = (zij, eij, pij, wij, tij)
    dev, geom, n = _check_planes(planes, layout)
    C = geom.cols
    W = g_row.shape[0] if torch.is_tensor(g_row) else -1
    _check("g_row", g_row, torch.int32, (W,), dev)
    _check("order", order, torch.int32, (W,), dev)
    _check_one("nv", nv, dev)
    _check_one("now", now, dev)
    _check("counts", counts, torch.float32, (W,), dev)
    _check("p_i", p_i, torch.float32, (W,), dev)
    H = zj.shape[0] if torch.is_tensor(zj) and zj.dim() == 2 else -1
    _check("zj", zj, torch.float32, (H, C), dev)
    _check("pj", pj, torch.float32, (H, C), dev)
    if H <= 0 or W % H:
        raise ValueError(f"{W} slots are not A per HCU of {H}")
    if W == 0:
        return
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (*planes, g_row, order, nv, now, counts,
                                   zj, p_i, pj)]
    vec = _vec_rows(geom, (*planes, zj, pj))
    rc = _lib().bcpnn_worklist_row_update(*ptrs, W, W // H, n * geom.rows,
                                          *_tiling_args(geom), vec,
                                          *_coeff_args(coeffs, eps), stream)
    _raise_on(rc, "worklist_row_update")
    launches["worklist_row_update"] += 1


def worklist_row_update_plain(zij, eij, pij, wij, tij, g_row, order, nv,
                              now, counts, zj, p_i, pj, coeffs: DecayCoeffs,
                              eps: float, layout=None):
    """Plain PyTorch version of `worklist_row_update_kernel` (same
    arguments, same in-place effect): the live entries' slots and rows,
    their rows gathered through the layout's index map, the cell math,
    scatter back."""
    geom, n = _geometry(zij, layout)
    zf, ef, pf, wf, tf = _flat((zij, eij, pij, wij, tij))
    W = order.shape[0]
    A = W // zj.shape[0]
    s = order[torch.arange(W, device=order.device) < nv.reshape(())].long()
    s = s[(s >= 0) & (s < W)]
    g = g_row[s].long()
    keep = (g >= 0) & (g < n * geom.rows)
    s, g = s[keep], g[keep]
    idx = geom.row_index(g)                                      # (k, C)
    h = s // A
    dt = (now - tf[idx]).to(torch.float32)
    z1, e1, p1, w1 = cell_math(zf[idx], ef[idx], pf[idx], dt,
                               counts[s, None] * zj[h], p_i[s, None], pj[h],
                               coeffs, eps)
    zf[idx], ef[idx], pf[idx], wf[idx] = z1, e1, p1, w1
    tf[idx] = now.to(tf.dtype).reshape(())


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
