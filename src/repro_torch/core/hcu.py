"""Hyper Column Unit (HCU) state and the per-HCU pieces of the BCPNN tick
(the port of `repro.core.hcu`).

State is structure-of-arrays; the field set is the paper's cell: Zij, Eij,
Pij, Wij, Tij. The j-vector is decayed every tick; the i-vector and the ij
planes are lazy (timestamped). The network holds the HCUs in the flat
layout (`repro_torch.core.layout`): ij planes (H*R, C), i-vectors (H*R,),
j-vectors and support (H, C); the ij planes may instead be stored
column-blocked, which only the worklist steps address. Functions here take
batched tensors on the flat layout: a leading H dimension stands for JAX's
`vmap` over HCUs.

The row write-back rewrites the touched rows of the planes in place. JAX
writes it as a scatter with ``mode="drop"`` (padding slots carry the
out-of-range row R); CUDA indexing would fault on those writes, and a
boolean mask would synchronise the tick. `put_drop` redirects each padding
entry instead (`drop_redirect`), so every write lands in range and
duplicates carry identical bits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.params import BCPNNParams
from repro_torch.core.traces import ZEP, bias, decay_zep, make_coeffs
from repro_torch.core import layout as L
from repro_torch.core import rng
from repro_torch.core import spans
from repro_torch.kernels import ops
from repro_torch.kernels import wta_draw as WD


# Size guard of the JAX package: at most this many cells per HCU take the
# dense backend (`use_worklist`).
DENSE_CELLS_MAX = 1 << 16


def use_worklist(p: BCPNNParams, override: bool | None = None) -> bool:
    """Size guard for the worklist backend: R*C > DENSE_CELLS_MAX cells per
    HCU take it, smaller HCUs the dense backend. ``override`` (the
    `worklist=` argument) forces either; both give the same trajectory."""
    if override is not None:
        return bool(override)
    return p.rows * p.cols > DENSE_CELLS_MAX


def use_fused_rows(p: BCPNNParams, override: bool | None = None) -> bool:
    """Guard for the worklist backend's fused row phase (one
    `ops.fused_row_update` launch): on unless ``override`` (the `fused=`
    argument) says otherwise; the unfused phase gives the same bits."""
    if override is not None:
        return bool(override)
    return True


def use_fused_cols(p: BCPNNParams, override: bool | None = None) -> bool:
    """Guard for the worklist backend's fused column phase (one
    `ops.fused_col_update` launch): on unless ``override`` (the
    `fused_cols=` argument) says otherwise; the unfused phase gives the
    same bits."""
    if override is not None:
        return bool(override)
    return True


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


def init_hcu_state(p: BCPNNParams, dtype=torch.float32,
                   device=None) -> HCUState:
    """One HCU's initial (R, C) state: ij planes (R, C), i-vectors (R,),
    j-vectors and support (C,). The initial weight is computed in
    ``dtype`` with the scalars rounded to it first, as the JAX package's
    `init_hcu_state` computes it. ``device`` defaults to CUDA (raises
    without it; pass "cpu" for the CPU)."""
    dev = resolve_device(device)
    R, C = p.rows, p.cols
    full = lambda shape, v: torch.full(shape, v, dtype=dtype, device=dev)
    zeros = lambda shape, dt=dtype: torch.zeros(shape, dtype=dt, device=dev)
    pij0 = full((R, C), p.p_init * p.p_init)
    pi0, pj0 = full((R,), p.p_init), full((C,), p.p_init)
    eps, eps2 = (torch.tensor(v, dtype=dtype) for v in (p.eps, p.eps**2))
    w0 = torch.log((pij0 + eps2) / ((pi0[:, None] + eps) * (pj0[None, :] + eps)))
    return HCUState(
        zij=zeros((R, C)), eij=zeros((R, C)), pij=pij0, wij=w0,
        tij=zeros((R, C), torch.int32),
        zi=zeros((R,)), ei=zeros((R,)), pi=pi0, ti=zeros((R,), torch.int32),
        zj=zeros((C,)), ej=zeros((C,)), pj=pj0, h=zeros((C,)))


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


def _decay_jvec(st: HCUState, p: BCPNNParams) -> HCUState:
    """Per-tick exact decay of the locally held j-vectors (H, C)."""
    zep = decay_zep(ZEP(st.zj, st.ej, st.pj), p.dt_ms, coeffs_j(p))
    return st._replace(zj=zep.z, ej=zep.e, pj=zep.p)


def ivec_decay(zi_g, ei_g, pi_g, ti_g, now, p: BCPNNParams) -> ZEP:
    """Lazy decay of gathered i-vector traces to `now`."""
    d_i = (now - ti_g).to(zi_g.dtype)
    return decay_zep(ZEP(zi_g, ei_g, pi_g), d_i, coeffs_i(p))


def drop_redirect(idx: torch.Tensor, valid: torch.Tensor):
    """The operands of a drop-mode scatter that writes nothing out of range.

    idx (G, A, ...) indices into the destination's first dimension, in
    range on every entry (the caller clips padding); valid (G, A) bool,
    each group's valid entries first (`dedup_rows` sorts an HCU's rows,
    `network.select_fired` compacts the fired batch). Every invalid entry
    takes the index and value of entry 0 of its group; where entry 0 is
    invalid too, the group writes its own gathered old values back.
    Returns (tgt, src, keep): the target indices, entry by entry and
    flattened; src (G*A,) the entry whose value each entry writes; keep
    (G*A, 1) whether that is the new value (else the old one).
    """
    G, A = valid.shape
    first = torch.arange(G, device=valid.device)[:, None] * A
    src = torch.where(valid, first + torch.arange(A, device=valid.device),
                      first).reshape(-1)
    keep = valid[:, :1].expand(G, A).reshape(-1, 1)
    return idx.reshape(G * A, -1)[src].reshape(-1), src, keep


def put_drop(dst, new, old, redirect) -> None:
    """``dst[idx] = new`` in place with JAX's ``mode="drop"`` for the
    entries that `drop_redirect` marks invalid, and no host sync. old
    (G, A, ..., *dst.shape[1:]) holds the values dst has at idx now; new
    is of that shape or a scalar tensor. All writes to one place carry the
    same bits."""
    tgt, src, keep = redirect
    n = src.shape[0]
    new = new.reshape(n, -1) if new.dim() else new
    val = torch.where(keep, new, old.reshape(n, -1))[src]
    dst[tgt] = val.reshape((-1,) + tuple(dst.shape[1:]))


def write_ivecs(st: HCUState, redirect, now, new, old) -> None:
    """Write i-vector entries in place on the flat-layout state: new
    (zi, ei, pi) values, ti stamped to `now`, at the rows of `redirect`
    (`drop_redirect`); old (zi, ei, pi, ti) are the entries gathered
    there."""
    for f, v_new, v_old in zip(("zi", "ei", "pi", "ti"), (*new, now), old):
        put_drop(getattr(st, f), v_new, v_old, redirect)


def row_updates(st: HCUState, rows: torch.Tensor, now, p: BCPNNParams):
    """Apply lazy row updates for incoming spikes, batched over HCUs.

    st: the batched (H, R, C) view; its planes and i-vectors are rewritten
    in place. rows: (H, A) int32 row indices, padding == p.rows. `now` an
    int32 tensor. Assumes the j-vectors are decayed to `now` this tick.
    Returns (st, w_rows (H, A, C), counts (H, A), rows_u (H, A)).
    """
    n, A = rows.shape
    R, C = p.rows, p.cols
    rows_u, counts = dedup_rows(rows, R)
    safe = torch.clamp(rows_u, max=R - 1).long()
    g = torch.arange(n, device=rows.device)[:, None] * R + safe   # (H, A)
    flat = L.flat_state(st)
    iv_old = tuple(getattr(flat, f)[g] for f in ("zi", "ei", "pi", "ti"))
    zep_i = ivec_decay(*iv_old, now, p)
    zi_new = zep_i.z + counts
    old = tuple(getattr(flat, f)[g] for f in ("zij", "eij", "pij", "wij",
                                             "tij"))
    z1, e1, p1, w1, _ = ops.row_update(old[0], old[1], old[2], old[4], now,
                                       counts, st.zj, zep_i.p, st.pj,
                                       coeffs_ij(p), p.eps)
    write_rows(flat, drop_redirect(g, rows_u < R), now, (z1, e1, p1, w1),
               old, (zi_new, zep_i.e, zep_i.p), iv_old)
    return st, w1, counts, rows_u


def write_rows(st: HCUState, redirect, now, rows_new, rows_old, iv_new,
               iv_old) -> None:
    """Write back a row update in place on the flat-layout state: the
    (H, A, C) plane rows (z, e, p, w) and (H, A) i-vector entries
    (zi, ei, pi), Tij/ti stamped to `now`, at the flat rows of `redirect`
    (`drop_redirect`: the padding slots' writes are dropped). rows_old /
    iv_old hold the values gathered there, Tij and ti included."""
    for f, v_new, v_old in zip(("zij", "eij", "pij", "wij", "tij"),
                               (*rows_new, now), rows_old):
        put_drop(getattr(st, f), v_new, v_old, redirect)
    write_ivecs(st, redirect, now, iv_new, iv_old)


class TickKeys(NamedTuple):
    """The WTA's keys of one tick, not yet derived: HCU h of the batch
    draws under fold_in(fold_in(base_key, t), gid_base + h), the JAX
    package's per-tick, per-HCU stream. base_key (2,) int64 and t (an
    int32 tensor) stay on the device; gid_base is the global id of HCU 0
    of the batch (sharded: rank * h_local), so the stream does not depend
    on the rank count."""
    base_key: torch.Tensor
    t: torch.Tensor
    gid_base: int = 0

    def per_hcu(self, n: int) -> torch.Tensor:
        """The (n, 2) keys themselves (`rng.fold_in` twice)."""
        k_t = rng.fold_in(self.base_key, self.t)
        return rng.fold_in(k_t, self.gid_base + torch.arange(
            n, device=self.base_key.device))


def wta_draw(h_vec, pj, w_rows, counts, keys, p: BCPNNParams):
    """Support integration + soft WTA for a batch of HCUs: the drive
    sum_a counts[:, a] * w_rows[:, a], h' = h * decay + drive, and the
    draw of `wta_draw_plain`.

    h_vec, pj (H, C); w_rows (H, A, C) with counts (H, A), or w_rows
    (H, 1, C) the drive itself with counts None; keys a `TickKeys` or the
    per-HCU keys (H, 2). Returns (h', fired_j (H,) int32), fired_j == -1
    where the HCU stays silent. The JAX package's `periodic_math`, its
    RNG stream included.

    The tensors' device decides: on the CPU the plain version, on CUDA one
    call of the hand-written kernel (`repro_torch.kernels.wta_draw`),
    which gives the same bits and launches or raises.
    """
    if h_vec.device.type == "cpu":
        return wta_draw_plain(h_vec, pj, w_rows, counts, keys, p)
    return WD.wta_draw_kernel(
        h_vec.contiguous(), pj.contiguous(), w_rows.contiguous(),
        None if counts is None else counts.contiguous(), keys,
        decay=_decay_m(p).item(), eps=p.eps,
        inv_temp=(1.0 / torch.tensor(p.wta_temp, dtype=torch.float32)).item(),
        thresh=p.out_rate * p.dt_ms)


def _decay_m(p: BCPNNParams):
    # a zero-dimensional CPU tensor: applied to CUDA tensors as a scalar
    return torch.exp(torch.tensor(-p.dt_ms / p.tau_m, dtype=torch.float32))


def slot_order_drive(counts, w_rows):
    """sum_a counts[:, a] * w_rows[:, a], added slot by slot from slot 0
    (the order the WTA kernel keeps). counts (H, A), w_rows (H, A, C)."""
    drive = torch.zeros_like(w_rows[:, 0])
    for a in range(w_rows.shape[1]):
        drive = drive + counts[:, a, None] * w_rows[:, a]
    return drive


def wta_draw_plain(h_vec, pj, w_rows, counts, keys, p: BCPNNParams):
    """Plain PyTorch version of `wta_draw` (same arguments, same result):
    the drive, then `jax.random`'s split, uniform and categorical through
    `rng`. The drive's float32 sum is taken in `torch.sum`'s order on the
    CPU (the order the CPU tests and the benchmark's reference hold the
    port to) and in slot order on CUDA (`slot_order_drive`, the kernel's),
    so that on either device this is the function the main path runs
    there, bit for bit."""
    if counts is None:
        drive = w_rows[:, 0]
    elif h_vec.device.type == "cpu":
        drive = torch.sum(counts[..., None] * w_rows, dim=-2)
    else:
        drive = slot_order_drive(counts, w_rows)
    if isinstance(keys, TickKeys):
        keys = keys.per_hcu(h_vec.shape[0])
    h = h_vec * _decay_m(p) + drive
    s = h + bias(pj, p.eps)
    k = rng.split(keys)
    fire = rng.uniform(k[..., 0, :]) < p.out_rate * p.dt_ms
    winner = rng.categorical(k[..., 1, :], s / p.wta_temp)
    fired_j = torch.where(fire, winner, -1).to(torch.int32)
    return h, fired_j


def wta(h_vec, pj, drive, keys, p: BCPNNParams):
    """Support integration of a given drive (H, C) and the soft WTA draw
    (`wta_draw` with the drive in place of the weight rows; the eager
    model's)."""
    return wta_draw(h_vec, pj, drive[:, None, :], None, keys, p)


def periodic_update(st: HCUState, w_rows, counts, keys, p: BCPNNParams):
    """Support integration + soft WTA (the paper's periodic update, every
    ms) of every HCU: `wta_draw` on the weight rows (H, A, C) and counts
    (H, A) of the tick's row phase. ``keys``: a `TickKeys` or the
    per-HCU keys (H, 2). Returns (st', fired_j (H,))."""
    h, fired_j = wta_draw(st.h, st.pj, w_rows, counts, keys, p)
    return st._replace(h=h), fired_j


def column_update(st: HCUState, j, now, p: BCPNNParams) -> HCUState:
    """The lazy column update of one HCU's (R, C) state for an output
    spike at column ``j`` (an int or an int32 tensor; a no-op when
    j < 0): the i-vector decayed to ``now`` on the fly (values only), one
    `ops.col_update` launch on the gathered column (`col_block_kernel` on
    CUDA), the column written back in place, then Zj[j] += 1. Returns the
    state with the bumped Zj. No host read: j stays a tensor."""
    dev = st.zij.device
    j = torch.as_tensor(j, dtype=torch.int64, device=dev).reshape(1)
    active = j >= 0
    safe_j = torch.clamp(j, min=0)
    zep_i = ivec_decay(st.zi, st.ei, st.pi, st.ti, now, p)
    planes = (st.zij, st.eij, st.pij, st.wij, st.tij)
    old = tuple(pl.index_select(1, safe_j).T for pl in planes)    # (1, R)
    new = ops.col_update(old[0], old[1], old[2], old[4], now,
                         zep_i.z[None], zep_i.p[None], st.pj[safe_j],
                         coeffs_ij(p), p.eps)
    for pl, v_new, v_old in zip(planes, new, old):
        pl.index_copy_(1, safe_j, torch.where(active, v_new, v_old).T)
    bump = torch.zeros_like(st.zj).index_fill_(0, safe_j, 1.0)
    return st._replace(zj=st.zj + torch.where(active, bump, 0.0))


def hcu_tick_pre(st: HCUState, rows, now, key, p: BCPNNParams):
    """j-vector decay + row updates + periodic/WTA of every HCU of the
    batched view ``st`` (planes and i-vectors rewritten in place). The
    column update is batched across HCUs at network level (only fired HCUs
    pay for it): see `engine.column_updates_batched`."""
    st = _decay_jvec(st, p)
    st, w_rows, counts, _ = row_updates(st, rows, now, p)
    spans.mark("rows")
    return periodic_update(st, w_rows, counts, key, p)


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
