"""eBrainIII-style merged column updates (the port of `repro.core.merged`;
paper §IX future work, item 2):

    "The BCPNN algorithm has been tweaked to eliminate the column updates
     and merge them with row updates."

On an output spike at MCU j (time t_j) the only per-cell state change is
    Zij += Zi(t_j)                      (then ordinary decay)
Zi decays deterministically between row-i touches, so a later row update
at time t can rebuild every missed j-spike contribution from the spike
TIME alone:
    Zi(t_j) = Zi(Tij) * exp(-(t_j - Tij)/tau_zi)
and the E/P cascade is integrated piecewise (decay to t_j, bump Z, decay
on) with the same closed form. Each HCU keeps only a per-column ring of
the last RING_DEPTH output-spike times ((C, 8) int32, 3.2 KB at C = 100,
in place of the R-cell column write). When a fired column's ring is full
the column is flushed the classic way (`overflow_flush`), so the mode
stays exact under any firing pattern.

Effect on the worst-case ms budget (paper EQ2): the column term goes,
    cells: 36*C + R = 13,600  ->  36*C = 3,600   (3.8x, human scale).

Every function here is batched over a leading HCU axis where the JAX
package `vmap`s over HCUs, and computes in the JAX package's operation
order. Ring slots that hold RING_EMPTY give exp(+1e6/tau_zi) = inf in the
Zi(t_m) term; that term is discarded by a select (`torch.where`), never
by a multiply with the mask (0 * inf = NaN).
"""
from __future__ import annotations

import torch

from repro_torch.core import hcu as H
from repro_torch.core import layout as L
from repro_torch.core import spans
from repro_torch.core import worklist as WL
from repro_torch.core.params import BCPNNParams
from repro_torch.core.traces import ZEP, bayesian_weight, decay_zep
from repro_torch.core.traces import exp_rounded as _exp

RING_DEPTH = 8
RING_EMPTY = -(10 ** 6)


def init_ring(p: BCPNNParams, n_hcu: int | None = None, device=None):
    """Per-column output-spike time ring, oldest first (sorted by
    construction: times are pushed in increasing order): (C, RING_DEPTH)
    int32 of RING_EMPTY, or (n_hcu, C, RING_DEPTH) for a network."""
    lead = () if n_hcu is None else (n_hcu,)
    return torch.full(lead + (p.cols, RING_DEPTH), RING_EMPTY,
                      dtype=torch.int32, device=device)


def push_ring(ring, j, t):
    """Record output spike (column j, time t) in ``ring`` (..., C, M),
    j (...,) int; a masked no-op where j < 0. Returns a new ring."""
    j = torch.as_tensor(j, device=ring.device)
    idx = torch.clamp(j, min=0).long()[..., None, None].expand(
        *j.shape, 1, RING_DEPTH)
    row = torch.gather(ring, -2, idx)                          # (..., 1, M)
    tt = torch.as_tensor(t, dtype=torch.int32, device=ring.device)
    new = torch.cat([row[..., 1:], tt.expand(row[..., :1].shape)], dim=-1)
    row = torch.where((j >= 0)[..., None, None], new, row)
    return ring.scatter(-2, idx, row)


def _segment(zep: ZEP, tm, t0f, nowf, b_prev, zi_at, kij):
    """One ring segment of spike time tm: decay to its boundary
    clip(tm, t0, now), then the bump Zi(t_m) where t0 < tm <= now (a
    select: zi_at is inf on an empty slot). Returns (zep', boundary)."""
    b = torch.minimum(torch.maximum(tm, t0f), nowf)          # jnp.clip
    zep = decay_zep(zep, b - b_prev, kij, _exp)
    bump = (tm > t0f) & (tm <= nowf)
    return ZEP(zep.z + torch.where(bump, zi_at, 0.0), zep.e, zep.p), b


def merged_row_math(z, e, pp, t0, ring, zi_g, ti_g, counts, zj, pi_dec, pj,
                    now, p: BCPNNParams):
    """Merged (..., A, C)-block row update: piecewise ring integration, the
    own-spike increment and the Bayesian weight. ring (..., C, M);
    zi_g, ti_g, counts, pi_dec (..., A); zj, pj (..., C); ``now`` an int
    or int32 tensor. Returns (z1, e1, p1, w1)."""
    kij = H.coeffs_ij(p)
    t0f = t0.to(torch.float32)
    nowf = torch.as_tensor(now, device=z.device).to(torch.float32)
    tif = ti_g.to(torch.float32)[..., None]
    b_prev = t0f
    zep = ZEP(z, e, pp)
    for m in range(RING_DEPTH):                         # oldest -> newest
        tm = ring[..., m].to(torch.float32)[..., None, :]   # (..., 1, C)
        # Zi at the spike time, from the i-vector value at its last stamp
        zi_at = zi_g[..., None] * _exp(-(tm - tif) * (1.0 / p.tau_zi))
        zep, b_prev = _segment(zep, tm, t0f, nowf, b_prev, zi_at, kij)
    zep = decay_zep(zep, nowf - b_prev, kij, _exp)      # tail segment
    z1 = zep.z + counts[..., None] * zj[..., None, :]
    w1 = bayesian_weight(zep.p, pi_dec[..., None], pj[..., None, :], p.eps)
    return z1, zep.e, zep.p, w1


def row_updates_merged(st: H.HCUState, ring, rows, now, p: BCPNNParams,
                       touch_only: bool = False):
    """Row updates with deferred (merged) column contributions, on the
    batched (H, R, C) view ``st``; its planes and i-vectors are rewritten
    in place. The same semantics as `hcu.row_updates`, but each cell's
    lazy decay is integrated piecewise across the spike times of ``ring``
    (H, C, M) (`merged_row_math`). ``touch_only`` decays and rebuilds
    without injecting input spikes (`flush_merged`). Returns
    (st', w_rows (H, A, C), counts, rows_u)."""
    n, A = rows.shape
    R = p.rows
    now = torch.as_tensor(now, dtype=torch.int32, device=rows.device)
    rows_u, counts = H.dedup_rows(rows, R)
    if touch_only:
        counts = torch.zeros_like(counts)
    safe = torch.clamp(rows_u, max=R - 1).long()
    g = torch.arange(n, device=rows.device)[:, None] * R + safe   # (H, A)
    flat = L.flat_state(st)
    iv_old = tuple(getattr(flat, f)[g] for f in ("zi", "ei", "pi", "ti"))
    zep_i = H.ivec_decay(*iv_old, now, p)
    zi_new = zep_i.z + counts
    old = tuple(getattr(flat, f)[g] for f in ("zij", "eij", "pij", "wij",
                                             "tij"))
    z1, e1, p1, w1 = merged_row_math(old[0], old[1], old[2], old[4], ring,
                                     iv_old[0], iv_old[3], counts, st.zj,
                                     zep_i.p, st.pj, now, p)
    H.write_rows(flat, H.drop_redirect(g, rows_u < R), now, (z1, e1, p1, w1),
                 old, (zi_new, zep_i.e, zep_i.p), iv_old)
    return L.batched_state(flat, n), w1, counts, rows_u


def merged_col_math(z, e, pp, t0, ring_row, zi, ei, pi, ti, pj_j,
                    apply_fire, now, p: BCPNNParams):
    """Merged (..., R)-column flush: piecewise ring integration, the fire
    at ``now`` where ``apply_fire`` (...,), and the Bayesian weight.
    ring_row (..., M) is the fired column's ring; zi, ei, pi, ti (..., R)
    the HCU's whole i-vector; pj_j (...,). Returns (z1, e1, p1, w1)."""
    kij, ki = H.coeffs_ij(p), H.coeffs_i(p)
    t0f = t0.to(torch.float32)
    tif = ti.to(torch.float32)
    nowf = torch.as_tensor(now, device=z.device).to(torch.float32)
    zep = ZEP(z, e, pp)
    b_prev = t0f
    for m in range(RING_DEPTH):
        tm = ring_row[..., m:m + 1].to(torch.float32)          # (..., 1)
        zi_at = zi * _exp(-(tm - tif) * (1.0 / p.tau_zi))
        zep, b_prev = _segment(zep, tm, t0f, nowf, b_prev, zi_at, kij)
    zep = decay_zep(zep, nowf - b_prev, kij, _exp)
    # the fire at `now` itself (Zi(now) from the lazily decayed i-vector)
    zi_now = zi * _exp(-(nowf - tif) * (1.0 / p.tau_zi))
    z1 = zep.z + torch.where(apply_fire[..., None], zi_now, 0.0)
    pi_now = decay_zep(ZEP(zi, ei, pi), nowf - tif, ki, _exp).p
    w1 = bayesian_weight(zep.p, pi_now, pj_j[..., None], p.eps)
    return z1, zep.e, zep.p, w1


def overflow_flush(hcus: H.HCUState, ring, j, now, apply_fire,
                   p: BCPNNParams, layout=None):
    """The overflow flush of every HCU, on the network's flat HCU state
    with the ij planes stored in ``layout`` (None: flat): column j[h]
    (H,) of HCU h brought current through its ring, the fire at ``now``
    applied and the column stamped, where ``apply_fire`` (H,); the other
    HCUs' columns are written back unchanged. The planes are rewritten in
    place; the flushed columns' rings are cleared. Every HCU is computed
    and the write is masked (as the JAX package does): a fixed shape, so
    a CUDA graph holds it. Returns (hcus, ring')."""
    n = ring.shape[0]
    R = p.rows
    h = torch.arange(n, device=ring.device)
    jl = j.long()
    cell = L.as_layout(layout, R, p.cols).col_index(h, jl)       # (H, R)
    planes = tuple(getattr(hcus, f).view(-1)
                   for f in ("zij", "eij", "pij", "wij", "tij"))
    old = tuple(pl[cell] for pl in planes)
    iv = lambda v: v.reshape(n, R)
    ring_row = ring[h, jl]                                       # (H, M)
    new = merged_col_math(old[0], old[1], old[2], old[4], ring_row,
                          iv(hcus.zi), iv(hcus.ei), iv(hcus.pi), iv(hcus.ti),
                          hcus.pj[h, jl], apply_fire, now, p)
    now_t = torch.as_tensor(now, dtype=torch.int32, device=ring.device)
    keep = apply_fire[:, None]
    for pl, v_new, v_old in zip(planes, (*new, now_t), old):
        # one column per HCU: the cells are distinct, no ordering needed
        pl[cell] = torch.where(keep, v_new, v_old)
    empty = torch.full_like(ring_row, RING_EMPTY)
    ring = ring.index_put((h, jl), torch.where(keep, empty, ring_row))
    return hcus, ring


def column_flush_merged(st: H.HCUState, ring, j, now, apply_fire,
                        p: BCPNNParams) -> H.HCUState:
    """Bring column j[h] of each HCU of the batched (H, R, C) view fully
    current where apply_fire[h] (the JAX package's `column_flush_merged`
    under `vmap`): its pending ring spikes integrated into all R cells,
    the fire at ``now`` applied and the column stamped. Rewrites the
    planes in place; returns the state (the ring is not changed here)."""
    flat, _ = overflow_flush(L.flat_state(st), ring, torch.as_tensor(j),
                             now, apply_fire, p)
    return L.batched_state(flat, ring.shape[0])


def merged_tail(hcus: H.HCUState, ring, fired, rows_u, zi_new, now,
                p: BCPNNParams, layout=None):
    """What a merged tick does after the WTA, on the flat HCU state with
    the planes in ``layout``: the overflow flush of fired columns whose
    ring is full (the fire applied, the ring cleared, no push); for every
    other fired HCU the same-tick patch of this tick's rows
    (`worklist.patch_cells`: they are stamped Tij == now, so the ring
    cannot credit them a fire at now) and the ring push; then Zj += 1 at
    the fired column. fired (H,) int32 (-1: silent); rows_u, zi_new (H, A)
    this tick's deduplicated rows and post-increment Zi(now). Returns
    (hcus', ring')."""
    n = ring.shape[0]
    active = fired >= 0
    safe_j = torch.clamp(fired, min=0)
    h = torch.arange(n, device=ring.device)
    overflow = active & (ring[h, safe_j.long(), 0] != RING_EMPTY)
    hcus, ring = overflow_flush(hcus, ring, safe_j, now, overflow, p, layout)
    WL.patch_cells(hcus.zij, active & ~overflow, rows_u, zi_new, fired,
                   p.rows, p.cols, layout)
    ring = push_ring(ring, torch.where(overflow, -1, fired), now)
    col = torch.arange(p.cols, device=ring.device)
    bump = active[:, None] & (col[None, :] == safe_j[:, None])
    return hcus._replace(zj=hcus.zj + torch.where(bump, 1.0, 0.0)), ring


def hcu_tick_merged(st: H.HCUState, ring, rows, now, key, p: BCPNNParams):
    """One merged-mode tick of every HCU of the batched (H, R, C) view
    (the JAX package's `hcu_tick_merged` under `vmap`): j-vector decay,
    merged row updates, the WTA, then `merged_tail` (overflow flush, patch,
    ring push, Zj bump) in place of a column update. The planes and
    i-vectors are rewritten in place. Returns (st', ring', fired_j (H,))."""
    n = rows.shape[0]
    st = H._decay_jvec(st, p)
    st, w_rows, counts, rows_u = row_updates_merged(st, ring, rows, now, p)
    spans.mark("rows")
    st, fired_j = H.periodic_update(st, w_rows, counts, key, p)
    # post-increment Zi(now) of this tick's rows (written just above)
    safe = torch.clamp(rows_u, max=p.rows - 1).long()
    zi_new = torch.gather(st.zi, 1, safe)
    flat, ring = merged_tail(L.flat_state(st), ring, fired_j, rows_u, zi_new,
                             now, p)
    return L.batched_state(flat, n), ring, fired_j


def flush_merged(st: H.HCUState, ring, now, p: BCPNNParams) -> H.HCUState:
    """Every cell of the batched (H, R, C) view brought current, the ring
    contributions applied: every row touched with zero counts, 64 rows a
    batch, then W recomputed (comparable to `hcu.flush`). Returns new
    tensors; ``st`` is not changed."""
    st = H.HCUState(*(v.clone() for v in st))
    n, R = ring.shape[0], p.rows
    dev = ring.device
    for lo in range(0, R, 64):
        rows = torch.arange(lo, lo + 64, dtype=torch.int32, device=dev)
        rows = torch.where(rows < R, rows, R).expand(n, 64)
        st, _, _, _ = row_updates_merged(st, ring, rows, now, p,
                                         touch_only=True)
    return st


def worst_case_cells_merged(p: BCPNNParams) -> dict:
    """EQ2 with merged columns: the R-cell column term disappears."""
    classic = p.active_queue * p.cols + p.rows
    merged = p.active_queue * p.cols
    return {"classic_cells": classic, "merged_cells": merged,
            "reduction": classic / merged}
