"""The BCPNN tick engine: one tick pipeline behind two plane backends (the
port of `repro.core.engine`).

A network tick has one skeleton

    consume delay bucket -> plane update (rows / WTA / columns) -> fan out

and only the plane update differs by backend:

  * `WorklistBackend` — rodent/human scales: one network-global
    deduplicated worklist over the stored planes per tick, which it
    addresses in their layout (flat (H*R, C) or column-blocked tiles,
    `repro_torch.core.layout`). Its row phase is one
    `ops.fused_row_update` launch (``fused``, the default) or one
    `ops.worklist_row_update` launch plus the i-vector writes; its column
    phase one `ops.fused_col_update` launch (``fused_cols``) or the
    gathered-column `ops.col_update` of `column_updates_batched`.
  * `DenseBackend` — toy sizes: every HCU at once on the batched
    (H, R, C) view of the flat planes; mode "lazy" (one `ops.row_update`
    launch over the gathered (H, A, C) row blocks, then the same column
    step), "eager" (the dense golden model, `reference.eager_tick`) or
    "merged" (`merged.hcu_tick_merged`). Under a blocked layout the driver
    converts the planes to flat and back once per call (`carry_in` /
    `carry_out`), as the JAX package does.

Merged mode (the paper's eBrainIII ring-deferred columns,
`repro_torch.core.merged`) runs on either backend and launches none of
the hand-written kernels, as the JAX package's merged path reaches no
Pallas kernel: its row phase and overflow flush are plain torch ops
(`worklist_merged_rows`, `merged.overflow_flush`).

`select_backend` picks by the JAX package's size guard (`hcu.use_worklist`);
the flags force either. Every combination gives the trajectory of the JAX
package's backend with the same flags.

The ij planes and i-vectors are rewritten in place. The tick reads no
device value on the host (no `.item()`, no `int()` of a tensor, no
boolean-mask indexing): the current time stays a device tensor that the
kernels read through a pointer, the column step runs every tick, its
padding entries writing nothing, where the JAX package gates the pass with
`lax.cond`, and JAX's drop-mode scatters are redirected in range
(`hcu.put_drop`). A chunk of ticks can therefore be captured in one
CUDA graph, which is what `network.network_run` does on CUDA (one graph
replay per chunk of ``chunk`` ticks, `network.ChunkGraphs`). Only the
host-loop driver (`Simulator.run_host`) reads the time back each tick, as
the JAX one does.

`Simulator` is the user-facing facade. Its tensors live on ``device``:
CUDA unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import NamedTuple, Protocol

import torch

from repro_torch.core import hcu as H
from repro_torch.core import layout as L
from repro_torch.core import merged as M
from repro_torch.core import network as N
from repro_torch.core import reference
from repro_torch.core import rng
from repro_torch.core import worklist as WL
from repro_torch.core.device import resolve_device
from repro_torch.core.params import BCPNNParams
from repro_torch.kernels import ops


# ---------------------------------------------------------------------------
# plane-update building blocks
# ---------------------------------------------------------------------------

def _fired_mask(h_idx, j_idx, n: int, cols: int):
    """(H, C) mask of this tick's fired (hcu, column) cells; padding
    h_idx == n never matches arange(n)."""
    dev = h_idx.device
    return torch.any(
        (h_idx[:, None, None] == torch.arange(n, device=dev)[None, :, None])
        & (j_idx[:, None, None] == torch.arange(cols, device=dev)[None, None, :]),
        dim=0)


def _bump_zj(zj, h_idx, j_idx, n: int, p: BCPNNParams):
    """Postsynaptic Z increment (+1.0) at the fired batch's (h, j) cells;
    padding entries (h_idx == n) are dropped. Returns a new tensor. Two
    branches with the same bits, as in the JAX package: a mask of the
    fired cells while it is small, else a one-slot-spare index fill."""
    C = zj.shape[1]
    if n * p.rows * p.cols <= H.DENSE_CELLS_MAX:
        return torch.where(_fired_mask(h_idx, j_idx, n, C), zj + 1.0, zj)
    idx = torch.where(h_idx < n, h_idx * C + j_idx, n * C).long()
    bump = torch.zeros(n * C + 1, dtype=zj.dtype, device=zj.device)
    bump.index_fill_(0, idx, 1.0)
    return zj + bump[:n * C].reshape(n, C)


def column_updates_batched(hcus: H.HCUState, h_idx, j_idx, now,
                           p: BCPNNParams, layout=None) -> H.HCUState:
    """Lazy column updates for the compacted fired batch. h_idx (K,): HCU
    indices (== H for padding, whose writes are dropped); j_idx (K,): the
    fired column of each entry. The planes are stored in ``layout`` (None:
    flat, the batched (H, R, C) view included).

    Gathers exactly the K (R,)-columns that fired through the layout's
    index map and their i-vectors, updates them with one `ops.col_update`
    launch and writes them back in place (`hcu.put_drop`: padding entries
    repeat entry 0, or rewrite their own old cells on a tick where nothing
    fired). Returns hcus with the bumped Zj."""
    n = hcus.zj.shape[0]
    R = p.rows
    safe_h = torch.clamp(h_idx, max=n - 1).long()
    jl = j_idx.long()
    # stored offset of every (entry, row) of the fired columns, (K, R)
    cell = L.as_layout(layout, R, p.cols).col_index(safe_h, jl)
    planes = tuple(getattr(hcus, f).reshape(-1)
                   for f in ("zij", "eij", "pij", "wij", "tij"))
    old = tuple(pl[cell] for pl in planes)
    # i-vector traces brought to `now` (values only, no writeback)
    ivr = lambda v: v.reshape(n, R)[safe_h]
    zep_i = H.ivec_decay(ivr(hcus.zi), ivr(hcus.ei), ivr(hcus.pi),
                         ivr(hcus.ti), now, p)
    pj_sc = hcus.pj[safe_h, jl]                                   # (K,)
    z1, e1, p1, w1, t1 = ops.col_update(
        old[0], old[1], old[2], old[4], now, zep_i.z, zep_i.p, pj_sc,
        H.coeffs_ij(p), p.eps)
    # the fired batch is one group of the drop-mode scatter
    redirect = H.drop_redirect(cell[None], (h_idx < n)[None])
    for pl, v_new, v_old in zip(planes, (z1, e1, p1, w1, t1), old):
        H.put_drop(pl, v_new, v_old, redirect)
    return hcus._replace(zj=_bump_zj(hcus.zj, h_idx, j_idx, n, p))


def _row_worklist_common(hcus: H.HCUState, rows, t, p: BCPNNParams):
    """Row-phase prologue (the i-vectors are flat under every layout):
    j-vector decay, per-HCU dedup, i-vector decay and the worklist build.
    Returns a dict of intermediates; the i-vector values are (H, A),
    indexed by slot."""
    n, A = rows.shape
    R = p.rows
    hcus = H._decay_jvec(hcus, p)
    rows_u, counts = H.dedup_rows(rows, R)
    safe = torch.clamp(rows_u, max=R - 1).long()
    g_safe = torch.arange(n, device=rows.device)[:, None] * R + safe  # (H, A)
    iv_old = tuple(getattr(hcus, f)[g_safe] for f in ("zi", "ei", "pi", "ti"))
    zep_i = H.ivec_decay(*iv_old, t, p)
    g_row, order, nv = WL.build_worklist(rows_u, R)
    return dict(hcus=hcus, n=n, A=A, rows_u=rows_u, counts=counts,
                zep_i=zep_i, zi_new=zep_i.z + counts, g_safe=g_safe,
                iv_old=iv_old, g_row=g_row, order=order, nv=nv)


def _ij_flats(hcus: H.HCUState):
    return (hcus.zij, hcus.eij, hcus.pij, hcus.wij, hcus.tij)


def worklist_lazy_rows(hcus: H.HCUState, rows, t, p: BCPNNParams,
                       fused: bool = True, layout=None):
    """Lazy worklist row phase on the stored planes (``layout``, None:
    flat): dedup + worklist build, then the touched rows rewritten in
    place. Returns (hcus', w_rows (H, A, C), common).

    ``fused``: one `ops.fused_row_update` call over the slot-ordered
    worklist (the H*R sentinel on padding and duplicate slots) rewrites
    the ij-plane rows and i-vector cells and returns the weight rows; it
    reads each slot's zj / pj from the (H, C) j-vectors itself.
    Unfused: one `ops.worklist_row_update` call that reads the same
    slot-ordered worklist through its valid-first compaction (``order``,
    ``nv``) and the j-vectors in place, then the i-vector writes, then the
    weight rows gathered back from the updated Wij. Both give the same
    bits."""
    c = _row_worklist_common(hcus, rows, t, p)
    hcus = c["hcus"]
    n, A = c["n"], c["A"]
    zep_i = c["zep_i"]
    coeffs = H.coeffs_ij(p)
    if fused:
        w_flat = ops.fused_row_update(
            *_ij_flats(hcus), hcus.zi, hcus.ei, hcus.pi, hcus.ti,
            rows=c["g_row"], now=t, counts=c["counts"].reshape(-1),
            zj=hcus.zj, p_i=zep_i.p.reshape(-1), pj=hcus.pj,
            zi_new=c["zi_new"].reshape(-1), ei_new=zep_i.e.reshape(-1),
            pi_new=zep_i.p.reshape(-1), coeffs=coeffs, eps=p.eps,
            layout=layout)
        return hcus, w_flat.reshape(n, A, p.cols), c
    HR = n * p.rows
    ops.worklist_row_update(
        *_ij_flats(hcus), g_row=c["g_row"], order=c["order"], nv=c["nv"],
        now=t, counts=c["counts"].reshape(-1), zj=hcus.zj,
        p_i=zep_i.p.reshape(-1), pj=hcus.pj, coeffs=coeffs, eps=p.eps,
        layout=layout)
    H.write_ivecs(hcus, H.drop_redirect(c["g_safe"], c["rows_u"] < p.rows),
                  t, (c["zi_new"], zep_i.e, zep_i.p), c["iv_old"])
    g_row = c["g_row"].long()
    w_g = L.as_layout(layout, p.rows, p.cols).read_row(
        hcus.wij, torch.clamp(g_row, max=HR - 1))                 # (W, C)
    w_rows = torch.where((g_row < HR)[:, None], w_g, 0.0)
    return hcus, w_rows.reshape(n, A, p.cols), c


def _column_worklist(hcus: H.HCUState, h_idx, j_idx, now, p: BCPNNParams,
                     n: int, layout=None):
    """Fused column phase (the port of `_column_worklist_megakernel` and
    its prologue): one `ops.fused_col_update` call decays the fired HCUs'
    i-vectors and rewrites every fired column of the five stored ij planes
    in place, then the Zj bump. Runs every tick; a tick where no HCU fired
    passes only padding entries, which the kernel skips."""
    ops.fused_col_update(*_ij_flats(hcus), hcus.zi, hcus.ei, hcus.pi,
                         hcus.ti, hcus.pj, h_idx=h_idx, j_idx=j_idx, now=now,
                         coeffs=H.coeffs_ij(p), coeffs_i=H.coeffs_i(p),
                         eps=p.eps, n_hcu=n, rows=p.rows, layout=layout)
    return hcus._replace(zj=_bump_zj(hcus.zj, h_idx, j_idx, n, p))


def worklist_col_dispatch(fused_cols: bool, h_idx, j_idx, t,
                          p: BCPNNParams, n: int, layout=None):
    """The worklist backend's lazy column phase as a hcus -> hcus' closure:
    the fused column kernel (`_column_worklist`), or the gathered-column
    step of the dense backend (`column_updates_batched`), both on the
    planes as ``layout`` stores them."""
    if fused_cols:
        return lambda hc: _column_worklist(hc, h_idx, j_idx, t, p, n, layout)
    return lambda hc: column_updates_batched(hc, h_idx, j_idx, t, p, layout)


def worklist_merged_rows(hcus: H.HCUState, jring, rows, t, p: BCPNNParams,
                         layout=None):
    """Merged worklist row phase on the stored planes (``layout``, None:
    flat): dedup and the worklist build, then every slot's row gathered
    through the layout's index map (`row_index`), `merged_row_math`
    on the (H, A, C) blocks against each HCU's ring (jring (H, C, M)), and
    the live rows and i-vector cells written back in place (padding and
    duplicate slots write their cells' old values, `hcu.put_drop`).
    Returns (hcus', w_rows (H, A, C), common): padding slots' weight rows
    are 0, as the unfused lazy phase's are."""
    c = _row_worklist_common(hcus, rows, t, p)
    hcus = c["hcus"]
    n, A = c["n"], c["A"]
    R, C = p.rows, p.cols
    lay = L.as_layout(layout, R, C)
    valid = c["rows_u"] < R                                      # (H, A)
    cell = lay.row_index(c["g_safe"])                            # (H, A, C)
    planes = tuple(getattr(hcus, f).view(-1) for f in ("zij", "eij", "pij",
                                                       "wij", "tij"))
    old = tuple(pl[cell] for pl in planes)
    zi_g, _, _, ti_g = c["iv_old"]
    z1, e1, p1, w1 = M.merged_row_math(
        old[0], old[1], old[2], old[4], jring, zi_g, ti_g, c["counts"],
        hcus.zj, c["zep_i"].p, hcus.pj, t, p)
    redirect = H.drop_redirect(cell, valid)
    for pl, v_new, v_old in zip(planes, (z1, e1, p1, w1, t), old):
        H.put_drop(pl, v_new, v_old, redirect)
    H.write_ivecs(hcus, H.drop_redirect(c["g_safe"], valid), t,
                  (c["zi_new"], c["zep_i"].e, c["zep_i"].p), c["iv_old"])
    return hcus, torch.where(valid[..., None], w1, 0.0), c


def _merged_worklist_update(hcus: H.HCUState, jring, rows, t, keys,
                            p: BCPNNParams, layout=None):
    """The worklist twin of the batched `merged.hcu_tick_merged`: merged
    row phase (`worklist_merged_rows`), the WTA, then `merged.merged_tail`
    (overflow flush, same-tick patch, ring push, Zj bump), every plane
    access in the stored layout. Returns (hcus', jring', fired)."""
    hcus, w_rows, c = worklist_merged_rows(hcus, jring, rows, t, p, layout)
    hcus, fired = H.periodic_update(hcus, w_rows, c["counts"], keys, p)
    hcus, jring = M.merged_tail(hcus, jring, fired, c["rows_u"], c["zi_new"],
                                t, p, layout)
    return hcus, jring, fired


# ---------------------------------------------------------------------------
# the TickBackend protocol and its two implementations
# ---------------------------------------------------------------------------

class TickBackend(Protocol):
    """A plane-update strategy pluggable into `tick`: hashable value
    objects (NamedTuples), so the drivers can key their captured chunks on
    them. `carry_in` / `carry_out` convert between the stored layout and
    the one the backend threads through a chunk; `plane_update` runs the
    row / WTA / column phases of one tick on the carry and returns
    (state', fired, h_idx, j_idx, n_dropped).

    `plane_update_split` is the same tick with the column phase deferred:
    it returns (state', fired, h_idx, j_idx, n_dropped, col), ``col`` an
    hcus -> hcus closure holding the column pass, or None where the mode
    runs everything up front (eager, merged). The sharded tick issues the
    spike exchange between the WTA and ``col`` (`tick`'s split route);
    applying ``col`` at once is `plane_update`."""

    def carry_in(self, state): ...

    def carry_out(self, state): ...

    def plane_update(self, state, rows, t, keys, p: BCPNNParams,
                     cap: int): ...

    def plane_update_split(self, state, rows, t, keys, p: BCPNNParams,
                           cap: int): ...


def _apply_columns(split):
    """`plane_update` from `plane_update_split`'s result: the deferred
    column pass applied at once."""
    state, fired, h_idx, j_idx, n_drop, col = split
    if col is not None:
        state = state._replace(hcus=col(state.hcus))
    return state, fired, h_idx, j_idx, n_drop


class DenseBackend(NamedTuple):
    """Plane updates of every HCU at once on the batched (H, R, C) view of
    the flat planes (a zero-copy reshape, `layout.batched_state`).

    mode: "lazy" (timestamped row and column updates: `hcu.hcu_tick_pre`
    and `column_updates_batched`), "eager" (the dense golden model,
    `reference.eager_tick`) or "merged" (eBrainIII ring-deferred columns,
    `merged.hcu_tick_merged`, on the state's rings `jring`). layout: the
    planes' stored layout (None: flat); a blocked one is converted to flat
    and back once per driver call (`carry_in` / `carry_out`, pure data
    movement), so the per-tick dense step is the flat one."""
    mode: str = "lazy"
    layout: L.BlockedLayout | None = None

    def carry_in(self, state):
        return state._replace(hcus=L.load_hcus(state.hcus, self.layout))

    def carry_out(self, state):
        return state._replace(hcus=L.store_hcus(state.hcus, self.layout))

    def plane_update(self, state, rows, t, keys, p: BCPNNParams, cap: int):
        """Row phase, WTA and column phase of one tick on the flat carry.
        Returns (state', fired, h_idx, j_idx, n_dropped)."""
        return _apply_columns(self.plane_update_split(state, rows, t, keys,
                                                      p, cap))

    def plane_update_split(self, state, rows, t, keys, p: BCPNNParams,
                           cap: int):
        """`plane_update` with the lazy column phase returned as a closure
        over the flat hcus (None in the eager and merged modes)."""
        n = state.delay_rows.shape[0]
        hb = L.batched_state(state.hcus, n)
        col = None
        if self.mode == "eager":
            hb, fired = reference.eager_tick(hb, rows, t, keys, p)
        elif self.mode == "merged":
            hb, jring, fired = M.hcu_tick_merged(hb, state.jring, rows, t,
                                                 keys, p)
            state = state._replace(jring=jring)
        elif self.mode == "lazy":
            hb, fired = H.hcu_tick_pre(hb, rows, t, keys, p)
        else:
            raise ValueError(f"unknown dense mode {self.mode!r}")
        h_idx, j_idx, n_drop = N.select_fired(fired, cap)
        if self.mode == "lazy":
            col = lambda hc: L.flat_state(column_updates_batched(
                L.batched_state(hc, n), h_idx, j_idx, t, p))
        return (state._replace(hcus=L.flat_state(hb)), fired, h_idx, j_idx,
                n_drop, col)


class WorklistBackend(NamedTuple):
    """Network-global worklist plane updates (the JAX package's
    `WorklistBackend`). mode: "lazy" or "merged" (`_merged_worklist_update`,
    on the state's rings `jring`). ``fused`` / ``fused_cols`` pick the
    lazy mode's fused row / column kernel or the unfused steps; all four
    combinations give the same bits; merged mode runs no kernel, so they
    are inert there, as in the JAX package. ``layout``: the planes' stored
    layout (None: flat); every step addresses the blocked tiles directly,
    so the carry is the stored state as it is."""
    mode: str = "lazy"
    fused: bool = True
    fused_cols: bool = True
    layout: L.BlockedLayout | None = None

    def carry_in(self, state):
        return state

    def carry_out(self, state):
        return state

    def plane_update(self, state, rows, t, keys, p: BCPNNParams, cap: int):
        """Row phase, WTA and column phase of one tick. Returns
        (state', fired, h_idx, j_idx, n_dropped)."""
        return _apply_columns(self.plane_update_split(state, rows, t, keys,
                                                      p, cap))

    def plane_update_split(self, state, rows, t, keys, p: BCPNNParams,
                           cap: int):
        """`plane_update` with the lazy column phase returned as a closure
        (`worklist_col_dispatch`; None in merged mode)."""
        n = state.delay_rows.shape[0]
        if self.mode == "merged":
            hcus, jring, fired = _merged_worklist_update(
                state.hcus, state.jring, rows, t, keys, p, self.layout)
            h_idx, j_idx, n_drop = N.select_fired(fired, cap)
            return (state._replace(hcus=hcus, jring=jring), fired, h_idx,
                    j_idx, n_drop, None)
        hcus, w_rows, c = worklist_lazy_rows(state.hcus, rows, t, p,
                                             fused=self.fused,
                                             layout=self.layout)
        hcus, fired = H.periodic_update(hcus, w_rows, c["counts"], keys, p)
        h_idx, j_idx, n_drop = N.select_fired(fired, cap)
        col = worklist_col_dispatch(self.fused_cols, h_idx, j_idx, t, p, n,
                                    self.layout)
        return state._replace(hcus=hcus), fired, h_idx, j_idx, n_drop, col


def select_backend(p: BCPNNParams, *, eager: bool = False,
                   merged: bool = False, worklist: bool | None = None,
                   fused: bool | None = None, fused_cols: bool | None = None,
                   layout=None):
    """Map the mode flags onto a backend, as the JAX package does: the
    eager golden model is dense; otherwise `hcu.use_worklist`'s size guard
    (R*C > 65536 takes the worklist backend) unless ``worklist=`` forces
    either, with ``fused`` / ``fused_cols`` (default on) choosing the
    worklist backend's row and column kernels. ``layout`` is resolved by
    `layout.resolve_layout` (None / "flat" / "blocked" / "blocked_tpu" /
    a layout instance; anything else raises ValueError) and becomes the
    backend's field. ``merged`` takes the backend the size guard picks in
    mode "merged"."""
    layout = L.resolve_layout(layout, p)
    if eager:
        return DenseBackend(mode="eager", layout=layout)
    mode = "merged" if merged else "lazy"
    if H.use_worklist(p, worklist):
        return WorklistBackend(mode=mode, fused=H.use_fused_rows(p, fused),
                               fused_cols=H.use_fused_cols(p, fused_cols),
                               layout=layout)
    return DenseBackend(mode=mode, layout=layout)


def tick(state: N.NetworkState, conn: N.Connectivity, ext_rows,
         p: BCPNNParams, be, cap_fire: int | None = None, *, gid_base=0,
         route=None, cond_columns: bool = True):
    """Advance the network one 1 ms tick (``state`` in the backend's carry
    layout, `carry_in`). The ij planes and i-vectors of ``state`` are
    rewritten in place; the other leaves of the returned state are new
    tensors. Returns (state', fired (H,) int32) with fired[h] = MCU index
    or -1. Every driver, local or sharded, runs this one body.

      gid_base      — global id of local HCU 0 (sharded: rank * h_local),
                      so each HCU's RNG stream folds its global id and the
                      trajectory does not depend on the rank count;
      route         — spike routing hook route(state, dest_h, dest_r,
                      delay, valid, p, n) -> state'; by default the local
                      `network.enqueue_spikes`. A route with `send` /
                      `recv` (`distributed.SparseExchange`) runs split:
                      the exchange is issued after the WTA and consumed
                      after the column pass, which neither reads nor
                      writes what the exchange does (delay queues and drop
                      counters against ij planes), so the split tick gives
                      the sequential one's bits;
      cond_columns  — the JAX package's gate of the column pass on "any
                      HCU fired?"; taken for its signature only: the port
                      runs the pass every tick, its padding entries
                      writing nothing, which gives the same bits.
    """
    n = state.delay_rows.shape[0]
    t = state.t + 1
    cap = cap_fire or max(2, int(0.35 * n) + 1)

    # 1. consume this tick's delay bucket and merge with external input
    state, bucket = N.consume_bucket(state, t, p)
    rows = torch.cat([bucket, ext_rows], dim=1)

    # 2. plane update (rows + WTA + columns), the JAX package's RNG stream
    k_t = rng.fold_in(state.base_key, t)
    keys = rng.fold_in(k_t, gid_base + torch.arange(n, device=rows.device))
    split = route is not None and hasattr(route, "send")
    if split:
        state, fired, h_idx, j_idx, n_drop, col = be.plane_update_split(
            state, rows, t, keys, p, cap)
    else:
        state, fired, h_idx, j_idx, n_drop = be.plane_update(state, rows, t,
                                                             keys, p, cap)
    state = state._replace(drops_fire=state.drops_fire + n_drop, t=t)

    # 3. fan out spikes from the fired batch into delay queues
    safe_h = torch.clamp(h_idx, max=n - 1).long()
    jl = j_idx.long()
    dest_h = conn.dest_hcu[safe_h, jl].reshape(-1)             # (K*F,)
    dest_r = conn.dest_row[safe_h, jl].reshape(-1)
    dly = conn.delay[safe_h, jl].reshape(-1)
    valid = (h_idx < n)[:, None].expand(-1, conn.dest_hcu.shape[2]).reshape(-1)
    if split:
        # 3a. bucket and issue the exchange; 2b. columns while it is in
        # flight; 3b. enqueue the delivered spikes
        state, inflight = route.send(state, dest_h, dest_r, dly, valid, p, n)
        if col is not None:
            state = state._replace(hcus=col(state.hcus))
        state = route.recv(state, inflight, p, n)
    else:
        state = (route or N.enqueue_spikes)(state, dest_h, dest_r, dly,
                                            valid, p, n)
    return state, fired


# ---------------------------------------------------------------------------
# Simulator facade
# ---------------------------------------------------------------------------

class Simulator:
    """End-to-end facade over the tick:

        sim = Simulator(p, key=0)              # on CUDA
        fired = sim.run(ext)                   # (T, H) fired history
        sim.reset()                            # a fresh state, same key

    ``device`` defaults to CUDA and raises without it; pass
    ``device="cpu"`` to run the plain PyTorch versions of the kernels on
    the CPU. ``layout`` (a `layout.resolve_layout` spec: None / "flat",
    "blocked" for the (8, 4) tile, "blocked_tpu", or a `BlockedLayout` of
    any tile) is the stored order of the ij planes, resolved once here and
    passed to every driver; the trajectory is the same under every layout.
    The held state is stored in that layout and is updated in place by
    every run; `hcus()` gives the batched (H, R, C) view in flat order and
    `flushed()` a fully current copy. The connectivity and the RNG stream
    are those of the JAX package's `Simulator` for the same key.
    ``merged=True`` runs the paper's eBrainIII ring-deferred columns
    (`repro_torch.core.merged`) on the backend the size guard picks; its
    state carries the per-column spike rings ``jring``. `save` / `load`
    checkpoint the held state in the JAX package's on-disk format
    (`repro_torch.checkpoint`), so either package restores the other's.

    `run` takes ``chunk`` ticks at a time (default 128, as in the JAX
    package): on CUDA one CUDA-graph replay a chunk, the graphs captured
    on the held state at their first use and kept with it in ``graphs``
    (`network.ChunkGraphs`, whose ``captured`` maps each chunk length to
    its graph). `reset`, `load`, `tick` and `run_host` rebind the state
    and drop them.
    """

    def __init__(self, p: BCPNNParams, key=0, *, n_hcu: int | None = None,
                 device=None, merged: bool = False, eager: bool = False,
                 worklist: bool | None = None, fused: bool | None = None,
                 fused_cols: bool | None = None, cap_fire: int | None = None,
                 chunk: int = 128, layout=None):
        self.device = resolve_device(device)
        self.p = p
        self.n_hcu = n_hcu or p.n_hcu
        self.merged, self.eager = merged, eager
        self.worklist, self.fused, self.fused_cols = worklist, fused, fused_cols
        self.cap_fire, self.chunk = cap_fire, chunk
        # None (flat) or a BlockedLayout ("blocked" -> the (8, 4) tile)
        self.layout = L.resolve_layout(layout, p)
        self.graphs = N.ChunkGraphs()
        self._mesh = None
        self.reset(key)

    def _kw(self):
        return dict(eager=self.eager, merged=self.merged,
                    worklist=self.worklist, fused=self.fused,
                    fused_cols=self.fused_cols, cap_fire=self.cap_fire,
                    layout=self.layout)

    @property
    def backend(self):
        """The plane backend that this Simulator's flags select."""
        return select_backend(self.p, eager=self.eager, merged=self.merged,
                              worklist=self.worklist, fused=self.fused,
                              fused_cols=self.fused_cols, layout=self.layout)

    def reset(self, key=None) -> "Simulator":
        """Re-init the network state (the same connectivity unless ``key``
        is given, then the new key's connectivity too) and drop the
        captured chunks. Returns self."""
        self.state = None                # freed before the new one is made
        self.graphs.clear()
        self._mesh = self._dist_cache = None
        if key is not None:
            self._key = (rng.PRNGKey(key, self.device) if isinstance(key, int)
                         else key.to(self.device))
            self.conn = N.make_connectivity(
                self.p, rng.fold_in(self._key, 1), self.n_hcu)
        self.state = N.init_network(self.p, self._key, self.n_hcu,
                                    merged=self.merged, layout=self.layout)
        return self

    def tick(self, ext_rows):
        """One 1 ms tick; ext_rows (H, A_ext). Returns fired (H,)."""
        ext_rows = torch.as_tensor(ext_rows).to(self.device, torch.int32)
        self._unshard()
        self.graphs.clear()
        self.state, fired = N.network_tick(self.state, self.conn, ext_rows,
                                           self.p, **self._kw())
        return fired

    def run(self, ext, n_ticks: int | None = None, chunk: int | None = None):
        """Run the ticks of `ext`: a staged (T, H, A_ext) array or tensor,
        an iterable of (H, A_ext) frames, or a callable ext_fn(t) (then
        pass n_ticks), ``chunk`` ticks at a time (default: the
        Simulator's). Returns the fired history (T, H) int32."""
        self._unshard()
        if callable(ext):
            ext = N.stage_external(ext, n_ticks, t0=int(self.state.t),
                                   device=self.device)
        else:
            ext = N.stage_external(ext, device=self.device)
        if n_ticks is not None:
            ext = ext[:n_ticks]
        self.state, fired = N.network_run(self.state, self.conn, ext, self.p,
                                          chunk=chunk or self.chunk,
                                          graphs=self.graphs, **self._kw())
        return fired

    def run_host(self, ext_fn, n_ticks: int):
        """Per-tick host-loop driver: ext_fn(t) gives tick t's (H, A_ext)
        input. Reads the time back to the host every tick, as the JAX
        package's host loop does. Returns the fired history (T, H)."""
        self._unshard()
        self.graphs.clear()
        self.state, fired = N.run(self.state, self.conn, ext_fn, n_ticks,
                                  self.p, **self._kw())
        return fired

    def run_sharded(self, ext, mesh=None, axis: str = "hcu", rc=None):
        """Run the ticks of the global (T, H, A_ext) input ``ext`` on an HCU
        mesh (`launch.mesh.HcuMesh`; default: every rank of the default
        process group, on this Simulator's device), ``chunk`` ticks at a
        time (`distributed.make_dist_run`: CUDA-graph chunks on an NCCL
        group, tick by tick on gloo). Every rank of the mesh calls it with
        the same input and gets the global (T, H) fired history.

        The first call on a mesh keeps only this rank's slice of the
        network (`distributed.shard_network`): ``state`` and ``conn`` are
        then the rank's, and stay so across calls. The driver is built once
        per (mesh, rc); ``rc`` defaults to `default_route_config` for the
        mesh. A later `tick`, `run`, `run_host`, `save` or `load` gathers
        the global network back first (a collective), as does a call on
        another mesh. ``axis`` names the mesh's one axis, as in the JAX
        package."""
        from repro_torch.core import distributed as DD
        from repro_torch.launch.mesh import make_bcpnn_mesh
        if self.merged:
            # the sharded runtime has no jring shard specs yet; silently
            # running the lazy backend would diverge from sim.run()
            raise NotImplementedError(
                "merged mode is not supported by the sharded runtime")
        if self.layout is not None:
            # the sharded drivers carry canonical flat planes; silently
            # dropping the blocked layout would diverge from sim.run()
            raise NotImplementedError(
                "blocked plane layouts are not supported by the sharded "
                "runtime (run with layout=None/'flat')")
        if mesh is None:
            mesh = self._mesh or make_bcpnn_mesh(device=self.device)
        if rc is None:
            rc = DD.default_route_config(self.p, self.n_hcu // mesh.size,
                                         mesh.size)
        if self._mesh != mesh:
            self._unshard()
            self.graphs.clear()
            self.state, self.conn = DD.shard_network(mesh, self.state,
                                                     self.conn)
            self._mesh = mesh
        if self._dist_cache is None or self._dist_cache[0] != rc:
            self._dist_cache = (rc, DD.make_dist_run(
                mesh, self.p, rc, eager=self.eager, worklist=self.worklist,
                fused=self.fused, fused_cols=self.fused_cols))
        ext = N.stage_external(ext)
        h = self.n_hcu // mesh.size
        ext = ext[:, mesh.rank * h:(mesh.rank + 1) * h]
        self.state, fired = self._dist_cache[1](self.state, self.conn, ext,
                                                chunk=self.chunk,
                                                graphs=self.graphs)
        return DD.gather_fired(mesh, fired)

    def _unshard(self) -> None:
        """Gather the global network back onto this Simulator's device
        after `run_sharded` (a collective of its mesh); a no-op when the
        held network is global."""
        if self._mesh is None:
            return
        from repro_torch.core import distributed as DD
        mesh, self._mesh, self._dist_cache = self._mesh, None, None
        self.graphs.clear()
        conn_specs = DD._shard_specs()[1]
        state = DD.gather_network(mesh, self.state)
        conn = DD.gather_network(mesh, self.conn, conn_specs)
        self.state = N.tree_map(lambda a: a.to(self.device), state)
        self.conn = N.tree_map(lambda a: a.to(self.device), conn)

    def save(self, ckpt_dir: str, step: int | None = None) -> str:
        """Checkpoint the held state (`checkpoint.save`: atomic, numpy
        leaves in the JAX package's format and dtypes, the key as two
        uint32 words), at step ``step`` (default: the current time). The
        manifest records the plane layout (`layout.layout_tag`), so a load
        under another layout converts. Returns the step directory."""
        from repro_torch.checkpoint import save as ckpt_save
        self._unshard()
        st = self.state
        step = int(st.t) if step is None else step
        return ckpt_save(ckpt_dir, step, st._replace(
            base_key=rng.key_data(st.base_key)),
            extra_meta={"layout": L.layout_tag(self.layout)})

    def load(self, ckpt_dir: str, step: int | None = None) -> "Simulator":
        """Restore the latest (or the given) step into this Simulator, on
        its device, and drop the captured chunks (as `reset` does: graphs
        are keyed by the held tensors). Checkpoints of the JAX package
        load as they are. Two shims, as in the JAX package: the legacy
        (H, R, C) layout and the missing trailing ``drops_route``
        (`checkpoint.restore_network`); and a checkpoint saved under one
        plane layout restores under any other (the manifest's layout tag,
        absent meaning flat, then `layout.convert_hcus`, pure data
        movement)."""
        from repro_torch.checkpoint import (latest_step, manifest,
                                            restore_network)
        if step is None:
            step = latest_step(ckpt_dir)
            if step is None:
                raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
        meta = manifest(ckpt_dir, step) or {}
        saved = L.layout_from_tag(meta.get("layout", "flat"), self.p)
        self._unshard()
        self.graphs.clear()
        if L.layout_tag(saved) == L.layout_tag(self.layout):
            self.state = restore_network(ckpt_dir, step, self.state)
        else:
            tmpl = self.state._replace(
                hcus=L.convert_hcus(self.state.hcus, self.layout, saved))
            st = restore_network(ckpt_dir, step, tmpl)
            self.state = st._replace(
                hcus=L.convert_hcus(st.hcus, saved, self.layout))
        return self

    def drops(self) -> dict:
        """Cumulative spike-drop counters {'in', 'fire', 'route'} (reads
        them back from the device). After `run_sharded`, what the JAX
        package reads from a sharded state: its rank 0's counters, on
        every rank (a collective, `distributed.drop_counters`)."""
        if self._mesh is not None:
            from repro_torch.core import distributed as DD
            return DD.drop_counters(self._mesh, self.state)
        return N.drop_counters(self.state)

    def hcus(self) -> H.HCUState:
        """Batched (H, R, C) view of the held state in flat order: under
        the flat layout a view that shares its storage, under a blocked
        layout a copy (the planes unpacked, `network.hcu_view`). After
        `run_sharded`, this rank's HCUs."""
        return N.hcu_view(self.state, self.layout)

    def flushed(self) -> H.HCUState:
        """Batched HCU state with every lazy trace brought current (new
        tensors); a merged state's rings are applied first
        (`merged.flush_merged`)."""
        if self.merged:
            return M.flush_merged(self.hcus(), self.state.jring, self.state.t,
                                  self.p)
        return H.flush(self.hcus(), self.state.t, self.p)
