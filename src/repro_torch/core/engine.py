"""The lazy BCPNN tick on the worklist backend (the port of the
`repro.core.engine` path that `select_backend` takes at rodent and human
widths).

A network tick has one skeleton

    consume delay bucket -> plane update (rows / WTA / columns) -> fan out

and the plane update is the `WorklistBackend`: one network-global
deduplicated worklist over the flat (H*R, C) planes per tick, the row
phase as one `ops.fused_row_update` launch, the soft WTA, and the column
phase as one `ops.fused_col_update` launch. The ij planes and i-vectors
are rewritten in place by those two calls; everything else in the tick is
plain torch on small tensors.

The tick reads no device value on the host (no `.item()`, no `int()` of
a tensor, no boolean-mask indexing): the current time stays a device
tensor that the kernels read through a pointer, and the column launch
runs every tick, its padding entries exiting at once where the JAX package
gates the pass with `lax.cond`. A chunk of ticks can therefore later be
captured in one CUDA graph.

`Simulator` is the user-facing facade. Its tensors live on ``device``:
CUDA unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch

from repro_torch.core import hcu as H
from repro_torch.core import layout as L
from repro_torch.core import network as N
from repro_torch.core import rng
from repro_torch.core import worklist as WL
from repro_torch.core.params import BCPNNParams
from repro_torch.core.traces import ZEP, decay_zep
from repro_torch.kernels import ops


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA, and raises where there is none: the port never
    falls back to the CPU unless the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "port on the CPU")
        device = "cuda"
    return torch.device(device)


# ---------------------------------------------------------------------------
# plane-update building blocks
# ---------------------------------------------------------------------------

def _bump_zj(zj, h_idx, j_idx, n: int):
    """Postsynaptic Z increment (+1.0) at the fired batch's (h, j) cells;
    padding entries (h_idx == n) are dropped. Returns a new tensor."""
    C = zj.shape[1]
    idx = torch.where(h_idx < n, h_idx * C + j_idx, n * C).long()
    bump = torch.zeros(n * C + 1, dtype=zj.dtype, device=zj.device)
    bump.index_fill_(0, idx, 1.0)
    return zj + bump[:n * C].reshape(n, C)


def _row_worklist_common(hcus: H.HCUState, rows, t, p: BCPNNParams):
    """Row-phase prologue on the flat layout: j-vector decay, per-HCU
    dedup, i-vector decay and the worklist build. Returns a dict of
    intermediates; the i-vector values are (H, A), indexed by slot."""
    n, A = rows.shape
    R = p.rows
    zep_j = decay_zep(ZEP(hcus.zj, hcus.ej, hcus.pj), p.dt_ms, H.coeffs_j(p))
    hcus = hcus._replace(zj=zep_j.z, ej=zep_j.e, pj=zep_j.p)
    rows_u, counts = H.dedup_rows(rows, R)
    safe = torch.clamp(rows_u, max=R - 1).long()
    g_safe = torch.arange(n, device=rows.device)[:, None] * R + safe  # (H, A)
    zep_i = H.ivec_decay(hcus.zi[g_safe], hcus.ei[g_safe], hcus.pi[g_safe],
                         hcus.ti[g_safe], t, p)
    g_row, order, nv = WL.build_worklist(rows_u, R)
    return dict(hcus=hcus, n=n, A=A, rows_u=rows_u, counts=counts,
                zep_i=zep_i, zi_new=zep_i.z + counts,
                g_row=g_row, order=order, nv=nv)


def _ij_flats(hcus: H.HCUState):
    return (hcus.zij, hcus.eij, hcus.pij, hcus.wij, hcus.tij)


def worklist_lazy_rows(hcus: H.HCUState, rows, t, p: BCPNNParams):
    """Lazy worklist row phase: dedup + worklist build, then one
    `ops.fused_row_update` call over the slot-ordered worklist (the H*R
    sentinel on padding and duplicate slots), which rewrites the touched
    ij-plane rows and i-vector cells in place and returns the h-major
    weight rows for the WTA. Returns (hcus', w_rows (H, A, C), common)."""
    c = _row_worklist_common(hcus, rows, t, p)
    hcus = c["hcus"]
    n, A = c["n"], c["A"]
    h_of = torch.arange(n * A, device=rows.device) // A
    zep_i = c["zep_i"]
    w_flat = ops.fused_row_update(
        *_ij_flats(hcus), hcus.zi, hcus.ei, hcus.pi, hcus.ti,
        rows=c["g_row"], now=t, counts=c["counts"].reshape(-1),
        zj=hcus.zj[h_of], p_i=zep_i.p.reshape(-1), pj=hcus.pj[h_of],
        zi_new=c["zi_new"].reshape(-1), ei_new=zep_i.e.reshape(-1),
        pi_new=zep_i.p.reshape(-1), coeffs=H.coeffs_ij(p), eps=p.eps)
    return hcus, w_flat.reshape(n, A, p.cols), c


def _wta(hcus: H.HCUState, w_rows, counts, keys, p: BCPNNParams):
    """Periodic update (support integration + soft WTA) of every HCU; same
    RNG stream as the JAX package's per-HCU `periodic_math`."""
    h_new, fired = H.periodic_math(hcus.h, hcus.pj, w_rows, counts, keys, p)
    return hcus._replace(h=h_new), fired


def _col_worklist_prologue(hcus: H.HCUState, h_idx, j_idx, now,
                           p: BCPNNParams, n: int):
    """Per-entry presynaptic traces brought to `now` ((K, R), values only)
    and the per-entry postsynaptic P."""
    R = p.rows
    safe_h = torch.clamp(h_idx, max=n - 1).long()
    ivr = lambda v: v.reshape(n, R)[safe_h]
    zep_i = H.ivec_decay(ivr(hcus.zi), ivr(hcus.ei), ivr(hcus.pi),
                         ivr(hcus.ti), now, p)
    pj_sc = hcus.pj[safe_h, j_idx.long()]
    return zep_i, pj_sc


def _column_worklist(hcus: H.HCUState, h_idx, j_idx, now, p: BCPNNParams,
                     n: int):
    """Fused column phase (the port of `_column_worklist_megakernel`): one
    `ops.fused_col_update` call rewrites every fired column of the five ij
    planes in place, then the Zj bump. Runs every tick; a tick where no
    HCU fired passes only padding entries, which the kernel skips."""
    zep_i, pj_sc = _col_worklist_prologue(hcus, h_idx, j_idx, now, p, n)
    ops.fused_col_update(*_ij_flats(hcus), h_idx=h_idx, j_idx=j_idx, now=now,
                         zi_t=zep_i.z, p_i=zep_i.p, pj_sc=pj_sc,
                         coeffs=H.coeffs_ij(p), eps=p.eps, n_hcu=n,
                         rows=p.rows)
    return hcus._replace(zj=_bump_zj(hcus.zj, h_idx, j_idx, n))


# ---------------------------------------------------------------------------
# the backend and the one tick body
# ---------------------------------------------------------------------------

class WorklistBackend:
    """Network-global worklist plane updates on the flat planes, lazy mode,
    with the fused row and column phases (the JAX package's
    `WorklistBackend(mode="lazy", fused=True, fused_cols=True)`)."""

    def plane_update(self, state, rows, t, keys, p: BCPNNParams, cap: int):
        """Row phase, WTA and column phase of one tick. Returns
        (state', fired, h_idx, j_idx, n_dropped)."""
        n = state.delay_rows.shape[0]
        hcus, w_rows, c = worklist_lazy_rows(state.hcus, rows, t, p)
        hcus, fired = _wta(hcus, w_rows, c["counts"], keys, p)
        h_idx, j_idx, n_drop = N.select_fired(fired, cap)
        hcus = _column_worklist(hcus, h_idx, j_idx, t, p, n)
        return state._replace(hcus=hcus), fired, h_idx, j_idx, n_drop


def select_backend(p: BCPNNParams, *, eager: bool = False,
                   merged: bool = False, worklist: bool | None = None,
                   fused: bool | None = None, fused_cols: bool | None = None,
                   layout=None) -> WorklistBackend:
    """The port's tick backend. Only the lazy worklist backend with fused
    row and column phases on the flat layout is ported; it runs at every
    size (the JAX package picks its dense backend for R*C <= 65536, and the
    two are held to the same trajectory by the head fixtures). Every other
    choice raises, naming the ROADMAP item that ports it."""
    missing = [
        (eager, "the eager golden model (ROADMAP queue A item 5)"),
        (merged, "merged mode (ROADMAP queue A item 6)"),
        (layout not in (None, "flat"),
         "blocked plane layouts (ROADMAP queue A item 7)"),
        (worklist is False, "the dense backend (ROADMAP queue A item 5)"),
        (fused is False,
         "the unfused worklist row kernel (ROADMAP queue B item 3)"),
        (fused_cols is False,
         "the unfused column path (ROADMAP queue B item 5)"),
    ]
    for asked, what in missing:
        if asked:
            raise NotImplementedError(f"{what} is not ported to PyTorch yet")
    return WorklistBackend()


def tick(state: N.NetworkState, conn: N.Connectivity, ext_rows,
         p: BCPNNParams, be: WorklistBackend, cap_fire: int | None = None):
    """Advance the network one 1 ms tick. The ij planes and i-vectors of
    ``state`` are rewritten in place; the other leaves of the returned
    state are new tensors. Returns (state', fired (H,) int32) with
    fired[h] = MCU index or -1."""
    n = state.delay_rows.shape[0]
    t = state.t + 1
    cap = cap_fire or max(2, int(0.35 * n) + 1)

    # 1. consume this tick's delay bucket and merge with external input
    state, bucket = N.consume_bucket(state, t, p)
    rows = torch.cat([bucket, ext_rows], dim=1)

    # 2. plane update (rows + WTA + columns), the JAX package's RNG stream
    k_t = rng.fold_in(state.base_key, t)
    keys = rng.fold_in(k_t, torch.arange(n, device=rows.device))
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
    state = N.enqueue_spikes(state, dest_h, dest_r, dly, valid, p, n)
    return state, fired


# ---------------------------------------------------------------------------
# Simulator facade
# ---------------------------------------------------------------------------

class Simulator:
    """End-to-end facade over the tick:

        sim = Simulator(p, key=0)              # on CUDA
        fired = sim.run(ext)                   # (T, H) fired history

    ``device`` defaults to CUDA and raises without it; pass
    ``device="cpu"`` to run the plain PyTorch versions of the kernels on
    the CPU. The held state is in the flat layout and is updated in place
    by every run; `hcus()` gives the batched (H, R, C) view and `flushed()`
    a fully current copy. The connectivity and the RNG stream are those of
    the JAX package's `Simulator` for the same key.
    """

    def __init__(self, p: BCPNNParams, key=0, *, n_hcu: int | None = None,
                 device=None, cap_fire: int | None = None,
                 worklist: bool | None = None, eager: bool = False,
                 merged: bool = False, layout=None):
        self.device = resolve_device(device)
        select_backend(p, eager=eager, merged=merged, worklist=worklist,
                       layout=layout)
        self.p = p
        self.n_hcu = n_hcu or p.n_hcu
        self.cap_fire = cap_fire
        self._key = (rng.PRNGKey(key, self.device) if isinstance(key, int)
                     else key.to(self.device))
        self.conn = N.make_connectivity(p, rng.fold_in(self._key, 1),
                                        self.n_hcu)
        self.state = N.init_network(p, self._key, self.n_hcu)

    def tick(self, ext_rows):
        """One 1 ms tick; ext_rows (H, A_ext). Returns fired (H,)."""
        ext_rows = torch.as_tensor(ext_rows).to(self.device, torch.int32)
        self.state, fired = tick(self.state, self.conn, ext_rows, self.p,
                                 select_backend(self.p), self.cap_fire)
        return fired

    def run(self, ext, n_ticks: int | None = None):
        """Run the ticks of `ext`: a staged (T, H, A_ext) array or tensor,
        an iterable of (H, A_ext) frames, or a callable ext_fn(t) (then
        pass n_ticks). Returns the fired history (T, H) int32."""
        if callable(ext):
            ext = N.stage_external(ext, n_ticks, t0=int(self.state.t),
                                   device=self.device)
        else:
            ext = N.stage_external(ext, device=self.device)
        if n_ticks is not None:
            ext = ext[:n_ticks]
        self.state, fired = N.network_run(self.state, self.conn, ext, self.p,
                                          cap_fire=self.cap_fire)
        return fired

    def run_sharded(self, *args, **kwargs):
        raise NotImplementedError("the sharded runtime is not ported to "
                                  "PyTorch yet (ROADMAP queue A item 11)")

    def save(self, *args, **kwargs):
        raise NotImplementedError("checkpoints are not ported to PyTorch yet "
                                  "(ROADMAP queue A item 8)")

    def load(self, *args, **kwargs):
        raise NotImplementedError("checkpoints are not ported to PyTorch yet "
                                  "(ROADMAP queue A item 8)")

    def drops(self) -> dict:
        """Cumulative spike-drop counters {'in', 'fire', 'route'} (reads
        them back from the device)."""
        return N.drop_counters(self.state)

    def hcus(self) -> H.HCUState:
        """Batched (H, R, C) view of the held state (shares its storage)."""
        return L.batched_state(self.state.hcus, self.n_hcu)

    def flushed(self) -> H.HCUState:
        """Batched HCU state with every lazy trace brought current (new
        tensors)."""
        return H.flush(self.hcus(), self.state.t, self.p)
