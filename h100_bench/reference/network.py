"""The plain reference of the lazy BCPNN network: plain PyTorch, written
from the model's equations (paper §II-III, Fig 2) and its lazy evaluation
order, importing nothing of the program.

What it holds:

* `Params` — the network's numbers, read from a configuration file;
* `connectivity` — each minicolumn's `fanout` targets (HCU, row, delay),
  drawn from the seed's key with `threefry`, in blocks;
* `RefNet` — a chosen set of HCUs simulated tick by tick: the delay-queue
  bucket they consume, the row phase (lazy decay, Hebbian increment and
  Bayesian weight of every delivered row), the support and the soft-WTA
  scores, the column phase of each fired minicolumn, the j-vector bump,
  and the fan-out into their own delay queues. The spikes of the other
  HCUs are read from the fired history that is being judged (teacher
  forcing), and so are each simulated HCU's own winners, so that one
  rounding-level difference cannot grow into a different trajectory;
* `queue_counts` — every HCU's delay-queue counts and the drop counters,
  replayed from a fired history.

The ij planes of `RefNet` may be held in bfloat16 (the control): each cell
is then computed in float32 from the stored values and rounded back.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from h100_bench.reference import threefry as TF


@dataclasses.dataclass(frozen=True)
class Params:
    n_hcu: int
    rows: int
    cols: int
    fanout: int
    tau_zi: float = 5.0
    tau_zj: float = 5.0
    tau_e: float = 100.0
    tau_p: float = 1000.0
    tau_m: float = 10.0
    dt_ms: float = 1.0
    out_rate: float = 0.1
    active_queue: int = 36
    max_delay: int = 16
    mean_delay: float = 4.0
    eps: float = 1e-4
    p_init: float = 0.01
    wta_temp: float = 1.0

    @classmethod
    def from_dict(cls, d: dict) -> "Params":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @property
    def tau_z_ij(self) -> float:
        return (self.tau_zi * self.tau_zj) / (self.tau_zi + self.tau_zj)

    def fire_cap(self, cap_fire: int | None) -> int:
        """Slots of a tick's fired batch: fired HCUs past it are dropped."""
        return cap_fire or max(2, int(0.35 * self.n_hcu) + 1)


class Coeffs(NamedTuple):
    inv_tau_z: float
    inv_tau_e: float
    inv_tau_p: float
    c_ze: float
    c_ep: float
    c_zp: float


def coeffs(tau_z: float, tau_e: float, tau_p: float) -> Coeffs:
    return Coeffs(1.0 / tau_z, 1.0 / tau_e, 1.0 / tau_p, tau_z / (tau_z - tau_e),
                  tau_e / (tau_e - tau_p), tau_z / (tau_z - tau_p))


def decay(z0, e0, p0, dt, k: Coeffs):
    """Exact Z -> E -> P cascade across a silent gap of dt ms (a float32
    tensor, or a number taken as a float32 scalar)."""
    if not torch.is_tensor(dt):
        dt = torch.tensor(dt, dtype=torch.float32)
    ez = torch.exp(-dt * k.inv_tau_z)
    ee = torch.exp(-dt * k.inv_tau_e)
    ep = torch.exp(-dt * k.inv_tau_p)
    e1 = e0 * ee + z0 * (ez - ee) * k.c_ze
    p1 = (p0 * ep
          + (e0 - z0 * k.c_ze) * (ee - ep) * k.c_ep
          + z0 * k.c_ze * (ez - ep) * k.c_zp)
    return z0 * ez, e1, p1


def cell(z, e, p, dt, dz, p_pre, p_post, k: Coeffs, eps: float):
    """One lazy cell update: decay across dt, the Hebbian increment dz,
    the Bayesian weight log(Pij / (Pi Pj)), regularised by eps."""
    ez = torch.exp(-dt * k.inv_tau_z)
    ee = torch.exp(-dt * k.inv_tau_e)
    ep = torch.exp(-dt * k.inv_tau_p)
    e1 = e * ee + z * (ez - ee) * k.c_ze
    p1 = (p * ep
          + (e - z * k.c_ze) * (ee - ep) * k.c_ep
          + z * k.c_ze * (ez - ep) * k.c_zp)
    z1 = z * ez + dz
    w1 = torch.log((p1 + eps * eps) / ((p_pre + eps) * (p_post + eps)))
    return z1, e1, p1, w1


def dedup(rows, n_rows: int):
    """Per HCU (last axis): the delivered rows sorted, each distinct row
    once with its multiplicity, the rest (and padding) n_rows with 0."""
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
    return torch.where(keep, a, n_rows), torch.where(keep, counts, 0.0)


# ---------------------------------------------------------------------------
# keys and connectivity
# ---------------------------------------------------------------------------

def base_key(key):
    """The key of the per-tick draws."""
    return TF.fold_in(key, 0x5EED)


class Connectivity(NamedTuple):
    dest_hcu: torch.Tensor   # (n, C, F) int32
    dest_row: torch.Tensor
    delay: torch.Tensor


def connectivity(p: Params, key, block: int = 1 << 24) -> Connectivity:
    """Every minicolumn's fanout targets: HCU and row uniform, the delay
    1 + a geometric draw of mean mean_delay - 1, in [1, max_delay - 1].
    Drawn ``block`` entries at a time."""
    n = p.n_hcu
    N = n * p.cols * p.fanout
    k = TF.split(TF.fold_in(key, 1), 3)
    kh, kr = TF.split(k[0], 2), TF.split(k[1], 2)
    lam = 1.0 / max(p.mean_delay - 1.0, 1e-3)
    dev = key.device
    dest_hcu = torch.empty(N, dtype=torch.int32, device=dev)
    dest_row = torch.empty(N, dtype=torch.int32, device=dev)
    delay = torch.empty(N, dtype=torch.int32, device=dev)
    for lo in range(0, N, block):
        hi = min(N, lo + block)
        dest_hcu[lo:hi] = TF.randint_block(kh, N, lo, hi, 0, n)
        dest_row[lo:hi] = TF.randint_block(kr, N, lo, hi, 0, p.rows)
        u = TF.uniform_from_bits(TF.bits_block(k[2], N, lo, hi))
        u = torch.clamp(u * (torch.tensor(1.0) - torch.tensor(0.0))
                        + torch.tensor(0.0), min=0.0)
        geo = torch.floor(torch.log1p(-u) / -lam).to(torch.int32)
        delay[lo:hi] = torch.clamp(1 + geo, 1, p.max_delay - 1)
    shape = (n, p.cols, p.fanout)
    return Connectivity(dest_hcu.view(shape), dest_row.view(shape),
                        delay.view(shape))


def fired_batch(fired, cap: int):
    """fired (..., n) winners (-1: silent) -> the same with the HCUs past
    the fired batch's ``cap`` slots (in HCU order) silenced: the spikes that
    fan out and update a column."""
    on = fired >= 0
    rank = torch.cumsum(on.to(torch.int64), dim=-1)
    return torch.where(on & (rank <= cap), fired, -1)


def fire_draws(p: Params, key_b, t0: int, T: int, block: int = 64):
    """(T, n) bool: whether each HCU fires at ticks t0 .. t0+T-1, which the
    WTA draws from the tick's key alone."""
    dev = key_b.device
    gids = torch.arange(p.n_hcu, device=dev)
    rate = p.out_rate * p.dt_ms
    out = torch.empty((T, p.n_hcu), dtype=torch.bool, device=dev)
    for lo in range(0, T, block):
        hi = min(T, lo + block)
        ts = torch.arange(t0 + lo, t0 + hi, device=dev)
        kt = TF.fold_in(key_b, ts)                                # (b, 2)
        keys = TF.fold_in(kt[:, None, :], gids[None, :])          # (b, n, 2)
        k0 = TF.split(keys)[..., 0, :]
        out[lo:hi] = TF.uniform(k0, 1)[..., 0] < rate
    return out


def queue_counts(p: Params, conn: Connectivity, fired, t0: int, cap: int,
                 count0=None, drops0=(0, 0), block: int = 64):
    """Replay every HCU's delay-queue counts over the fired history fired
    (T, n) of ticks t0+1 .. t0+T: each tick empties its bucket, then each
    fired-batch spike's fanout lands in bucket (t + delay) mod D of its
    target, up to active_queue. Returns (counts (n, D), drops_in,
    drops_fire) added to ``count0`` and ``drops0``."""
    n, D, A = p.n_hcu, p.max_delay, p.active_queue
    dev = fired.device
    count = (torch.zeros((n, D), dtype=torch.int64, device=dev)
             if count0 is None else count0.to(torch.int64).clone())
    d_in = torch.zeros((), dtype=torch.int64, device=dev)
    on_all = fired >= 0
    d_fire = drops0[1] + int(torch.clamp(on_all.sum(1) - cap, min=0).sum())
    batch = fired_batch(fired, cap)
    for lo in range(0, fired.shape[0], block):
        b = batch[lo:lo + block]
        k, h = torch.nonzero(b >= 0, as_tuple=True)
        j = b[k, h].long()
        t = t0 + 1 + lo + k
        dst = conn.dest_hcu[h, j].long()                          # (m, F)
        bkt = (t[:, None] + conn.delay[h, j].long()) % D
        key = (k[:, None] * n + dst) * D + bkt
        arr = torch.bincount(key.reshape(-1),
                             minlength=b.shape[0] * n * D).view(-1, n, D)
        for i in range(b.shape[0]):
            count[:, (t0 + 1 + lo + i) % D] = 0
            new = torch.clamp(count + arr[i], max=A)
            d_in += (count + arr[i] - new).sum()
            count = new
    return count, drops0[0] + int(d_in), d_fire


# ---------------------------------------------------------------------------
# the simulated HCUs
# ---------------------------------------------------------------------------

class RefNet:
    """The HCUs ``sample`` (a (S,) int64 tensor of HCU ids) of the network,
    from their initial state or a given one (`load`).

    One tick is `tick`: the delay-queue bucket, the row phase, the support
    and the WTA scores, the column phase of the sample's fired minicolumns,
    the j-vector bump and the fan-out into the sample's queues. Its inputs
    are the tick's own (time, drive, the network's fired batch, the sample's
    winners, the WTA's noise and fire draws, `draws`); every shape is
    fixed and nothing is read back to the host, so a run of ticks can be
    captured in a CUDA graph (`judge.replay` does). Entries that write
    nothing (padding slots, silent HCUs, messages to other HCUs) write to a
    spare row or slot past the end of the state."""

    PLANES = ("zij", "eij", "pij", "wij")

    def __init__(self, p: Params, sample, key, conn: Connectivity,
                 plane_dtype=torch.float32):
        self.p, self.sample = p, sample
        self.key_b = base_key(key)
        self.dtype = plane_dtype
        dev = self.dev = sample.device
        S, R, C = sample.shape[0], p.rows, p.cols
        D, A = p.max_delay, p.active_queue
        self.S = S
        self.kij = coeffs(p.tau_z_ij, p.tau_e, p.tau_p)
        self.ki = coeffs(p.tau_zi, p.tau_e, p.tau_p)
        self.kj = coeffs(p.tau_zj, p.tau_e, p.tau_p)
        f32 = dict(dtype=torch.float32, device=dev)
        pij0 = torch.full((1, 1), p.p_init * p.p_init, **f32)
        pi0 = torch.full((1, 1), p.p_init, **f32)
        w0 = torch.log((pij0 + p.eps**2) / ((pi0 + p.eps) * (pi0 + p.eps)))
        G = (S + 1) * R                        # the last R rows are a spare HCU
        self.state = dict(
            zij=torch.zeros((G, C), **f32), eij=torch.zeros((G, C), **f32),
            pij=pij0.expand(G, C).clone(), wij=w0.expand(G, C).clone(),
            tij=torch.zeros((G, C), dtype=torch.int32, device=dev),
            zi=torch.zeros(G, **f32), ei=torch.zeros(G, **f32),
            pi=pi0.reshape(1).expand(G).clone(),
            ti=torch.zeros(G, dtype=torch.int32, device=dev),
            zj=torch.zeros((S, C), **f32), ej=torch.zeros((S, C), **f32),
            pj=torch.full((S, C), p.p_init, **f32), h=torch.zeros((S, C), **f32),
            delay_rows=torch.full((S * D * A + 1,), R, dtype=torch.int32,
                                  device=dev),
            delay_count=torch.zeros((S, D), dtype=torch.int32, device=dev))
        for f in self.PLANES:
            self.state[f] = self.state[f].to(plane_dtype)
        # the synapses into the sample, in (source HCU, minicolumn, fanout
        # slot) order: the order in which a tick's spikes are enqueued; a
        # spare entry at the end
        local = torch.full((p.n_hcu,), -1, dtype=torch.int64, device=dev)
        local[sample] = torch.arange(S, device=dev)
        to = local[conn.dest_hcu.reshape(-1).long()]
        idx = torch.nonzero(to >= 0).squeeze(1)
        CF = p.cols * p.fanout
        spare = lambda x, v: torch.cat([x, x.new_full((1,), v)])
        self.in_src = spare(idx // CF, 0)
        self.in_col = spare((idx // p.fanout) % p.cols, -2)   # never fired
        self.in_dst = spare(to[idx], S)
        self.in_row = spare(conn.dest_row.reshape(-1)[idx].long(), R)
        self.in_delay = spare(conn.delay.reshape(-1)[idx].long(), 1)
        self.M = idx.shape[0]
        # fixed capacities of a tick's fired sample HCUs and of its spikes
        # into the sample, far above what the rates give (a tick past them
        # is counted in `overflow`)
        rate = min(1.0, p.out_rate * p.dt_ms)
        self.Kc = min(S, int(S * rate + 8 * (S * rate) ** 0.5) + 8)
        self.Mc = min(self.M, int(4 * S * p.fanout * rate) + 1024)
        self.rows_of = (torch.arange(S + 1, device=dev)[:, None] * R
                        + torch.arange(R, device=dev))            # (S+1, R)
        self.gap = torch.zeros((), **f32)
        self.mismatch = torch.zeros((), dtype=torch.int64, device=dev)
        self.overflow = torch.zeros((), dtype=torch.int64, device=dev)

    # -- state ----------------------------------------------------------------
    def snapshot(self) -> dict:
        """The sample's state in the program's terms (new tensors, float32
        planes): planes (S*R, C), i-vectors (S*R,), j-vectors (S, C), delay
        queues (S, D, A) and counts (S, D)."""
        p, st = self.p, self.state
        SR = self.S * p.rows
        out = {k: v[:SR].clone() for k, v in st.items()
               if k in self.PLANES + ("tij", "zi", "ei", "pi", "ti")}
        for f in self.PLANES:
            out[f] = out[f].float()
        for f in ("zj", "ej", "pj", "h", "delay_count"):
            out[f] = st[f].clone()
        out["delay_rows"] = st["delay_rows"][:-1].view(
            self.S, p.max_delay, p.active_queue).clone()
        return out

    def load(self, snap: dict) -> None:
        """Copy a state of `snapshot`'s form into this one, in place."""
        st, SR = self.state, self.S * self.p.rows
        for k, v in snap.items():
            if k in self.PLANES + ("tij", "zi", "ei", "pi", "ti"):
                dst = st[k][:SR]
            elif k == "delay_rows":
                dst = st[k][:-1]
            else:
                dst = st[k]
            dst.copy_(v.reshape(dst.shape))

    def draws(self, t0: int, T: int):
        """(fire (T, S) bool, noise (T, S, C)): the WTA's draws of ticks
        t0 .. t0+T-1 for the sample, from the per-tick keys."""
        ts = torch.arange(t0, t0 + T, device=self.dev)
        kt = TF.fold_in(self.key_b, ts)
        keys = TF.split(TF.fold_in(kt[:, None, :], self.sample[None, :]))
        fire = TF.uniform(keys[..., 0, :], 1)[..., 0] < self.p.out_rate * self.p.dt_ms
        return fire, TF.gumbel(keys[..., 1, :], self.p.cols)

    # -- a tick -----------------------------------------------------------------
    def tick(self, t, ext_rows, batch_all, winners, fired, noise, fire):
        """One tick at time t (an int32 tensor). ext_rows (S, width): the
        drive; batch_all (n,): the network's fired batch; winners (S,): the
        sample's fired batch; fired (S,): the sample's fired history, which
        the gap is read at; noise (S, C), fire (S,): the tick's draws.
        Returns the WTA scores (S, C), Gumbel noise included."""
        p, st, S = self.p, self.state, self.S
        R, C, D, A = p.rows, p.cols, p.max_delay, p.active_queue
        junk = S * R                          # the spare HCU's first row
        dev = self.dev
        # the bucket of this tick, emptied
        b = (t % D).reshape(1).long()
        queue = st["delay_rows"][:-1].view(S, D, A)
        bucket = queue.index_select(1, b)[:, 0, :]
        queue.index_fill_(1, b, R)
        st["delay_count"].index_fill_(1, b, 0)
        rows = torch.cat([bucket, ext_rows.to(torch.int32)], dim=1)
        zj, ej, pj = decay(st["zj"], st["ej"], st["pj"], p.dt_ms, self.kj)
        # the row phase of every delivered row
        rows_u, counts = dedup(rows, R)
        valid = rows_u < R
        g = self.rows_of[:S, :1] + torch.clamp(rows_u, max=R - 1).long()
        gw = torch.where(valid, g, junk)                            # (S, A)
        zi_d, ei_d, pi_d = decay(st["zi"][g], st["ei"][g], st["pi"][g],
                                 (t - st["ti"][g]).to(torch.float32), self.ki)
        dt = (t - st["tij"][g]).to(torch.float32)
        z1, e1, p1, w1 = cell(
            st["zij"][g].float(), st["eij"][g].float(), st["pij"][g].float(),
            dt, counts[..., None] * zj[:, None, :], pi_d[..., None],
            pj[:, None, :], self.kij, p.eps)
        for f, v in zip(self.PLANES, (z1, e1, p1, w1)):
            st[f][gw] = v.to(self.dtype)
        st["tij"][gw] = t
        st["zi"][gw] = zi_d + counts
        st["ei"][gw] = ei_d
        st["pi"][gw] = pi_d
        st["ti"][gw] = t
        # support and scores: the rows' weights as the row phase left them
        w_rows = torch.where(valid[..., None], w1.to(self.dtype).float(), 0.0)
        drive = torch.sum(counts[..., None] * w_rows, dim=-2)
        decay_m = torch.exp(torch.tensor(-p.dt_ms / p.tau_m,
                                         dtype=torch.float32))
        h = st["h"] * decay_m + drive
        s = h + torch.log(pj + p.eps)
        scores = noise + s / p.wta_temp
        on = fired >= 0
        best = scores.max(dim=1).values
        at = scores.gather(1, torch.clamp(fired, min=0).long()[:, None])[:, 0]
        self.gap.copy_(torch.maximum(self.gap,
                                     torch.where(on, best - at, 0.0).max()))
        self.mismatch.add_((fire != on).sum())
        # the column phase of the sample's fired minicolumns (the first Kc
        # of them; the spare HCU S fills the other slots)
        live = winners >= 0
        hk = compact(live, self.Kc, S)
        self.overflow.add_(torch.clamp(live.sum() - self.Kc, min=0))
        w = torch.cat([winners, winners.new_full((1,), -1)])[hk]
        ok = w >= 0
        j = torch.clamp(w, min=0).long()
        gr = self.rows_of[hk]                                     # (Kc, R)
        jj = j[:, None].expand_as(gr)
        zc_d, _, pc_d = decay(st["zi"][gr], st["ei"][gr], st["pi"][gr],
                              (t - st["ti"][gr]).to(torch.float32), self.ki)
        old = [st[f][gr, jj] for f in self.PLANES + ("tij",)]
        pj_x = torch.cat([pj, pj.new_zeros((1, C))])
        z1, e1, p1, w1 = cell(old[0].float(), old[1].float(), old[2].float(),
                              (t - old[4]).to(torch.float32), zc_d, pc_d,
                              pj_x[hk, j][:, None], self.kij, p.eps)
        keep = ok[:, None]
        for f, v, o in zip(self.PLANES, (z1, e1, p1, w1), old):
            st[f][gr, jj] = torch.where(keep, v.to(self.dtype), o)
        st["tij"][gr, jj] = torch.where(keep, t, old[4])
        bump = torch.zeros((S + 1, C), dtype=torch.float32, device=dev)
        bump[hk, j] = ok.to(torch.float32)
        st["zj"].copy_(zj + bump[:S])
        st["ej"].copy_(ej)
        st["pj"].copy_(pj)
        st["h"].copy_(h)
        # fan-out of the network's fired batch into the sample's queues, in
        # enqueue order (source HCU, fanout slot): the first Mc live
        # synapses, the spare entry M in the other slots
        act = batch_all[self.in_src] == self.in_col
        e = compact(act, self.Mc, self.M)
        self.overflow.add_(torch.clamp(act.sum() - self.Mc, min=0))
        valid = e < self.M
        key = torch.where(valid, self.in_dst[e] * D + (t + self.in_delay[e]) % D,
                          S * D)
        order = torch.sort(key, stable=True).indices
        sk = key[order]
        pos = torch.arange(sk.shape[0], device=dev)
        first = torch.ones_like(sk, dtype=torch.bool)
        first[1:] = sk[1:] != sk[:-1]
        start = torch.cummax(torch.where(first, pos, 0), dim=0).values
        rank = torch.empty_like(pos)
        rank[order] = pos - start
        cnt = torch.cat([st["delay_count"].reshape(-1).long(),
                         torch.zeros(1, dtype=torch.long, device=dev)])
        slot = cnt[key] + rank
        put = valid & (slot < A)
        st["delay_rows"][torch.where(put, key * A + slot, S * D * A)] = \
            self.in_row[e].to(torch.int32)
        arrivals = torch.zeros(S * D + 1, dtype=torch.long, device=dev)
        arrivals.index_add_(0, key, valid.long())
        st["delay_count"].copy_(torch.clamp(cnt[:-1] + arrivals[:-1],
                                            max=A).view(S, D))
        return scores


def compact(mask, k: int, fill: int):
    """The positions of the first k True entries of ``mask``, in order, then
    ``fill``: fixed-size and without a host read."""
    pos = torch.cumsum(mask.to(torch.int64), dim=0) - 1
    dest = torch.where(mask & (pos < k), pos, k)
    out = torch.full((k + 1,), fill, dtype=torch.int64, device=mask.device)
    out[dest] = torch.arange(mask.shape[0], device=mask.device)
    return out[:k]
