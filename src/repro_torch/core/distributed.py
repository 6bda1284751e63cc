"""Distributed BCPNN runtime of the port: whole HCUs per rank of a
`torch.distributed` process group, and one all_to_all of packed spike
words per tick (the port of `repro.core.distributed`).

Paper mapping (§III.A, §VI.E): the eBrainII hierarchy BCU (chip) >
H-Cube (vault, P=4 HCUs) > HCU with a spike NoC between tiles. The JAX
package maps it onto `shard_map` over a 1-D "hcu" mesh of devices; the
port runs SPMD: one process per rank of a process group (`launch.mesh.
HcuMesh`), each holding its own whole HCUs, which is the body the JAX
package runs per device under `shard_map`. NCCL groups run one rank per
GPU; several ranks on one card, and the CPU tests, use gloo.

Rank r holds HCUs [r * h_local, (r + 1) * h_local): rows
[r * h_local * R, (r + 1) * h_local * R) of the flat planes and i-vectors,
rows [r * h_local, ...) of every per-HCU leaf and of the connectivity,
whose destination ids stay global. The time, the key and the drop
counters are held by every rank; each rank adds its own drops to its own
counters, as each device does under the JAX package's unchecked
replicated specs. What the JAX package reads back from them is device
0's count alone (`gather_network` and `Simulator.drops` give rank 0's),
so the drops of the other ranks are not in it.

The spike NoC is `SparseExchange`: only fired (dest, row, delay) triples
travel, one int32 word per spike, in per-destination buckets sized by
`default_route_config` (the Fig 7 Poisson tail) or `lossless_route_config`
(the worst case), shipped with one `dist.all_to_all_single` per tick that
the tick issues before its column pass and consumes after it. The words
go as the tensors they are: gloo takes CUDA tensors for all_to_all as well
as CPU ones, NCCL CUDA ones.

Two drivers run the same per-rank tick (`engine.tick` with
``gid_base = rank * h_local`` and the exchange as its route):

  * `make_dist_tick` — one tick a call;
  * `make_dist_run`  — the ticks of a staged (T, h_local, A_ext) input:
    on an NCCL group one CUDA-graph replay a chunk with the collective
    inside (`network.ChunkGraphs`), on the CPU and on a gloo group tick
    by tick (gloo's exchange runs on the host).

Both take and return the rank's own slices; `shard_network` cuts them
from a global network, `gather_fired` / `gather_network` put the global
history and state back together on every rank.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core import engine as E
from repro_torch.core import network as N
from repro_torch.core import queues
from repro_torch.core.hcu import HCUState
from repro_torch.core.params import BCPNNParams


class RouteConfig(NamedTuple):
    """Static capacities of the spike exchange."""
    cap_fire: int        # max simultaneously fired HCUs per rank per tick
    cap_route: int       # max messages per (src rank -> dst rank) per tick
    pack: bool = True    # pack each spike into one int32 (paper Fig 3 format)


def default_route_config(p: BCPNNParams, h_local: int,
                         n_dev: int | None = None) -> RouteConfig:
    """Dimension the exchange the way the paper dimensions its queues (§IV):
    Poisson-tail capacity with a months-scale drop budget, NOT worst case.

    Expected messages per (src rank -> dst rank) pair per tick:
        lam = out_rate * h_local * fanout / n_dev
    cap_route = smallest q with <= 1 expected drop/month at Poisson(lam),
    clamped into [8, cap_fire * fanout]; overflows are counted in
    drops_route."""
    cap_fire = max(2, int(0.35 * h_local) + 1)
    if n_dev is None:
        return RouteConfig(cap_fire=cap_fire, cap_route=cap_fire * p.fanout)
    lam = max(p.out_rate * h_local * p.fanout / n_dev, 0.1)
    cap = queues.min_queue_for_monthly_drop_budget(lam, budget=1.0,
                                                   max_q=4096)
    cap = min(max(8, cap), cap_fire * p.fanout)
    return RouteConfig(cap_fire=cap_fire, cap_route=cap)


def lossless_route_config(p: BCPNNParams, h_local: int) -> RouteConfig:
    """Worst-case exchange dimensioning: capacity never binds (every rank
    can fire all of its HCUs and route their entire fanout to one peer), so
    the exchange drops nothing and the trajectory is bitwise the same on
    every mesh size — the contract `ElasticRunner` relies on."""
    return RouteConfig(cap_fire=max(h_local, 1),
                       cap_route=max(h_local, 1) * p.fanout)


def _pack_bits(p: BCPNNParams, h_local: int):
    loc_bits = max((h_local - 1).bit_length(), 1)
    row_bits = (p.rows).bit_length()              # rows value == invalid marker
    dly_bits = max((p.max_delay - 1).bit_length(), 1)
    if loc_bits + row_bits + dly_bits + 1 > 31:
        raise ValueError(f"spike word overflow: {loc_bits} + {row_bits} + "
                         f"{dly_bits} + 1 bits do not fit 31")
    return loc_bits, row_bits, dly_bits


def pack_spikes(dest_loc, dest_row, delay, valid, p: BCPNNParams,
                h_local: int):
    """One spike == one int32 word (paper Fig 3: dest HCU | row | delay |
    valid)."""
    lb, rb, db = _pack_bits(p, h_local)
    w = dest_loc & ((1 << lb) - 1)
    w = (w << rb) | (dest_row & ((1 << rb) - 1))
    w = (w << db) | (delay & ((1 << db) - 1))
    return (w << 1) | valid.to(torch.int32)


def unpack_spikes(w, p: BCPNNParams, h_local: int):
    """The inverse of `pack_spikes`: (dest_loc, dest_row, delay, valid)."""
    lb, rb, db = _pack_bits(p, h_local)
    valid = (w & 1) == 1
    delay = (w >> 1) & ((1 << db) - 1)
    dest_row = (w >> (1 + db)) & ((1 << rb) - 1)
    dest_loc = (w >> (1 + db + rb)) & ((1 << lb) - 1)
    return dest_loc, dest_row, delay, valid


class SparseExchange:
    """Split-phase sparse spike routing: the sharded tick's spike NoC.

    `send` ranks the fired batch's fan-out within its destination rank
    (`network._rank_within_key`, so messages keep their relative order),
    drops what exceeds ``cap_route`` into ``drops_route``, scatters the
    rest into (ndev, cap_route) buckets (`network._put_drop`, the JAX
    package's drop-mode scatter) of packed words (or, unpacked, (ndev,
    cap_route, 4) slots) and starts the all_to_all without waiting for
    it. `recv` waits for it, unpacks the delivered words and enqueues
    them into the local delay queues.

    `engine.tick` runs the two around the column pass (send -> columns ->
    recv), so the collective is in flight while the columns run; calling
    the object runs send and recv back to back (``overlap=False``). Both
    give the same bits: neither phase reads what the other writes."""

    def __init__(self, p: BCPNNParams, rc: RouteConfig, group, ndev: int,
                 h_local: int):
        self.p, self.rc, self.group = p, rc, group
        self.ndev, self.h_local = ndev, h_local

    def send(self, state, dest_h, dest_r, dly, valid, p_, n_):
        p, rc, ndev, h_local = self.p, self.rc, self.ndev, self.h_local
        dest_dev = dest_h // h_local
        dest_loc = dest_h % h_local
        key = torch.where(valid, dest_dev, ndev)
        rank = N._rank_within_key(key)
        ok = valid & (rank < rc.cap_route)
        route_drops = torch.sum(valid) - torch.sum(ok)
        size = ndev * rc.cap_route
        flat = torch.where(ok, dest_dev * rc.cap_route + rank, size)

        def bucketize(vals, fill):
            buf = torch.full((size,), fill, dtype=torch.int32,
                             device=dest_h.device)
            return N._put_drop(buf, flat, vals.to(torch.int32)).reshape(
                ndev, rc.cap_route)

        if rc.pack:
            words = pack_spikes(dest_loc, dest_r, dly, ok, p, h_local)
            send = bucketize(torch.where(ok, words, 0), 0)
        else:
            send = torch.stack([
                bucketize(dest_loc, 0),
                bucketize(dest_r, p.rows),    # p.rows == invalid row marker
                bucketize(dly, 1),
                bucketize(ok.to(torch.int32), 0),
            ], dim=-1)                         # (ndev, cap_route, 4)
        recv = torch.empty_like(send)
        work = dist.all_to_all_single(recv, send, group=self.group,
                                      async_op=True)
        state = state._replace(
            drops_route=(state.drops_route + route_drops).to(torch.int32))
        return state, (work, recv, send)   # the send buffer lives to the wait

    def recv(self, state, inflight, p_, n_):
        p, rc, ndev, h_local = self.p, self.rc, self.ndev, self.h_local
        work, recv, _ = inflight
        work.wait()
        if rc.pack:
            d_loc, d_row, d_dly, d_ok = unpack_spikes(
                recv.reshape(ndev * rc.cap_route), p, h_local)
            return N.enqueue_spikes(state, d_loc, d_row, d_dly, d_ok, p,
                                    h_local)
        recv = recv.reshape(ndev * rc.cap_route, 4)
        return N.enqueue_spikes(state, recv[:, 0], recv[:, 1], recv[:, 2],
                                recv[:, 3] == 1, p, h_local)

    def __call__(self, state, dest_h, dest_r, dly, valid, p_, n_):
        state, inflight = self.send(state, dest_h, dest_r, dly, valid, p_, n_)
        return self.recv(state, inflight, p_, n_)


def _exchange_route(p: BCPNNParams, rc: RouteConfig, mesh, h_local: int,
                    overlap: bool = True):
    """The sharded tick's route: the `SparseExchange` itself (run split
    around the column pass) or, without ``overlap``, a plain callable that
    runs the same exchange after the columns."""
    ex = SparseExchange(p, rc, mesh.group, mesh.size, h_local)
    if overlap:
        return ex

    def route(state, dest_h, dest_r, dly, valid, p_, n_):
        return ex(state, dest_h, dest_r, dly, valid, p_, n_)

    return route


def _tick_kw(p: BCPNNParams, rc: RouteConfig, mesh, h_local: int,
             overlap: bool) -> dict:
    """`engine.tick`'s sharded hooks for this rank. The column pass runs
    every tick, as the JAX package's sharded tick runs it."""
    return dict(gid_base=mesh.rank * h_local,
                route=_exchange_route(p, rc, mesh, h_local, overlap),
                cond_columns=False)


def make_dist_tick(mesh, p: BCPNNParams, rc: RouteConfig, axis="hcu",
                   eager: bool = False, worklist: bool | None = None,
                   fused: bool | None = None, fused_cols: bool | None = None,
                   overlap: bool = True):
    """The sharded tick, one tick a call: fn(state, conn, ext) -> (state',
    fired (h_local,)) on this rank's slices (`shard_network`; ext (h_local,
    A_ext)). ``worklist`` / ``fused`` / ``fused_cols`` / ``eager`` pick the
    backend as `engine.select_backend` does; ``overlap`` (default on)
    issues the exchange before the column pass — the same bits as the
    sequential exchange. ``axis`` names the mesh's one axis, as in the JAX
    package."""
    be = E.select_backend(p, eager=eager, worklist=worklist, fused=fused,
                          fused_cols=fused_cols)
    kws = {}

    def fn(state, conn, ext):
        n = state.delay_rows.shape[0]
        kw = kws.setdefault(n, _tick_kw(p, rc, mesh, n, overlap))
        state, fired = E.tick(be.carry_in(state), conn,
                              ext.to(mesh.device, torch.int32), p, be,
                              rc.cap_fire, **kw)
        return be.carry_out(state), fired

    return fn


def make_dist_run(mesh, p: BCPNNParams, rc: RouteConfig, axis="hcu",
                  eager: bool = False, worklist: bool | None = None,
                  fused: bool | None = None, fused_cols: bool | None = None,
                  overlap: bool = True):
    """The multi-tick sharded driver (`network.network_run`'s sharded twin):
    fn(state, conn, ext, chunk=128, graphs=None) -> (state', fired (T,
    h_local)) on this rank's slices, ext (T, h_local, A_ext); exactly the
    trajectory of `make_dist_tick` applied T times.

    On an NCCL group (CUDA) each chunk of ``chunk`` ticks is one replay of
    a CUDA graph holding its ticks, exchanges included (`network.
    ChunkGraphs`: static carry, side capture stream, one pool; ``graphs``
    keeps the captures for the next call on the same state). The
    collective's communicator is made by one eager exchange before the
    first capture. On the CPU and on a gloo group the ticks run one by
    one: gloo's all_to_all runs on the host and cannot be captured."""
    be = E.select_backend(p, eager=eager, worklist=worklist, fused=fused,
                          fused_cols=fused_cols)
    graphed = dist.get_backend(mesh.group) == "nccl"
    kws = {}

    def fn(state, conn, ext, chunk: int = 128, graphs=None):
        if chunk < 1:
            raise ValueError(f"chunk must be at least 1, got {chunk}")
        n = state.delay_rows.shape[0]
        kw = kws.get(n)
        if kw is None:
            kw = kws[n] = _tick_kw(p, rc, mesh, n, overlap)
            if graphed:
                _warm_collective(mesh)
        ext = ext.to(mesh.device, torch.int32)
        T = ext.shape[0]
        if graphed and T:
            graphs = N.ChunkGraphs() if graphs is None else graphs
            return graphs.run(state, conn, ext, p, be, rc.cap_fire, chunk,
                              tick_kw=kw)
        fired = torch.empty((T, n), dtype=torch.int32, device=mesh.device)
        state = N._run_ticks(state, conn, ext, p, be, rc.cap_fire, fired,
                             tick_kw=kw)
        return state, fired

    return fn


def _warm_collective(mesh) -> None:
    """One eager all_to_all on the group, so that its communicator exists
    before a capture records the exchange."""
    buf = torch.zeros((mesh.size, 1), dtype=torch.int32, device=mesh.device)
    dist.all_to_all_single(torch.empty_like(buf), buf, group=mesh.group)


# ---------------------------------------------------------------------------
# placement: a rank's slice of the global network, and back
# ---------------------------------------------------------------------------

SHARD = "hcu"             # cut on its leading axis (whole HCUs a rank)
REPLICATE = "replicated"  # held whole by every rank


def _shard_specs():
    """(state, conn) spec trees of an HCU shard: `SHARD` for the leaves
    cut on their leading axis (the ij planes and i-vectors by rows, every
    per-HCU leaf by HCU), `REPLICATE` for the time, the drop counters and
    the key. A merged state's rings are per-HCU."""
    state_specs = N.NetworkState(
        hcus=HCUState(*([SHARD] * len(HCUState._fields))),
        delay_rows=SHARD, delay_count=SHARD, t=REPLICATE, drops_in=REPLICATE,
        drops_fire=REPLICATE, base_key=REPLICATE, jring=SHARD,
        drops_route=REPLICATE)
    conn_specs = N.Connectivity(SHARD, SHARD, SHARD)
    return state_specs, conn_specs


def _spec_pairs(tree, specs):
    """(leaf, spec) of a tree and its congruent spec tree (or one spec for
    every leaf), in field order; None leaves are skipped."""
    for a, s in zip(tree, _broadcast_spec(tree, specs), strict=True):
        if isinstance(a, tuple):
            yield from _spec_pairs(a, s)
        elif a is not None:
            yield a, s


def _broadcast_spec(tree, specs):
    """``specs`` as a tree congruent with ``tree`` (one spec: for every
    leaf)."""
    return specs if isinstance(specs, tuple) else N.tree_map(
        lambda _: specs, tree)


def place(tree, mesh, specs):
    """This rank's placement of a global ``tree`` (host or device tensors)
    on ``mesh``: each `SHARD` leaf cut to the rank's part of its leading
    axis, each `REPLICATE` leaf whole; new contiguous tensors on the
    mesh's device. ``specs`` is a congruent tree of specs or one spec."""
    def cut(x, s):
        if s == REPLICATE:
            return x.to(mesh.device, copy=True)
        k, rem = divmod(x.shape[0], mesh.size)
        if rem:
            raise ValueError(f"a leading axis of {x.shape[0]} does not "
                             f"split over {mesh.size} ranks")
        return x[mesh.rank * k:(mesh.rank + 1) * k].to(
            mesh.device, copy=True).contiguous()

    return N.tree_map(cut, tree, _broadcast_spec(tree, specs))


def shard_network(mesh, state: N.NetworkState, conn: N.Connectivity,
                  axis="hcu"):
    """This rank's slice of a global network (state and connectivity) on
    ``mesh``: whole HCUs, new tensors on the mesh's device. The global
    tensors are not kept: a caller that drops them holds only its
    slice."""
    state_specs, conn_specs = _shard_specs()
    return place(state, mesh, state_specs), place(conn, mesh, conn_specs)


def _root(mesh) -> int:
    """The global rank of the mesh's rank 0."""
    return dist.get_global_rank(mesh.group, 0)


def gather_fired(mesh, fired) -> torch.Tensor:
    """The global (T, H) fired history from every rank's (T, h_local) one,
    on every rank (a collective of the mesh's group)."""
    parts = [torch.empty_like(fired) for _ in range(mesh.size)]
    dist.all_gather(parts, fired.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=1)


def gather_network(mesh, tree, specs=None):
    """The global tree (a NetworkState by default, or ``tree`` under
    ``specs``) from every rank's slice, on every rank's device (a
    collective of the mesh's group). `REPLICATE` leaves are rank 0's: the
    drop counters of a gathered state are what the JAX package reads back
    from a sharded one, its device 0's."""
    def gather(x, s):
        x = x.contiguous()
        if s == REPLICATE:
            x = x.clone()
            dist.broadcast(x, _root(mesh), group=mesh.group)
            return x
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(parts, x, group=mesh.group)
        return torch.cat(parts)

    return N.tree_map(gather, tree, _broadcast_spec(
        tree, _shard_specs()[0] if specs is None else specs))


def drop_counters(mesh, state: N.NetworkState) -> dict:
    """`network.drop_counters` of a sharded state as the JAX package reads
    them: rank 0's counters, on every rank (a collective)."""
    c = torch.stack([state.drops_in, state.drops_fire, state.drops_route])
    dist.broadcast(c, _root(mesh), group=mesh.group)
    d_in, d_fire, d_route = c.tolist()
    return {"in": d_in, "fire": d_fire, "route": d_route}
