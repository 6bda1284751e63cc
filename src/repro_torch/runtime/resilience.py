"""Resilient realtime BCPNN runtime: crash recovery, DRAM-retention fault
injection, and drop-budget health accounting (the port of
`repro.runtime.resilience`).

eBrainII is not just a fast BCPNN — it is a *fault-priced* one. The paper
dimensions its spike queues against an explicit drop budget (queue size 36 ≈
one dropped spike per month, Fig 7 / EQ1 — `repro_torch.core.queues`), and
its custom 3D DRAM deliberately relaxes refresh because BCPNN tolerates
synaptic-plane bit errors. This module turns those robustness claims into
runnable machinery over the tick engine, across three fault classes:

1. Crash/restart — `ResilientRunner` drives `Simulator.run` in chunks with
   async checkpoints every `save_every` chunks and injectable failures
   (`repro_torch.runtime.elastic.InjectedFailure`). Restore-and-replay is
   BITWISE identical to the uninterrupted trajectory: the checkpoint stores
   exact NetworkState bits (incl. `base_key`), per-tick RNG keys are
   derived from the tick index, external input is a pre-staged tensor
   re-sliced at the restored `t`, and chunk boundaries do not affect bits.
   A restore copies the checkpoint into the Simulator's held tensors, which
   keep their storage, so the CUDA graphs captured on them
   (`network.ChunkGraphs`) survive a restart and are not captured again.

2. Memory faults — `flip_bits` / `inject_retention_faults` corrupt the
   synaptic ij planes (Zij/Eij/Pij/Wij/Tij) at a configurable per-bit rate
   and pattern, emulating relaxed-refresh 3D DRAM retention errors. The
   draws are the JAX package's, bit for bit (`rng.bernoulli`), and the
   flips are integer operations, so a fault pattern is the same on the CPU,
   on the card and in the JAX package.

3. Overload/deadline faults — `HealthMonitor` reads the engine's drop
   counters (`Simulator.drops`) per chunk, compares observed drops against
   the Fig 7 analytic budget (`queues.drop_probability_per_ms` scaled to
   run length and HCU count), and folds in `StragglerMonitor` wall-clock
   accounting against the paper's 1 ms/tick realtime target. The policy is
   graceful degradation: log + flag in the structured health report (ok /
   over-budget / deadline-missed), never stall or abort the run.

4. Device loss — `ElasticRunner` drives the sharded runtime
   (`repro_torch.core.distributed`) in chunks, SPMD on every rank of a
   process group, and recovers from the loss of ranks by restoring the
   last checkpoint onto the survivors (`elastic.remesh_network`); under
   `lossless_route_config` the replay is bitwise the uninterrupted run.

Everything here is host-side orchestration over the tick drivers: enabling
resilience cannot perturb trajectories.
"""
from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import AsyncCheckpointer, restore_latest
from repro_torch.checkpoint.checkpointer import _unflatten
from repro_torch.core import distributed as DD
from repro_torch.core import network as N
from repro_torch.core import queues, rng
from repro_torch.core.params import BCPNNParams
from repro_torch.launch.mesh import (_new_group, elastic_device_count,
                                     make_elastic_mesh)
from repro_torch.runtime.elastic import (DeviceLoss, InjectedFailure,
                                         RestartBudgetExceeded,
                                         StragglerMonitor, host_copy,
                                         remesh_network)

log = logging.getLogger("repro_torch.resilience")

# the five synaptic ij planes the paper stores in (relaxed-refresh) 3D DRAM
# — the 192-bit AoS cell, here as (H*R, C) SoA planes
IJ_PLANES = ("zij", "eij", "pij", "wij", "tij")

# paper realtime target: one biological ms per wall-clock ms
REALTIME_US_PER_TICK = 1000.0

_M = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# fault class 2: DRAM-retention bit flips
# ---------------------------------------------------------------------------

def flip_bits(plane: torch.Tensor, key, rate: float, *, mode: str = "flip",
              bit_mask: int = 0xFFFFFFFF) -> torch.Tensor:
    """Corrupt a 32-bit state plane with independent per-bit faults.

    Each of the 32 bits of every cell is hit with probability `rate`
    (restricted to the bits set in `bit_mask`); `mode` selects the fault
    pattern:
      * "flip"  — invert the hit bits (generic soft error),
      * "clear" — force hit bits to 0 (a DRAM true-cell losing charge under
                  relaxed refresh — the retention-error pattern),
      * "set"   — force hit bits to 1 (anti-cell decay).
    rate=0.0 is a bitwise no-op. Deterministic in `key` (a threefry key,
    `repro_torch.core.rng`), and the JAX package's draws bit for bit: the
    hits are ``bernoulli(key, rate, plane.shape + (32,))``, bit b of a cell
    hit by draw b. Works for the float32 planes and the int32 Tij
    timestamps alike (both are viewed as their 32 bits). Returns a new
    tensor on the plane's device.

    The draw holds plane.numel() * 32 threefry words, as int64 temporaries
    of the plain threefry glue: about 1 GB for each million cells. A
    plane too large for the device raises its out-of-memory error.
    """
    if mode not in ("flip", "clear", "set"):
        raise ValueError(f"unknown fault mode {mode!r}")
    if plane.element_size() != 4:
        raise ValueError(f"flip_bits takes 32-bit planes, got {plane.dtype}")
    dev = plane.device
    bits = plane.contiguous().view(torch.int32).to(torch.int64) & _M
    hit = rng.bernoulli(key.to(dev), rate, tuple(plane.shape) + (32,))
    weights = torch.ones((), dtype=torch.int64, device=dev) << torch.arange(
        32, device=dev)
    noise = torch.where(hit, weights, 0).sum(-1) & (bit_mask & _M)
    del hit
    if mode == "flip":
        bits = bits ^ noise
    elif mode == "clear":
        bits = bits & (~noise & _M)
    else:
        bits = bits | noise
    # back to the int32 bit pattern (two's complement), then the plane's type
    bits = torch.where(bits > 0x7FFFFFFF, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(plane.dtype)


def inject_retention_faults(state, key, rate: float, *,
                            planes=IJ_PLANES, mode: str = "flip",
                            bit_mask: int = 0xFFFFFFFF):
    """Corrupt the selected synaptic planes of a NetworkState at per-bit
    `rate` — the software stand-in for running the paper's 3D DRAM below its
    worst-case refresh interval. Only the named ij planes are touched; queue
    state, j-vectors and RNG key stay exact (they live in the ASIC's SRAM,
    not the relaxed-refresh DRAM). Plane i of `planes` draws under
    ``fold_in(key, i)``, one plane at a time, as the JAX package does. The
    planes are corrupted as they are stored (flat, or in a blocked layout's
    order). Returns the corrupted state (new plane tensors; the others are
    shared)."""
    upd = {}
    for i, name in enumerate(planes):
        if name not in IJ_PLANES:
            raise ValueError(f"{name!r} is not a DRAM-resident ij plane "
                             f"{IJ_PLANES}")
        upd[name] = flip_bits(getattr(state.hcus, name),
                              rng.fold_in(key, i), rate,
                              mode=mode, bit_mask=bit_mask)
    return state._replace(hcus=state.hcus._replace(**upd))


# ---------------------------------------------------------------------------
# fault class 3: overload / deadline health accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HealthMonitor:
    """Per-chunk drop-budget + realtime-deadline accounting.

    Drops: the engine counts three Fig 7 failure classes — delay-queue
    overflows (`drops_in`), fired-batch overflows (`drops_fire`) and
    inter-device route-capacity overflows (`drops_route`, sharded fabric
    only). Each class is budgeted separately against its own analytic
    expectation (`repro_torch.core.queues`, EQ1, scaled by
    `budget_headroom`): 'in' at the dimensioned Poisson input rate over
    `n_hcu` queues, and — when the sharded context is known (`n_dev` +
    `route_cfg`, any object with `cap_fire` and `cap_route`, set by
    `set_mesh`) — 'fire'/'route' at the per-device fired/fan-out rates
    against those capacities.

    Deadlines: a `StragglerMonitor` tracks per-chunk wall time against the
    paper's realtime target (`target_us_per_tick`, default 1 ms/tick). The
    caller ends a chunk (`chunk_end`) after its fired rows are on the host,
    so the clock times the device's ticks, not their launches.

    Policy: graceful degradation. The monitor never raises and never blocks;
    `report()` returns the structured verdict (ok / over-budget /
    deadline-missed) and violations are logged as they are observed.
    """
    p: BCPNNParams
    n_hcu: int | None = None
    target_us_per_tick: float = REALTIME_US_PER_TICK
    budget_headroom: float = 1.0
    n_dev: int = 1
    route_cfg: object | None = None    # cap_fire / cap_route of the mesh
    ticks: int = 0
    straggler: StragglerMonitor = dataclasses.field(
        default_factory=lambda: StragglerMonitor(deadline_s=0.0))
    worst_us_per_tick: float = 0.0
    _drops0: dict | None = None
    _drops: dict | None = None

    def begin(self, drops: dict) -> None:
        """Record the drop-counter baseline (cumulative {'in','fire'})."""
        self._drops0 = dict(drops)
        self._drops = dict(drops)

    def chunk_start(self, n_ticks: int) -> None:
        self.straggler.deadline_s = n_ticks * self.target_us_per_tick / 1e6
        self.straggler.start()

    def chunk_end(self, n_ticks: int, drops: dict) -> bool:
        """Close out a chunk: wall-clock + drop accounting. Returns True if
        the chunk met its realtime deadline."""
        met = self.straggler.finish()
        per_tick_us = self.straggler.last_s * 1e6 / max(n_ticks, 1)
        if per_tick_us > self.worst_us_per_tick:
            self.worst_us_per_tick = per_tick_us
        self.ticks += n_ticks
        if self._drops0 is None:
            self._drops0 = {k: 0 for k in drops}
        self._drops = dict(drops)
        if not met:
            log.warning("deadline miss: chunk of %d ticks ran %.0f us/tick "
                        "(target %.0f)", n_ticks, per_tick_us,
                        self.target_us_per_tick)
        return met

    # -- verdict -------------------------------------------------------------
    def set_mesh(self, n_dev: int, route_cfg) -> None:
        """Refresh the sharded budgeting context (device count and a route
        configuration with `cap_fire` / `cap_route`): fire/route budgets
        from here on are priced at that capacity."""
        self.n_dev = int(n_dev)
        self.route_cfg = route_cfg

    def class_budgets(self) -> dict:
        """Fig 7 analytic budget PER DROP CLASS, scaled to this run.

        'in'   — expected delay-queue drops over `ticks` ms x `n_hcu` queues
                 at the dimensioned Poisson input rate (EQ1);
        'fire' — expected fired-batch overflows: per device the fired count
                 is ~Poisson(out_rate * h_local) against cap_fire slots;
        'route'— expected fabric drops: each of the n_dev^2 (src, dst) pairs
                 carries ~Poisson(out_rate * h_local * fanout / n_dev)
                 messages against cap_route slots.
        'fire'/'route' require the sharded context (`route_cfg`); a local
        run budgets only 'in'."""
        p = self.p
        n = self.n_hcu if self.n_hcu is not None else p.n_hcu
        out = {"in": queues.drop_probability_per_ms(p.active_queue, p.in_rate)
               * self.ticks * n}
        rc = self.route_cfg
        if rc is not None:
            nd = max(int(self.n_dev), 1)
            h_local = max(n // nd, 1)
            lam_fire = max(p.out_rate * h_local, 1e-6)
            out["fire"] = (queues.drop_probability_per_ms(rc.cap_fire,
                                                          lam_fire)
                           * self.ticks * nd)
            lam_route = max(p.out_rate * h_local * p.fanout / nd, 1e-6)
            out["route"] = (queues.drop_probability_per_ms(rc.cap_route,
                                                           lam_route)
                            * self.ticks * nd * nd)
        return out

    def expected_drops(self) -> float:
        """Fig 7 analytic budget scaled to this run: expected dropped spikes
        over `ticks` ms summed across the budgeted drop classes."""
        return sum(self.class_budgets().values())

    def observed_drops(self) -> dict:
        d0 = self._drops0 or {}
        d1 = self._drops or {}
        out = {k: int(d1.get(k, 0)) - int(d0.get(k, 0)) for k in d1}
        out["total"] = sum(out.values())
        return out

    def report(self, restarts: int = 0) -> dict:
        """Structured health verdict, in the JAX package's schema
        (docs/RESILIENCE.md). Never raises."""
        obs = self.observed_drops()
        budgets = self.class_budgets()
        classes = {
            k: {"observed": obs.get(k, 0),
                "budget": b * self.budget_headroom,
                "over": obs.get(k, 0) > b * self.budget_headroom}
            for k, b in budgets.items()}
        budget = self.expected_drops() * self.budget_headroom
        over = (obs.get("total", 0) > budget
                or any(c["over"] for c in classes.values()))
        missed = self.straggler.slow_steps > 0
        status = ("over-budget" if over
                  else "deadline-missed" if missed else "ok")
        ticks = max(self.ticks, 1)
        rep = {
            "status": status,
            "ticks": self.ticks,
            "restarts": restarts,
            "drops": obs,
            "classes": classes,
            "budget": {
                "queue_size": self.p.active_queue,
                "lam": self.p.in_rate,
                "drop_p_per_ms": queues.drop_probability_per_ms(
                    self.p.active_queue, self.p.in_rate),
                "expected_drops_run": self.expected_drops(),
                "expected_drops_per_month_per_hcu":
                    queues.expected_drops_per_month(self.p.active_queue,
                                                    self.p.in_rate),
                "headroom": self.budget_headroom,
                "over_budget": over,
            },
            "deadline": {
                "target_us_per_tick": self.target_us_per_tick,
                "observed_us_per_tick": self.straggler.total_s * 1e6 / ticks,
                "worst_chunk_us_per_tick": self.worst_us_per_tick,
                "chunks": self.straggler.total,
                "chunks_missed": self.straggler.slow_steps,
                "missed": missed,
            },
        }
        if status != "ok":
            log.warning("health: %s (drops=%s budget=%.3f, %d/%d chunks "
                        "missed deadline)", status, obs, budget,
                        self.straggler.slow_steps, self.straggler.total)
        return rep


@dataclasses.dataclass
class ServingHealthMonitor(HealthMonitor):
    """HealthMonitor with the serving request queue as a fourth drop class.

    The continuous-batching recall server (`repro_torch.launch.serve_bcpnn`)
    holds a fixed-capacity admission queue that is dimensioned exactly like
    the paper's spike queues: request arrivals ~ Poisson(`req_rate` per
    engine step) against `queue_capacity` waiting slots, drained once per
    step. The expected number of REJECTED requests over the run is therefore
    EQ1's tail mass at the queue size — `queues.drop_probability_per_ms`
    with the engine step standing in for the millisecond — times the number
    of steps taken (`StragglerMonitor.total` chunks). Observed rejections
    ride in on the 'reject' key of the cumulative drops dict the server
    passes to `chunk_end`, so `report()` prices admission-queue overflow the
    same way it prices delay-queue ('in'), fired-batch ('fire') and fabric
    ('route') overflow: Fig 7, per class, at current capacity.

    With `req_rate == 0` (unknown offered load) no 'reject' budget is
    published; any observed rejection then counts against the total budget —
    an unprovisioned queue that rejects is unhealthy by definition.
    """
    queue_capacity: int = 0
    req_rate: float = 0.0      # expected request arrivals per engine step

    def class_budgets(self) -> dict:
        out = super().class_budgets()
        if self.queue_capacity and self.req_rate > 0:
            out["reject"] = (queues.drop_probability_per_ms(
                self.queue_capacity, self.req_rate) * self.straggler.total)
        return out


# ---------------------------------------------------------------------------
# fault class 1: crash / restart with bitwise replay
# ---------------------------------------------------------------------------

def _shape_template(state):
    """A restore template of ``state``'s structure whose tensor leaves are
    zero-storage CPU tensors of the right shapes and dtypes: a checkpoint
    restored against it stays on the host until it is copied into the held
    tensors."""
    return N.tree_map(lambda a: torch.empty((), dtype=a.dtype).expand(
        a.shape), state)


def _ckpt_tree(state):
    """The state as a checkpoint holds it: the key as the JAX package's two
    uint32 words (`Simulator.save`'s format)."""
    return state._replace(base_key=rng.key_data(state.base_key))


class ResilientRunner:
    """Drive a `Simulator` through a long staged run with checkpoints,
    bounded crash recovery, and health accounting.

        sim = Simulator(p, key=0)                # on CUDA
        runner = ResilientRunner(sim, "ckpt", chunk_ticks=64, save_every=2)
        fired, health = runner.run(ext)          # (T, H) history + report

    The run is cut into `chunk_ticks`-tick `Simulator.run` calls; after
    every `save_every` chunks the NetworkState is snapshotted to host memory
    and written asynchronously (`repro_torch.checkpoint.AsyncCheckpointer`
    — atomic step dirs, stale-tmp sweep; the JAX package's format, the key
    as two uint32 words). `fail_injector(chunk_index) -> bool` simulates a
    crash before that chunk (raised as `InjectedFailure`); the runner then
    restores the newest complete checkpoint — or the initial state when none
    landed yet — re-slices the staged input at the restored `t`, and
    replays. Replay is bitwise-identical to the uninterrupted run.
    `max_restarts` bounds recovery (`RestartBudgetExceeded`). Real
    exceptions are never swallowed.

    A restore copies the checkpoint (read to the host) into the
    Simulator's held state tensors in place, on the Simulator's device: the
    tensors keep their storage, so the chunk graphs captured on them
    survive the restart. `recoveries` records one dict per restart (the
    restored tick and the seconds from the failure to the restored state).

    Overlapping fired history is overwritten on replay with identical
    values, so the returned (T, H) history is exactly the uninterrupted one.
    Each chunk's fired rows are read to the host (the one synchronisation a
    chunk) before the health monitor's clock stops.
    """

    def __init__(self, sim, ckpt_dir: str, *, chunk_ticks: int = 64,
                 save_every: int = 1, keep_last: int = 3,
                 fail_injector=None, max_restarts: int = 8,
                 monitor: HealthMonitor | None = None):
        self.sim = sim
        self.ckpt = AsyncCheckpointer(ckpt_dir, keep_last=keep_last)
        self.ckpt_dir = ckpt_dir
        self.chunk_ticks = int(chunk_ticks)
        self.save_every = int(save_every)
        self.fail_injector = fail_injector
        self.max_restarts = int(max_restarts)
        self.monitor = monitor if monitor is not None else HealthMonitor(
            sim.p, n_hcu=sim.n_hcu)
        self.restarts = 0
        self.recoveries: list[dict] = []

    def run(self, ext, n_ticks: int | None = None):
        """Run `ext` (staged (T, H, A_ext) array or tensor, iterable of
        frames, or callable ext_fn(t) with `n_ticks`) to completion through
        crashes. Returns (fired_history (T, H) int32 numpy, health report
        dict)."""
        sim = self.sim
        t0 = int(sim.state.t)
        if callable(ext):
            ext = N.stage_external(ext, n_ticks, t0=t0, device=sim.device)
        else:
            ext = N.stage_external(ext, device=sim.device)
        if n_ticks is not None:
            ext = ext[:n_ticks]
        T = int(ext.shape[0])
        n = sim.state.delay_rows.shape[0]
        fired = np.full((T, n), -1, np.int32)
        # restart-from-scratch target: the run updates the held state in
        # place, so only a copy survives the first chunk
        initial = host_copy(sim.state)
        self.monitor.begin(sim.drops())
        done = 0                       # ticks completed == history position
        chunks_done = 0
        while done < T:
            step = min(self.chunk_ticks, T - done)
            try:
                if self.fail_injector is not None and \
                        self.fail_injector(done // self.chunk_ticks):
                    raise InjectedFailure(
                        f"injected failure at tick {t0 + done}")
                self.monitor.chunk_start(step)
                f = sim.run(ext[done:done + step])
                fired[done:done + step] = f.cpu().numpy()
                done += step
                chunks_done += 1
                self.monitor.chunk_end(step, sim.drops())
                if chunks_done % self.save_every == 0:
                    # snapshot-to-host is synchronous (and a true copy —
                    # the next chunk updates these tensors in place); the
                    # disk write is backgrounded
                    self.ckpt.save_async(t0 + done, _ckpt_tree(sim.state))
            except InjectedFailure as e:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise RestartBudgetExceeded(
                        f"{self.restarts - 1} restarts exhausted the budget "
                        f"of {self.max_restarts}") from e
                rec_start = time.monotonic()
                self.ckpt.wait()
                restored, t_saved = restore_latest(
                    self.ckpt_dir, _shape_template(sim.state))
                if restored is None:
                    N.copy_into(sim.state, initial)
                    done = 0
                    log.warning("restart %d/%d: no checkpoint yet, replaying "
                                "from t=%d", self.restarts, self.max_restarts,
                                t0)
                else:
                    N.copy_into(sim.state, restored)
                    done = int(t_saved) - t0
                    log.warning("restart %d/%d: restored t=%d, replaying",
                                self.restarts, self.max_restarts,
                                int(t_saved))
                del restored
                if sim.device.type == "cuda":
                    torch.cuda.synchronize(sim.device)
                self.recoveries.append({
                    "kind": "crash", "restored_tick": t0 + done,
                    "recovery_s": time.monotonic() - rec_start})
        self.ckpt.wait()
        return fired, self.monitor.report(restarts=self.restarts)


# ---------------------------------------------------------------------------
# fault class 4: device loss — degraded-mode sharded runtime
# ---------------------------------------------------------------------------

class ElasticRunner:
    """ResilientRunner's crash recovery lifted onto the sharded path
    (`distributed.make_dist_run` over an HCU mesh), surviving the loss of
    ranks by re-placing their HCUs.

        sim = Simulator(p, key=0)                       # H hypercolumns
        runner = ElasticRunner(sim, "ckpt", chunk_ticks=64,
                               fail_injector=lambda c: 2 if c == 3 else 0)
        fired, health = runner.run(ext)                 # loses 2 ranks

    Every rank of ``group`` (the default process group unless given) runs
    it, SPMD, on a Simulator holding the global network, with the same
    input, injectors and checkpoint directory; ``devices`` are the ranks
    of the group taking part (default: all). The run is cut into
    ``chunk_ticks``-tick sharded runs with async checkpoints of the FULL
    logical state every ``save_every`` chunks, written by the first rank.
    ``fail_injector(chunk_index)`` may return a truthy int k (raised as
    `DeviceLoss(k)`: the trailing k ranks go away for good, and `run`
    re-raises it on them) or True (a plain `InjectedFailure`: a crash, same
    ranks). Recovery in both cases: restore the newest verified checkpoint
    (`repro_torch.checkpoint`, checksum fall-back included) on every
    surviving rank, build the largest whole-HCU-divisible mesh over the
    survivors (`launch.mesh.make_elastic_mesh`), re-derive ``h_local`` and
    the `RouteConfig` for it, build its driver (cached per rank count),
    re-place state and connectivity (`remesh_network`) and replay from the
    restored tick.

    The replayed trajectory is bitwise the uninterrupted one: the sharded
    tick does not depend on the mesh size under the default
    `lossless_route_config` (per-HCU RNG folds global ids, the exchange
    never drops, padded route slots carry no trajectory bits). A lossy
    ``route_config(p, h_local, ndev) -> RouteConfig`` (e.g.
    `default_route_config`) trades that for Fig 7-priced fabric drops;
    `HealthMonitor.set_mesh` prices them at each placement.

    ``rescale(chunk_index) -> int | None`` models graceful elasticity: a
    rank-count target applied at the chunk boundary as pure data movement
    (the live state gathered and re-placed, no restore, no replay). Ranks
    outside the current mesh idle but stay in step: they take part in the
    gathers (checkpoints, rescales, each chunk's fired rows and drop
    counters) through the group of the surviving ranks, so every surviving
    rank returns the whole (T, H) history and the same report, and ends
    holding the global final state in ``sim``. The drop counters are rank
    0's, what the JAX package reads back from a sharded state.

    ``recoveries`` records one dict per failure (kind, restored tick,
    surviving rank count, recovery wall seconds). ``axis`` names the mesh's
    one axis, as in the JAX package.
    """

    def __init__(self, sim, ckpt_dir: str, *, chunk_ticks: int = 64,
                 save_every: int = 1, keep_last: int = 3,
                 fail_injector=None, rescale=None, max_restarts: int = 8,
                 devices=None, axis: str = "hcu", route_config=None,
                 monitor: HealthMonitor | None = None, group=None):
        if sim.merged:
            raise NotImplementedError(
                "elastic runtime: merged mode has no sharded path "
                "(Simulator.run_sharded)")
        if sim.layout is not None:
            raise NotImplementedError(
                "elastic runtime: blocked plane layouts have no sharded "
                "path (Simulator.run_sharded)")
        self.sim = sim
        self.group = dist.group.WORLD if group is None else group
        world = dist.get_world_size(self.group)
        self.devices = (list(devices) if devices is not None
                        else list(range(world)))
        self.me = dist.get_rank(self.group)
        if self.me not in self.devices:
            raise ValueError(f"rank {self.me} is not among the runner's "
                             f"ranks {self.devices}")
        # the first rank writes the checkpoints (losses take trailing ranks)
        self.ckpt = (AsyncCheckpointer(ckpt_dir, keep_last=keep_last)
                     if self.me == self.devices[0] else None)
        self.ckpt_dir = ckpt_dir
        self.chunk_ticks = int(chunk_ticks)
        self.save_every = int(save_every)
        self.fail_injector = fail_injector
        self.rescale = rescale
        self.max_restarts = int(max_restarts)
        self.axis = axis
        self.route_config = route_config
        self.monitor = monitor if monitor is not None else HealthMonitor(
            sim.p, n_hcu=sim.n_hcu)
        self.restarts = 0
        self.recoveries: list[dict] = []
        self._alive = (self.group if len(self.devices) == world
                       else self._group_of(self.devices))
        self._lowered: dict[int, tuple] = {}

    # -- groups / meshes ----------------------------------------------------
    def _group_of(self, ranks):
        """A group of ``ranks`` of the runner's group, made by every
        surviving rank (`launch.mesh._new_group`)."""
        return _new_group(self.group, ranks)

    def _usable(self, limit: int | None = None) -> int:
        n = len(self.devices) if limit is None else min(len(self.devices),
                                                        int(limit))
        return elastic_device_count(self.sim.n_hcu, n)

    def _lower(self, ndev: int):
        """(mesh, rc, driver, graphs) for ``ndev`` ranks; mesh and driver
        are None on a rank outside the mesh. Cached per rank count: losses
        take the trailing ranks, so the ndev-prefix mesh stays valid."""
        if ndev not in self._lowered:
            sim = self.sim
            mesh = make_elastic_mesh(sim.n_hcu, self.devices[:ndev],
                                     group=self.group, device=sim.device)
            h_local = sim.n_hcu // ndev
            rc = (self.route_config(sim.p, h_local, ndev)
                  if self.route_config is not None
                  else DD.lossless_route_config(sim.p, h_local))
            fn = None if mesh is None else DD.make_dist_run(
                mesh, sim.p, rc, eager=sim.eager, worklist=sim.worklist,
                fused=sim.fused, fused_cols=sim.fused_cols)
            self._lowered[ndev] = (mesh, rc, fn, N.ChunkGraphs())
        return self._lowered[ndev]

    def _place(self, host, ndev: int):
        """Remap all H hypercolumns onto the ndev-rank mesh: this rank's
        (state, conn), or (None, None) outside it."""
        mesh, rc, _, _ = self._lower(ndev)
        self.monitor.set_mesh(ndev, rc)
        if mesh is None:
            return None, None
        return remesh_network(host, self._conn_host, mesh)

    # -- gathers over the surviving ranks -----------------------------------
    def _collect(self, local, piece, dtype, ndev: int) -> torch.Tensor:
        """(ndev,) + piece: piece r broadcast from the mesh's rank r to
        every surviving rank."""
        buf = torch.empty((ndev,) + tuple(piece), dtype=dtype,
                          device=self.sim.device)
        for r in range(ndev):
            if self.me == self.devices[r]:
                buf[r].copy_(local)
            dist.broadcast(buf[r], dist.get_global_rank(self.group,
                                                        self.devices[r]),
                           group=self._alive)
        return buf

    def _global(self, state, ndev: int):
        """A host copy of the global state from the mesh's slices, on every
        surviving rank; replicated leaves (time, key, drop counters) are
        the mesh's rank 0's."""
        locals_ = ([None] * len(self._specs) if state is None
                   else [x for x, _ in DD._spec_pairs(
                       state, DD._shard_specs()[0])])
        out = []
        for (tmpl, spec), x in zip(self._specs, locals_, strict=True):
            if spec == DD.REPLICATE:
                out.append(self._collect(x, tmpl.shape, tmpl.dtype, 1)[0]
                           .cpu())
            else:
                piece = (tmpl.shape[0] // ndev,) + tuple(tmpl.shape[1:])
                out.append(self._collect(x, piece, tmpl.dtype, ndev)
                           .reshape(tmpl.shape).cpu())
        return _unflatten(self._template, iter(out))

    def _fired(self, fired, step: int, ndev: int) -> np.ndarray:
        k = self.sim.n_hcu // ndev
        buf = self._collect(fired, (step, k), torch.int32, ndev)
        return buf.permute(1, 0, 2).reshape(step, ndev * k).cpu().numpy()

    def _drops(self, state) -> dict:
        c = None if state is None else torch.stack(
            [state.drops_in, state.drops_fire, state.drops_route])
        d_in, d_fire, d_route = self._collect(c, (3,), torch.int32,
                                              1)[0].tolist()
        return {"in": d_in, "fire": d_fire, "route": d_route}

    # -- driver -------------------------------------------------------------
    def run(self, ext, n_ticks: int | None = None):
        """Run ``ext`` (the global staged (T, H, A_ext) array or tensor,
        iterable of frames, or callable ext_fn(t) with ``n_ticks``) to
        completion through crashes, rank losses and graceful rescales.
        Returns (fired history (T, H) int32 numpy, health report dict) on
        every surviving rank; raises `DeviceLoss` on a rank that is lost."""
        sim = self.sim
        sim._unshard()
        t0 = int(sim.state.t)
        if callable(ext):
            ext = N.stage_external(ext, n_ticks, t0=t0, device="cpu")
        else:
            ext = N.stage_external(ext, device="cpu")
        if n_ticks is not None:
            ext = ext[:n_ticks]
        T = int(ext.shape[0])
        fired = np.full((T, sim.n_hcu), -1, np.int32)
        initial = host_copy(sim.state)
        self._template = initial
        self._specs = list(DD._spec_pairs(initial,
                                               DD._shard_specs()[0]))
        self._conn_host = host_copy(sim.conn)
        sim.state = None                 # the ranks hold their slices
        ndev = self._usable()
        state, conn = self._place(initial, ndev)
        self.monitor.begin(N.drop_counters(initial))
        done, chunks_done = 0, 0
        while done < T:
            step = min(self.chunk_ticks, T - done)
            chunk = done // self.chunk_ticks
            try:
                if self.rescale is not None:
                    want = self.rescale(chunk)
                    if want and self._usable(want) != ndev:
                        # graceful elasticity: pure data movement at a chunk
                        # boundary — no restore, no replay, bits unchanged
                        host = self._global(state, ndev)
                        ndev = self._usable(want)
                        state, conn = self._place(host, ndev)
                        log.info("rescaled onto %d rank(s) at tick %d",
                                 ndev, t0 + done)
                if self.fail_injector is not None:
                    lost = self.fail_injector(chunk)
                    if lost:
                        if lost is True:
                            raise InjectedFailure(
                                f"injected crash at tick {t0 + done}")
                        raise DeviceLoss(int(lost))
                self.monitor.chunk_start(step)
                mesh, _, fn, graphs = self._lower(ndev)
                f = None
                if mesh is not None:
                    k = sim.n_hcu // ndev
                    state, f = fn(state, conn, ext[done:done + step,
                                                   mesh.rank * k:
                                                   (mesh.rank + 1) * k],
                                  chunk=self.chunk_ticks, graphs=graphs)
                fired[done:done + step] = self._fired(f, step, ndev)
                done += step
                chunks_done += 1
                self.monitor.chunk_end(step, self._drops(state))
                if chunks_done % self.save_every == 0:
                    # full logical arrays — restorable onto ANY future mesh
                    host = self._global(state, ndev)
                    if self.ckpt is not None:
                        self.ckpt.save_async(t0 + done, _ckpt_tree(host))
            except InjectedFailure as e:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise RestartBudgetExceeded(
                        f"{self.restarts - 1} restarts exhausted the budget "
                        f"of {self.max_restarts}") from e
                rec_start = time.monotonic()
                state = conn = None
                if isinstance(e, DeviceLoss):
                    if e.n_lost >= len(self.devices):
                        raise RestartBudgetExceeded(
                            "all devices lost — nothing to remesh onto"
                        ) from e
                    gone = self.devices[len(self.devices) - e.n_lost:]
                    del self.devices[len(self.devices) - e.n_lost:]
                    if self.me in gone:
                        raise
                    self._alive = self._group_of(self.devices)
                if self.ckpt is not None:
                    self.ckpt.wait()
                dist.barrier(group=self._alive)   # the checkpoint is on disk
                restored, t_saved = restore_latest(
                    self.ckpt_dir, _shape_template(initial))
                if restored is None:
                    host, done = initial, 0
                else:
                    host, done = restored, int(t_saved) - t0
                ndev = self._usable()
                state, conn = self._place(host, ndev)
                del host, restored
                rec = {"kind": ("device-loss" if isinstance(e, DeviceLoss)
                                else "crash"),
                       "restored_tick": t0 + done,
                       "devices": ndev,
                       "recovery_s": time.monotonic() - rec_start}
                self.recoveries.append(rec)
                log.warning("restart %d/%d (%s): restored t=%d onto %d "
                            "rank(s) in %.3f s", self.restarts,
                            self.max_restarts, rec["kind"], t0 + done, ndev,
                            rec["recovery_s"])
        if self.ckpt is not None:
            self.ckpt.wait()
        # hand the global final state back to the facade
        final = self._global(state, ndev)
        sim.graphs.clear()
        to_dev = lambda a: a.to(sim.device)
        sim.state = N.tree_map(to_dev, final)
        sim.conn = N.tree_map(to_dev, self._conn_host)
        return fired, self.monitor.report(restarts=self.restarts)
