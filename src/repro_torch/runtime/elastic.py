"""Elastic re-placement, failure recovery and straggler accounting (the
port of `repro.runtime.elastic`).

BCPNN makes elasticity unusually clean: every HCU's state is
self-contained ("no memory consistency problem", paper §II.B), so
re-scaling is pure data movement — each rank of the new mesh takes its
whole HCUs from the global state.

Components:
  remesh(tree, mesh, specs)   this rank's placement of a global tree on a
                              (new) HCU mesh (`launch.mesh.HcuMesh`) or LM
                              mesh (a DeviceMesh, DTensor leaves)
  remesh_network              the same for a BCPNN network (state + conn)
  StragglerMonitor            per-step deadline tracking; slow-step log +
                              skip-budget accounting (BCPNN spikes are
                              droppable by design — the paper's queue-drop
                              budget, Fig 7, prices exactly this)
  InjectedFailure             the simulated-fault exception: everything the
                              restart machinery is allowed to swallow
  DeviceLoss                  a simulated loss of ranks (recovered by
                              `resilience.ElasticRunner`)
  RestartableLoop             run steps with checkpoint/restore + simulated
                              failure injection, bounded by `max_restarts`

Snapshots go through the port's checkpointer (`repro_torch.checkpoint`),
in the JAX package's on-disk format. The BCPNN-specific layer
(crash-restore-replay over the tick engine, DRAM-retention bit flips, the
drop-budget health monitor, the sharded `ElasticRunner`) builds on these
in `repro_torch.runtime.resilience`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint import AsyncCheckpointer, restore_latest
from repro_torch.checkpoint.checkpointer import _flatten, _unflatten
from repro_torch.core import distributed as DD
from repro_torch.launch.mesh import HcuMesh
from repro_torch.models.sharding import P, placements, shard_tensor


def remesh(tree, mesh, specs):
    """This rank's placement of a global ``tree`` (a host copy, or tensors
    on any device) on ``mesh``. Pure data movement, bitwise.

    On an HCU mesh (`launch.mesh.HcuMesh`) ``specs`` is a congruent tree of
    `distributed.SHARD` / `REPLICATE` or one spec for every leaf: each
    sharded leaf cut to the rank's part of its leading axis, new tensors on
    the mesh's device. On an LM mesh (a DeviceMesh) ``specs`` is a
    congruent tree of `models.sharding.P` or one `P` for every leaf: each
    leaf becomes a DTensor of the spec's placements (a DTensor leaf is
    gathered first, so a tree moves between meshes)."""
    if isinstance(mesh, HcuMesh):
        return DD.place(tree, mesh, specs)
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.shardings import tree_map_with_path
    leaves, _ = _flatten(tree)
    if isinstance(specs, P):
        spec_leaves = [specs] * len(leaves)
    else:
        spec_leaves = []
        tree_map_with_path(lambda _, s: spec_leaves.append(s), specs)
    if len(spec_leaves) != len(leaves):
        raise ValueError(f"{len(spec_leaves)} specs for {len(leaves)} leaves")

    def one(x, s):
        x = x.full_tensor() if isinstance(x, DTensor) else torch.as_tensor(x)
        return shard_tensor(x, mesh, placements(s, mesh))
    return _unflatten(tree, iter(one(x, s)
                                 for x, s in zip(leaves, spec_leaves)))


def remesh_network(state, conn, mesh, axis="hcu"):
    """Re-place a BCPNN network (the global state and connectivity) onto
    ``mesh``: `remesh` with the HCU shard specs and nothing else — no
    consistency protocol, no replay. Under `lossless_route_config` the
    trajectory does not depend on where the remesh lands
    (tests/test_torch_elastic.py). A sharded network is gathered first
    (`distributed.gather_network`)."""
    state_specs, conn_specs = DD._shard_specs()
    return remesh(state, mesh, state_specs), remesh(conn, mesh, conn_specs)


def host_copy(tree):
    """A host snapshot of a tree of tensors: every tensor leaf copied to a
    CPU tensor (a true copy, which no later in-place update of the
    original can reach); other leaves copied as numpy arrays."""
    leaves, _ = _flatten(tree)
    return _unflatten(tree, iter(
        v.detach().to("cpu", copy=True) if torch.is_tensor(v)
        else np.array(v) for v in leaves))


def like(host, template):
    """``host`` (a `host_copy`) placed as ``template``'s leaves are: each
    tensor leaf a new tensor on the template leaf's device."""
    leaves, _ = _flatten(host)
    tmpl, _ = _flatten(template)
    return _unflatten(template, iter(
        h.to(t.device, copy=True) if torch.is_tensor(t) else np.array(h)
        for h, t in zip(leaves, tmpl, strict=True)))


class InjectedFailure(RuntimeError):
    """A *simulated* node failure raised by a `fail_injector`.

    Dedicated type so the restart machinery can recover from injected faults
    while real errors — a CUDA error, a shape bug — propagate to the caller
    instead of being silently retried forever."""


class DeviceLoss(InjectedFailure):
    """A simulated loss of `n_lost` mesh devices (the paper's tile-failure
    class, §II: an HCU tile is self-contained, so losing one is survivable
    by re-placing its hypercolumns). Unlike a plain `InjectedFailure` —
    restore and replay on the SAME devices — recovering from a DeviceLoss
    requires a remesh: the survivors get all H hypercolumns
    (`repro_torch.runtime.resilience.ElasticRunner`). The loss is modeled
    as the trailing `n_lost` ranks of the runner's list going away."""

    def __init__(self, n_lost: int = 1, message: str | None = None):
        super().__init__(message or f"injected loss of {n_lost} device(s)")
        self.n_lost = int(n_lost)


class RestartBudgetExceeded(RuntimeError):
    """Raised when a restart loop exhausts its `max_restarts` budget —
    the "crash loop" guard a real scheduler applies before paging a human."""


@dataclasses.dataclass
class StragglerMonitor:
    """Deadline-based straggler accounting for a fixed-rate loop.

    A step exceeding `deadline_s` is logged and (for droppable work like
    BCPNN spike delivery) may be skipped against a drop budget instead of
    stalling — the paper's 1-spike-per-month budget generalized. Wall-clock
    totals (`total_s`, `worst_s`, `last_s`) feed the realtime-deadline half
    of `repro_torch.runtime.resilience.HealthMonitor`. The caller stops the
    clock (`finish`) only after the step's results are on the host: a CUDA
    launch returns before the device has run it.
    """
    deadline_s: float
    slow_steps: int = 0
    skipped: int = 0
    total: int = 0
    total_s: float = 0.0
    worst_s: float = 0.0
    last_s: float = 0.0
    _last: float = 0.0

    def start(self):
        self._last = time.monotonic()

    def finish(self) -> bool:
        """Returns True if the step met its deadline."""
        dt = time.monotonic() - self._last
        self.total += 1
        self.total_s += dt
        self.last_s = dt
        if dt > self.worst_s:
            self.worst_s = dt
        if dt > self.deadline_s:
            self.slow_steps += 1
            return False
        return True

    def skip(self):
        self.skipped += 1

    def summary(self):
        return {"total": self.total, "slow": self.slow_steps,
                "skipped": self.skipped, "total_s": self.total_s,
                "worst_s": self.worst_s}


class RestartableLoop:
    """Checkpointed step loop with bounded failure recovery.

    fail_injector(step) -> bool lets tests simulate node failures (raised as
    `InjectedFailure`); on an injected failure the loop restores the latest
    checkpoint and continues — exactly the restart path a real deployment
    takes after re-scheduling. Only `InjectedFailure` is recovered: a real
    exception out of `step_fn` propagates immediately (it would recur on
    replay anyway). `max_restarts` bounds the recovery budget — an
    always-failing step (e.g. a failure injected before the first checkpoint
    ever lands) raises `RestartBudgetExceeded` instead of spinning forever.
    The state is a tree of tensors (NamedTuples, tuples, lists, dicts); a
    restored one has its leaves on the entry state's devices.
    """

    def __init__(self, ckpt_dir: str, save_every: int = 10,
                 fail_injector: Callable[[int], bool] | None = None,
                 max_restarts: int = 32):
        self.ckpt = AsyncCheckpointer(ckpt_dir)
        self.ckpt_dir = ckpt_dir
        self.save_every = save_every
        self.fail_injector = fail_injector
        self.max_restarts = max_restarts
        self.restarts = 0

    def run(self, state: Any, step_fn: Callable[[Any, int], Any],
            n_steps: int):
        # host snapshot of the entry state: a restart with no checkpoint on
        # disk must replay from HERE, not from the half-mutated live state
        initial = host_copy(state)
        step = 0
        while step < n_steps:
            try:
                if self.fail_injector and self.fail_injector(step):
                    raise InjectedFailure(f"injected failure at step {step}")
                state = step_fn(state, step)
                step += 1
                if step % self.save_every == 0:
                    self.ckpt.save_async(step, state)
            except InjectedFailure as e:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise RestartBudgetExceeded(
                        f"{self.restarts - 1} restarts exhausted the budget "
                        f"of {self.max_restarts}") from e
                self.ckpt.wait()
                restored, s = restore_latest(self.ckpt_dir, state)
                if restored is None:
                    # no checkpoint yet: restart from scratch
                    state = like(initial, state)
                    step = 0
                else:
                    state, step = restored, s
        self.ckpt.wait()
        return state, step
