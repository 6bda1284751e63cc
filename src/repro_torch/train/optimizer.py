"""AdamW as plain tensor code (the port of `repro.train.optimizer`).

The optimizer state is congruent with the parameters: ``mu`` and ``nu``
are float32 tensors of the parameters' shapes under the same names. The
update follows the JAX package's operation for operation: the global-norm
clip (norm + 1e-9), the linear warm-up step / max(warmup_steps, 1), the
bias corrections 1 - b ** step computed in float32, and decoupled weight
decay on every leaf. Neither `torch.optim` (whose AdamW orders the
operations differently) nor a fused or foreach kernel runs here.

Parameters are a mapping name -> tensor. The global norm sums the leaves
in the JAX tree's order: by default each name is a leaf and the names
are sorted (the order of a flat dict in JAX); `make_train_step` passes
the JAX parameter tree's leaves, each a group of the port's per-layer
tensors (`repro_torch.convert.lm_leaf_groups`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard


class AdamWState(NamedTuple):
    step: torch.Tensor     # () int32
    mu: dict               # name -> float32 tensor
    nu: dict


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100

    def init(self, params, placements=None) -> AdamWState:
        """Zero moments congruent with ``params``. DTensor parameters get
        DTensor moments, laid out as ``placements`` (name -> placements,
        `launch.shardings.opt_specs`) or, by default, as the parameters."""
        def z(n, p):
            if not isinstance(p, DTensor):
                return torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
            from torch.distributed.tensor import zeros
            place = p.placements if placements is None else placements[n]
            return zeros(p.shape, dtype=torch.float32,
                         device_mesh=p.device_mesh, placements=place)
        dev = next(iter(params.values())).device
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          mu={n: z(n, p) for n, p in params.items()},
                          nu={n: z(n, p) for n, p in params.items()})

    def schedule(self, step):
        """The learning rate at ``step`` (an int32 tensor): float32."""
        warm = torch.clamp(step.float() / max(self.warmup_steps, 1), max=1.0)
        return self.lr * warm

    def update(self, grads, state: AdamWState, params, groups=None):
        """One AdamW step: (params, state, {"grad_norm", "lr"}). The new
        parameters and moments are written into ``params`` and ``state``'s
        tensors leaf by leaf, as the JAX launcher donates both to its step
        (no second copy of the state); the returned dicts are those.

        ``groups``: the JAX tree's leaves in its flatten order, each a list
        of names whose squares sum into that leaf's term of the norm
        (default: one sorted name a leaf).

        DTensor parameters (a mesh) take their gradients in the moments'
        layout first (a sum over the ranks that split the batch, scattered
        where the moments are ZeRO-sharded); each leaf's sum of squares is
        then a full reduction over the ranks, and the leaves are summed in
        the same order. The update itself is elementwise, on each rank's
        local tensors; a ZeRO-sharded update is gathered into the
        parameter's layout.
        """
        groups = groups if groups is not None else [[n] for n in sorted(params)]
        sharded = isinstance(next(iter(params.values())), DTensor)
        if sharded:
            grads = {n: grads[n].redistribute(state.mu[n].device_mesh,
                                              state.mu[n].placements)
                     for n in params}
            sums = _sums_of_squares(grads)
            sq = lambda n: sums[n]
        else:
            sq = lambda n: torch.sum(torch.square(grads[n].float()))
        gnorm = torch.sqrt(sum(sum(sq(n) for n in g) for g in groups))
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        step = state.step + 1
        lr = self.schedule(step)
        stepf = step.float()
        c1 = 1.0 - torch.pow(self.b1, stepf)
        c2 = 1.0 - torch.pow(self.b2, stepf)

        with torch.no_grad():
            for n, p in params.items():
                if not sharded:
                    self._step(p, grads[n], state.mu[n], state.nu[n], scale,
                               lr, c1, c2)
                    continue
                mu = state.mu[n]
                mesh, place = mu.device_mesh, mu.placements
                if tuple(place) == tuple(p.placements):
                    self._step(p.to_local(), grads[n].to_local(),
                               mu.to_local(), state.nu[n].to_local(), scale,
                               lr, c1, c2)
                    continue
                shard = p.redistribute(mesh, place).to_local().clone()
                self._step(shard, grads[n].to_local(), mu.to_local(),
                           state.nu[n].to_local(), scale, lr, c1, c2)
                new = DTensor.from_local(shard, mesh, place, run_check=False)
                p.to_local().copy_(new.redistribute(
                    mesh, p.placements).to_local())
        return (params, AdamWState(step, state.mu, state.nu),
                {"grad_norm": gnorm, "lr": lr})

    def _step(self, p, g, mu, nu, scale, lr, c1, c2):
        """The elementwise update of one parameter, in place on plain
        tensors (the parameter, its gradient and moments, one layout)."""
        g = g.float() * scale
        m = self.b1 * mu + (1 - self.b1) * g
        v = self.b2 * nu + (1 - self.b2) * g * g
        u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
        u = u + self.weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))
        mu.copy_(m)
        nu.copy_(v)


def _sums_of_squares(grads) -> dict:
    """name -> the sum of squares of its DTensor gradient (no Partial
    placement left), a plain 0-d float32 tensor on every rank: the local
    sums, summed over the mesh dims that shard each one, with one
    all-reduce per set of such dims."""
    out, pending = {}, {}
    for n, g in grads.items():
        local = torch.sum(torch.square(g.to_local().float()))
        mesh = g.device_mesh
        dims = tuple(i for i, p in enumerate(g.placements)
                     if isinstance(p, Shard) and mesh.size(i) > 1)
        if dims:
            pending.setdefault((id(mesh), dims), (mesh, dims, []))[2].append(
                (n, local))
        else:
            out[n] = local
    for mesh, dims, items in pending.values():
        v = torch.stack([t for _, t in items])
        for i in dims:
            dist.all_reduce(v, group=mesh.get_group(i))
        out.update((n, s) for (n, _), s in zip(items, v))
    return out
