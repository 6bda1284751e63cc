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

    def init(self, params) -> AdamWState:
        z = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
        dev = next(iter(params.values())).device
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          mu={n: z(p) for n, p in params.items()},
                          nu={n: z(p) for n, p in params.items()})

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
        """
        groups = groups if groups is not None else [[n] for n in sorted(params)]
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
                g = grads[n].float() * scale
                m = self.b1 * state.mu[n] + (1 - self.b1) * g
                v = self.b2 * state.nu[n] + (1 - self.b2) * g * g
                u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
                u = u + self.weight_decay * p.float()
                p.copy_((p.float() - lr * u).to(p.dtype))
                state.mu[n].copy_(m)
                state.nu[n].copy_(v)
        return (params, AdamWState(step, state.mu, state.nu),
                {"grad_norm": gnorm, "lr": lr})
