"""Training step factory (the port of `repro.train.train_step`): loss,
gradients through `torch.autograd`, the AdamW update, metrics.

The port's parameters live in the `Model`. A step's ``params`` is
`model_params(model)`: the model's own parameter tensors by state-dict
name. `make_train_step`'s step updates them and the optimizer state in
place, as the JAX launcher donates both to its jitted step, and returns
them. The forward is `Model.forward`, with each block rematerialised in
the backward where ``cfg.remat`` is set (`Model._run_stack`). The cross
entropy and the optimizer update run under profiler ranges of those names
("cross_entropy", "adamw"), which a device trace attributes time by.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.convert import lm_leaf_groups
from repro_torch.models.transformer import Model
from repro_torch.train.optimizer import AdamW

AUX_LOSS_WEIGHT = 0.01
Z_LOSS_WEIGHT = 1e-4


def model_params(model: Model) -> dict:
    """The model's parameter tensors by state-dict name."""
    return dict(model.named_parameters())


def cross_entropy(logits, labels, z_loss: float = Z_LOSS_WEIGHT):
    """Token-mean CE with z-loss; logits (B,S,V) any dtype, labels (B,S).
    Returns (ce + z_loss * mean(lse^2), ce), float32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    ce = torch.mean(lse - ll)
    zl = torch.mean(torch.square(lse))
    return ce + z_loss * zl, ce


def make_loss_fn(model: Model):
    def loss_fn(params, batch):
        _check_params(model, params)
        logits, aux = model.forward(batch)
        with record_function("cross_entropy"):
            total, ce = cross_entropy(logits, batch["labels"])
        total = total + AUX_LOSS_WEIGHT * aux
        return total, {"loss": ce, "aux": aux}
    return loss_fn


def _check_params(model: Model, params):
    own = dict(model.named_parameters())
    if params.keys() != own.keys() or any(params[n] is not p
                                          for n, p in own.items()):
        raise ValueError("params must be the model's own parameters "
                         "(model_params(model))")


def make_train_step(model: Model, opt: AdamW):
    """step(params, opt_state, batch) -> (params, opt_state, metrics):
    metrics hold loss (the CE), aux, total, grad_norm and lr as 0-d
    float32 tensors on the model's device (no host read)."""
    loss_fn = make_loss_fn(model)
    groups = [names for _, _, names in
              lm_leaf_groups(model.cfg, dict(model.named_parameters()))]

    def train_step(params, opt_state, batch):
        total, metrics = loss_fn(params, batch)
        names = list(params)
        # a leaf the loss does not reach gets zeros, as under jax.grad
        grads = torch.autograd.grad(total, [params[n] for n in names],
                                    allow_unused=True, materialize_grads=True)
        grads = dict(zip(names, grads))
        total = total.detach()
        with record_function("adamw"):
            params, opt_state, opt_metrics = opt.update(
                grads, opt_state, params, groups=groups)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, dict(metrics, total=total, **opt_metrics)

    return train_step


def make_eval_step(model: Model):
    loss_fn = make_loss_fn(model)

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, batch)
        return metrics

    return eval_step
