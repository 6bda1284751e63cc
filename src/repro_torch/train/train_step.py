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

Under a mesh the parameters, moments and batch are DTensors
(`launch.train.train(mesh=...)`): autograd gives DTensor gradients, AdamW
reduces them (`train.optimizer`), and the cross entropy of vocab-sharded
logits reduces its log-sum-exp over the vocab's ranks (`_token_terms`)
instead of gathering the logits.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.profiler import record_function

from repro_torch.convert import lm_leaf_groups
from repro_torch.models.sharding import shard_offset, sum_over_ranks
from repro_torch.models.transformer import Model
from repro_torch.train.optimizer import AdamW

AUX_LOSS_WEIGHT = 0.01
Z_LOSS_WEIGHT = 1e-4


def model_params(model: Model) -> dict:
    """The model's parameter tensors by state-dict name."""
    return dict(model.named_parameters())


def cross_entropy(logits, labels, z_loss: float = Z_LOSS_WEIGHT):
    """Token-mean CE with z-loss; logits (B,S,V) any dtype, labels (B,S).
    Returns (ce + z_loss * mean(lse^2), ce), float32. DTensor logits take
    `_token_terms`: the vocab is never gathered."""
    if isinstance(logits, DTensor):
        lse, ll = _token_terms(logits, labels)
    else:
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    ce = torch.mean(lse - ll)
    zl = torch.mean(torch.square(lse))
    return ce + z_loss * zl, ce


def _token_terms(logits, labels):
    """Each token's log-sum-exp and label logit, (B, S) DTensors laid out
    as the logits' rows, from DTensor logits. Each rank works on its own
    block: where the vocab is split over ranks, the maximum and the sum of
    exponentials are reduced over them, and the label logit comes from the
    rank that holds it (the others add zero); elsewhere the terms are those
    of the one-device path, op for op."""
    mesh = logits.device_mesh
    vd = logits.ndim - 1
    split = [isinstance(p, Shard) and p.dim == vd for p in logits.placements]
    tp = [i for i, v in enumerate(split) if v and mesh.size(i) > 1]
    rows = tuple(Replicate() if v else p
                 for v, p in zip(split, logits.placements))
    loc = logits.to_local().float()
    lab = labels.redistribute(mesh, rows).to_local()[..., None].long()
    if not tp:
        lse = torch.logsumexp(loc, dim=-1)
        ll = torch.gather(loc, -1, lab)[..., 0]
    else:
        groups = [mesh.get_group(i) for i in tp]
        m = loc.detach().amax(dim=-1)
        for g in groups:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
        se = torch.sum(torch.exp(loc - m[..., None]), dim=-1)
        lse = torch.log(sum_over_ranks(se, groups)) + m
        off = shard_offset(mesh, tp, loc.shape[-1])
        inr = (lab >= off) & (lab < off + loc.shape[-1])
        ll = torch.gather(loc, -1, torch.where(inr, lab - off, 0))
        ll = sum_over_ranks(torch.where(inr, ll, 0.0)[..., 0], groups)
    wrap = lambda t: DTensor.from_local(t, mesh, rows, run_check=False)
    return wrap(lse), wrap(ll)


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


def _plain(t):
    """A replicated DTensor scalar as the plain tensor every rank holds."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def make_train_step(model: Model, opt: AdamW):
    """step(params, opt_state, batch) -> (params, opt_state, metrics):
    metrics hold loss (the CE), aux, total, grad_norm and lr as 0-d
    float32 tensors on the model's device (no host read). Under a mesh
    (`models.sharding.use_rules` over a DeviceMesh, DTensor parameters and
    batch) the step is the same code; the metrics are plain tensors, the
    same on every rank."""
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
        metrics = {k: _plain(v.detach()) for k, v in metrics.items()}
        return params, opt_state, dict(metrics, total=_plain(total),
                                       **opt_metrics)

    return train_step


def make_eval_step(model: Model):
    loss_fn = make_loss_fn(model)

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, batch)
        return metrics

    return eval_step
