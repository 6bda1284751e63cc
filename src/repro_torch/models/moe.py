"""Mixture-of-Experts FFN with capacity-based sort dispatch (the port of
`repro.models.moe`).

Tokens are routed to expert buffers of shape (E, cap, D) by the same
fixed-capacity rank allocation as the JAX package (a STABLE sort by
expert, rank within the expert, drop past ``cap``), the experts run as
batched matrix products, and the results are combined with the router
weights. The router and its softmax run in float32, whatever the compute
dtype. `moe_ffn` returns ``(out, {"lb_loss", "drop_frac"})``: the
switch-style load-balance loss and the fraction of (token, expert) picks
dropped past capacity. No Pallas kernel runs here in the JAX package, and
none runs here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.base import ArchConfig, ParamTree, dense_init


def _rank_within_sorted_key(keys, order):
    """Rank of each element among the elements with its key, in the order
    ``order`` visits them (``order`` sorts ``keys``)."""
    sorted_keys = keys[order]
    idx = torch.arange(keys.shape[0], device=keys.device)
    is_first = torch.ones_like(sorted_keys, dtype=torch.bool)
    is_first[1:] = sorted_keys[1:] != sorted_keys[:-1]
    first_pos = torch.cummax(torch.where(is_first, idx, 0), dim=0).values
    rank = torch.empty_like(idx)
    rank[order] = idx - first_pos
    return rank


def init_moe(cfg: ArchConfig, generator, device) -> ParamTree:
    """router (D, E) float32 whatever ``param_dtype`` is; experts wi / wg
    (E, D, F), wo (E, F, D); with ``n_shared_experts`` a shared gated MLP
    ``shared`` of width expert_d_ff * n_shared_experts."""
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.expert_d_ff
    init = lambda shape, dtype=cfg.pdtype, **kw: nn.Parameter(
        dense_init(shape, dtype, generator, device, **kw))
    p = ParamTree(router=init((D, E), torch.float32, scale=0.02),
                  wi=init((E, D, Fd)), wg=init((E, D, Fd)), wo=init((E, Fd, D)))
    if cfg.n_shared_experts:
        Fs = cfg.expert_d_ff * cfg.n_shared_experts
        p.shared = nn.ParameterDict({"wi": init((D, Fs)), "wg": init((D, Fs)),
                                     "wo": init((Fs, D))})
    return p


def capacity(cfg: ArchConfig, T: int) -> int:
    """Slots per expert for T tokens: max(8, round(T K / E * factor)),
    Python's round (half to even), as in the JAX package."""
    return int(max(8, round(T * cfg.top_k / cfg.n_experts
                            * cfg.moe_capacity_factor)))


def route(params, xt, cfg: ArchConfig):
    """Float32 routing of xt (T, D): (probs (T, E), top_w (T, K)
    renormalised, top_e (T, K))."""
    logits = xt.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, cfg.top_k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return probs, top_w, top_e


def _act(cfg: ArchConfig):
    return F.silu if cfg.act == "silu" else (
        lambda t: F.gelu(t, approximate="tanh"))


def moe_ffn(params, x, cfg: ArchConfig):
    """x (B, S, D) -> (out (B, S, D) in the compute dtype, aux dict)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    cd = cfg.cdtype
    xt = x.reshape(T, D)
    probs, top_w, top_e = route(params, xt, cfg)

    # capacity dispatch: stable sort by expert, rank within the expert
    M = T * K
    flat_e = top_e.reshape(M)
    cap = capacity(cfg, T)
    order = torch.argsort(flat_e, stable=True)
    rank = _rank_within_sorted_key(flat_e, order)
    ok = rank < cap
    slot = torch.where(ok, flat_e * cap + rank, E * cap)    # E*cap: dropped
    tok = torch.arange(M, device=x.device) // K
    buf = torch.zeros((E * cap + 1, D), dtype=cd, device=x.device)
    buf[slot] = xt.to(cd)[tok]
    buf = buf[:E * cap].reshape(E, cap, D)

    # the experts, batched
    act = _act(cfg)
    h = act(torch.bmm(buf, params["wg"].to(cd))) \
        * torch.bmm(buf, params["wi"].to(cd))
    out_e = torch.bmm(h, params["wo"].to(cd)).reshape(E * cap, D)

    # combine
    gathered = out_e[torch.clamp(slot, max=E * cap - 1)]    # (M, D)
    w = torch.where(ok, top_w.reshape(M), 0.0).to(cd)
    out = (gathered * w[:, None]).reshape(T, K, D).sum(dim=1)

    if cfg.n_shared_experts:
        sp = params["shared"]
        xc = xt.to(cd)
        hs = act(xc @ sp["wg"].to(cd)) * (xc @ sp["wi"].to(cd))
        out = out + hs @ sp["wo"].to(cd)

    me = F.one_hot(top_e[:, 0], E).float().mean(dim=0)
    ce = probs.mean(dim=0)
    aux = {"lb_loss": E * torch.sum(me * ce),
           "drop_frac": 1.0 - ok.float().mean()}
    return out.reshape(B, S, D), aux
