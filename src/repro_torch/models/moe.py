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
none runs here. Under a mesh the experts are sharded over "expert"
(`_moe_ffn_mesh`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.base import ArchConfig, ParamTree, dense_init
from repro_torch.models.sharding import active_mesh, hint


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


def _dispatch(xt, top_e, cfg: ArchConfig):
    """Capacity dispatch of the tokens xt (T, D): stable sort by expert,
    rank within the expert. Returns (buf (E, cap, D) in the compute dtype,
    slot (M,) of each (token, pick) with E * cap for a drop, ok (M,))."""
    T, D = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    M = T * K
    flat_e = top_e.reshape(M)
    cap = capacity(cfg, T)
    order = torch.argsort(flat_e, stable=True)
    rank = _rank_within_sorted_key(flat_e, order)
    ok = rank < cap
    slot = torch.where(ok, flat_e * cap + rank, E * cap)    # E*cap: dropped
    tok = torch.arange(M, device=xt.device) // K
    buf = torch.zeros((E * cap + 1, D), dtype=cfg.cdtype, device=xt.device)
    buf[slot] = xt.to(cfg.cdtype)[tok]
    return buf[:E * cap].reshape(E, cap, D), slot, ok


def _experts(params, buf, cfg: ArchConfig):
    """The experts, batched: (E, cap, D) -> (E, cap, D)."""
    cd = cfg.cdtype
    act = _act(cfg)
    h = act(torch.bmm(buf, params["wg"].to(cd))) \
        * torch.bmm(buf, params["wi"].to(cd))
    return torch.bmm(h, params["wo"].to(cd))


def _combine(params, out_e, xt, slot, ok, top_w, cfg: ArchConfig):
    """The experts' outputs (E * cap, D) weighted back onto the tokens,
    plus the shared experts: (T, D) in the compute dtype."""
    T, D = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    cd = cfg.cdtype
    cap = out_e.shape[0] // E
    gathered = out_e[torch.clamp(slot, max=E * cap - 1)]    # (M, D)
    w = torch.where(ok, top_w.reshape(T * K), 0.0).to(cd)
    out = (gathered * w[:, None]).reshape(T, K, D).sum(dim=1)
    if cfg.n_shared_experts:
        sp = params["shared"]
        act = _act(cfg)
        xc = xt.to(cd)
        hs = act(xc @ sp["wg"].to(cd)) * (xc @ sp["wi"].to(cd))
        out = out + hs @ sp["wo"].to(cd)
    return out


def _aux(probs, top_e, ok, E: int):
    me = F.one_hot(top_e[:, 0], E).float().mean(dim=0)
    ce = probs.mean(dim=0)
    return {"lb_loss": E * torch.sum(me * ce),
            "drop_frac": 1.0 - ok.float().mean()}


def moe_ffn(params, x, cfg: ArchConfig):
    """x (B, S, D) -> (out (B, S, D) in the compute dtype, aux dict)."""
    if active_mesh() is not None:
        return _moe_ffn_mesh(params, x, cfg)
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    probs, top_w, top_e = route(params, xt, cfg)
    buf, slot, ok = _dispatch(xt, top_e, cfg)
    out_e = _experts(params, buf, cfg).reshape(-1, D)
    out = _combine(params, out_e, xt, slot, ok, top_w, cfg)
    return out.reshape(B, S, D), _aux(probs, top_e, ok, cfg.n_experts)


def _moe_ffn_mesh(params, x, cfg: ArchConfig):
    """`moe_ffn` under a mesh. The routing, the sorted dispatch and the
    combine have no DTensor rule and need every token (the capacity is the
    whole batch's): they run whole on each rank, on the gathered tokens and
    the gathered router and shared experts. The experts run on DTensors,
    sharded over "expert" (and the capacity over "batch" with
    ``moe_shard_cap``), as the JAX package's hints lay them out."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = active_mesh()
    rep = (Replicate(),) * mesh.ndim
    whole = lambda t: t.redistribute(mesh, rep).to_local()
    B, S, D = x.shape
    xt = whole(x).reshape(B * S, D)
    local = {"router": whole(params["router"])}
    if cfg.n_shared_experts:
        local["shared"] = {k: whole(v) for k, v in params["shared"].items()}
    probs, top_w, top_e = route(local, xt, cfg)
    buf, slot, ok = _dispatch(xt, top_e, cfg)
    cap_ax = "batch" if cfg.moe_shard_cap else None
    buf = hint(DTensor.from_local(buf, mesh, rep, run_check=False),
               "expert", cap_ax, None)
    out_e = hint(_experts(params, buf, cfg), "expert", cap_ax, None)
    out = _combine(local, whole(out_e).reshape(-1, D), xt, slot, ok, top_w,
                   cfg)
    out = DTensor.from_local(out.reshape(B, S, D), mesh, rep, run_check=False)
    aux = {k: DTensor.from_local(v, mesh, rep, run_check=False)
           for k, v in _aux(probs, top_e, ok, cfg.n_experts).items()}
    return out.redistribute(mesh, x.placements), aux
