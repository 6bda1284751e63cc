"""Shared transformer layers (the port of `repro.models.layers`): RMSNorm,
RoPE, GQA attention with a KV cache, gated MLP.

Functions take their parameters as a mapping of tensors (an
`nn.ParameterDict` inside the model, a plain dict in the tests), in the
JAX package's layouts: activations (B, S, D), heads (B, S, H, hd), caches
(B, max_len, Kv, hd). Parameters are float32 and are cast to
``cfg.cdtype`` at every matmul; logits, softmax and PV run in float32.
The JAX package's sharding hints (`models.sharding.hint`) stand where it
has them: the identity without a mesh, a DTensor redistribution under
one. The flash kernel takes plain tensors only (a DTensor that reaches
`kernels.ops.flash_attention` raises): under a mesh it runs in a local
region (`sharding.local_flash`) on each rank's block, and a cached
prefill or decode writes each rank's shard of the KV cache in place
(`sharding.write_local`).

Attention covers, through arguments: GQA with any kv-head count, QKV bias
(qwen2), logit softcap (gemma2), sliding windows (gemma2's local layers),
partial rotary (stablelm), cross-attention over a memory (the VLM and
audio decoders), bidirectional attention (the audio encoder), and cached
prefill / decode with ragged left padding. A causal self-attention
prefill takes the flash kernel (`repro_torch.kernels.ops.flash_attention`)
under ``attn_impl="pallas_flash"`` when its shapes allow, else the chunked
or the dense path, chosen as `repro.models.layers.attend` chooses.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.base import ArchConfig, dense_init
from repro_torch.models.sharding import (hint, is_sharded, local_attention,
                                         local_flash, mapped_size, replicate,
                                         write_local)

NEG_INF = -1e30


def rms_norm(x, w, eps: float):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def _rope_freqs(positions, dim: int, theta: float, dtype):
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[..., None] * inv                 # (..., dim/2)
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x, positions, theta: float, rotary_pct: float = 1.0):
    """x: (B, S, H, hd); positions: (B, S) or (S,). Rotates INTERLEAVED
    pairs (x[..., ::2], x[..., 1::2]) of the first ``rotary_pct`` of the
    head dims, as the JAX package does (not HF's rotate_half)."""
    hd = x.shape[-1]
    rot = int(hd * rotary_pct) // 2 * 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    cos, sin = _rope_freqs(positions, rot, theta, x.dtype)   # (B,S,rot/2)
    cos = cos[:, :, None, :] if cos.dim() == 3 else cos[None, :, None, :]
    sin = sin[:, :, None, :] if sin.dim() == 3 else sin[None, :, None, :]
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out, xp], dim=-1) if rot < hd else out


class KVCache(NamedTuple):
    """k, v (B, max_len, Kv, hd) in the compute dtype; ``length`` the valid
    prefix, a Python int (so the flash kernel gets it without a device
    read). `attend` writes the new keys and values into k and v IN PLACE
    and returns the cache with the longer length."""
    k: torch.Tensor
    v: torch.Tensor
    length: int


def init_attn(cfg: ArchConfig, generator, device, d_model=None):
    D = d_model or cfg.d_model
    H, Kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    init = lambda shape: nn.Parameter(dense_init(shape, cfg.pdtype, generator,
                                                 device))
    p = {"wq": init((D, H * hd)), "wk": init((D, Kv * hd)),
         "wv": init((D, Kv * hd)), "wo": init((H * hd, D))}
    if cfg.qkv_bias:
        for name, n in (("bq", H * hd), ("bk", Kv * hd), ("bv", Kv * hd)):
            p[name] = nn.Parameter(torch.zeros(n, dtype=cfg.pdtype,
                                               device=device))
    return nn.ParameterDict(p)


def _sdpa(q, k, v, mask, softcap, scale):
    """q: (B,Sq,Kv,G,hd)  k,v: (B,Skv,Kv,hd)  mask: (B|1, Sq, Skv) bool."""
    logits = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.to(v.dtype)


def _sdpa_chunked(q, k, v, mask, softcap, scale, chunk: int):
    """Online-softmax attention over KV chunks of ``chunk`` keys: the math
    of `_sdpa` without the (Sq, Skv) logits. Shapes as in `_sdpa`."""
    B, Sq, Kv, G, hd = q.shape
    Skv = k.shape[1]
    dev = q.device
    qf = q.float()
    m = torch.full((B, Kv, G, Sq), float("-inf"), dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, Kv, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Kv, G, Sq, hd), dtype=torch.float32, device=dev)
    for c0 in range(0, Skv, chunk):
        kb, vb = k[:, c0:c0 + chunk].float(), v[:, c0:c0 + chunk].float()
        mb = mask[:, :, c0:c0 + chunk]
        n = kb.shape[1]
        if n < chunk:   # the JAX package pads the last chunk: masked zeros
            kb = F.pad(kb, (0, 0, 0, 0, 0, chunk - n))
            vb = F.pad(vb, (0, 0, 0, 0, 0, chunk - n))
            mb = F.pad(mb, (0, chunk - n), value=False)
        logits = torch.einsum("bqkgh,bskh->bkgqs", qf, kb) * scale
        if softcap:
            logits = torch.tanh(logits / softcap) * softcap
        logits = torch.where(mb[:, None, None, :, :], logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqs,bskh->bkgqh", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(v.dtype)            # (B,Sq,Kv,G,hd)


def _sdpa_flash(q, k, v, cfg: ArchConfig, scale, sliding_window, kv_len):
    """The flash kernel's path, on the tensors as they lie: q (B,Sq,H,hd)
    from the projections, k / v (B,Skv,Kv,hd) (the KV cache itself when
    there is one). The kernel reads each kv head for its G query heads, so
    nothing is repeated, permuted or copied; returns (B,Sq,H,hd). Under a
    mesh it runs on each rank's block (`sharding.local_flash`)."""
    return local_flash(ops.flash_attention, q, k, v, scale=scale,
                       causal=True, window=sliding_window,
                       softcap=cfg.attn_softcap, kv_len=kv_len)


def attend(params, x, cfg: ArchConfig, *, positions, kv=None,
           kv_positions=None, causal=True, sliding_window=None,
           cache: Optional[KVCache] = None, pad=None):
    """Attention; returns (out (B,Sq,D), cache).

    Self-attention: ``kv`` None. Cross-attention: ``kv`` the memory
    (B, Skv, D) that keys and values are projected from, usually with
    ``causal=False``; RoPE applies to self-attention only, and the
    memory's keys sit at ``kv_positions`` (default 0..Skv-1).
    ``causal=False`` lets every query see every valid key (the encoder's
    bidirectional attention and cross-attention).

    With ``cache`` (self-attention only) this is a cached prefill (Sq > 1)
    or decode step (Sq == 1): the new keys and values go to slots
    [length, length + Sq) of the cache, in place; past ``max_len`` it
    raises (the JAX package clamps the start there).

    ``pad`` ((B,) int64 per-row LEFT-pad lengths) serves ragged waves out
    of one cache: the caller passes positions already shifted by -pad; the
    first pad[b] cache slots of row b are masked and kv positions shifted
    to match.
    """
    B, Sq, D = x.shape
    H, Kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    G = H // Kv
    cd = cfg.cdtype

    # the projections take their input whole over "model": the residual
    # is sharded over "model_d" (the hint on each block's output), and
    # torch 2.11's DTensor would contract over that shard and leave q
    # Partial, which its add of a sharded bias then refuses
    x = hint(x, "batch", None, None)
    src = x if kv is None else hint(kv, "batch", None, None)
    Skv = src.shape[1]
    q = x @ params["wq"].to(cd)
    k = src @ params["wk"].to(cd)
    v = src @ params["wv"].to(cd)
    if cfg.qkv_bias:
        q = q + params["bq"].to(cd)
        k = k + params["bk"].to(cd)
        v = v + params["bv"].to(cd)
    # TP shards heads when they divide the model axis; otherwise fall back
    # to sequence-parallel attention (queries sharded over "model") instead
    # of silently replicating the O(S^2) work on every TP rank. The JAX
    # package hints q and k after RoPE; a DTensor cannot split a sharded
    # (H * hd) dim into heads that do not divide the axis, so the same
    # layouts are set here before the split (v takes k's), and RoPE keeps
    # them.
    tp = mapped_size("heads")
    seq_mp = tp > 1 and H % tp != 0 and Sq > 1
    q_axes = ("batch", "seq_mp", None, None) if seq_mp else \
        ("batch", None, "heads", None)
    q = hint(q, *q_axes, shape=(B, Sq, H, hd)).reshape(B, Sq, H, hd)
    k = hint(k, "batch", None, "heads", None,
             shape=(B, Skv, Kv, hd)).reshape(B, Skv, Kv, hd)
    v = hint(v, "batch", None, "heads", None,
             shape=(B, Skv, Kv, hd)).reshape(B, Skv, Kv, hd)
    if kv is None:   # RoPE only for self-attention
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
        k = apply_rope(k, positions if kv_positions is None else kv_positions,
                       cfg.rope_theta, cfg.rotary_pct)

    cached = cache is not None and kv is None
    if cached:
        start, max_len = cache.length, cache.k.shape[1]
        if start + Sq > max_len:
            raise ValueError(f"KV cache overflow: {start} + {Sq} > {max_len}")
        if hasattr(cache.k, "device_mesh"):      # a DTensor cache
            write_local(cache.k, k, start)
            write_local(cache.v, v, start)
        else:
            cache.k[:, start:start + Sq] = k.to(cache.k.dtype)
            cache.v[:, start:start + Sq] = v.to(cache.v.dtype)
        cache = KVCache(cache.k, cache.v, start + Sq)
        k, v = cache.k, cache.v

    Skv = k.shape[1]
    scale = cfg.query_scale if cfg.query_scale else hd ** -0.5
    if is_sharded(q, 2) and not is_sharded(k, 2):
        # heads sharded, kv heads too few to follow: each rank attends its
        # query heads against their kv heads, repeated to one per head
        k, v = (torch.repeat_interleave(t, G, dim=2) for t in (k, v))
        k, v = (hint(t, "batch", None, "heads", None) for t in (k, v))
        qg = q.reshape(B, Sq, H, 1, hd)
    else:
        qg = q.reshape(B, Sq, Kv, G, hd)
    # the flash path has no per-row pad mask and no query-row offset (a
    # query block cut along the sequence by a mesh takes the other paths)
    use_flash = (cfg.attn_impl == "pallas_flash" and Sq > 1 and kv is None
                 and causal and Sq % 128 == 0 and Skv % 128 == 0
                 and pad is None and not is_sharded(q, 1))
    if use_flash:
        out = _sdpa_flash(q, k, v, cfg, scale, sliding_window,
                          cache.length if cached else None)
    else:
        mask = _mask(positions, Skv, x.device, cache if cached else None,
                     pad, sliding_window, kv_positions, causal)
        if cfg.attn_impl in ("chunked", "pallas_flash") and Sq > 1 \
                and Skv > cfg.attn_chunk:
            out = local_attention(_sdpa_chunked, qg, k, v, mask,
                                  cfg.attn_softcap, scale, cfg.attn_chunk)
        else:
            out = local_attention(_sdpa, qg, k, v, mask, cfg.attn_softcap,
                                  scale)
    out = out.reshape(B, Sq, H * hd) @ params["wo"].to(cd)
    return hint(out, "batch", None, "model_d"), cache


def _mask(positions, Skv, device, cache, pad, sliding_window,
          kv_positions=None, causal=True):
    """(B|1, Sq, Skv) bool: the keys each query may attend to (causal or
    not; the cache's valid prefix less each row's pad slots; the window)."""
    q_pos = positions if positions.dim() == 2 else positions[None, :]
    Sq = q_pos.shape[1]
    if cache is not None:
        kv_pos = torch.arange(Skv, device=device)[None, :]
        valid = kv_pos < cache.length
        if pad is not None:
            valid = valid & (kv_pos >= pad[:, None])
            kv_pos = kv_pos - pad[:, None]
    else:
        kv_pos = (torch.arange(Skv, device=device) if kv_positions is None
                  else kv_positions)[None, :]
        valid = torch.ones((1, Skv), dtype=torch.bool, device=device)
    if causal:
        mask = (q_pos[:, :, None] >= kv_pos[:, None, :]) & valid[:, None, :]
    else:
        mask = valid[:, None, :].expand(valid.shape[0], Sq, Skv)
    if sliding_window:
        mask = mask & (q_pos[:, :, None] - kv_pos[:, None, :] < sliding_window)
    return replicate(mask)


def init_mlp(cfg: ArchConfig, generator, device, d_ff=None, d_model=None):
    D = d_model or cfg.d_model
    Fd = d_ff or cfg.d_ff
    init = lambda shape: nn.Parameter(dense_init(shape, cfg.pdtype, generator,
                                                 device))
    return nn.ParameterDict({"wi": init((D, Fd)), "wg": init((D, Fd)),
                             "wo": init((Fd, D))})


def mlp(params, x, cfg: ArchConfig):
    """Gated MLP: act(x wg) * (x wi) wo; gelu is the tanh approximation
    (`jax.nn.gelu`'s default)."""
    cd = cfg.cdtype
    x = hint(x, "batch", None, None)     # as `attend`'s input
    g = x @ params["wg"].to(cd)
    g = F.silu(g) if cfg.act == "silu" else F.gelu(g, approximate="tanh")
    h = hint(g * (x @ params["wi"].to(cd)), "batch", None, "model_d")
    return h @ params["wo"].to(cd)
