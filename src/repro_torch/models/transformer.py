"""Model assembly (the port of `repro.models.transformer`) for every
family: dense, MoE, SSM / hybrid, VLM and audio.

Every architecture is a sequence of blocks of a few kinds:

  attn         self-attention + gated MLP            (dense archs)
  attn_local   sliding-window self-attention + MLP   (gemma2 odd layers)
  attn_moe     self-attention + MoE FFN              (qwen3-moe, llama4)
  mamba        Mamba2 mixer block                    (zamba2 backbone)
  mlstm/slstm  xLSTM blocks                          (xlstm-125m)
  shared_attn  attention + MLP with SHARED weights   (zamba2 global block)
  cross        gated cross-attention + MLP           (llama3.2-vision)
  enc_attn     bidirectional attention + MLP         (whisper encoder)
  dec_cross    self-attn + cross-attn + MLP          (whisper decoder)

`build_stack_spec` is the JAX package's. The model's decoder layers are
an `nn.ModuleList` in stack order (segment, then repeat, then pattern
position), where the JAX package stacks each pattern position's
parameters along the repeats and scans them. Where autograd records and
``cfg.remat`` is set (training), each block runs under
`torch.utils.checkpoint` and is recomputed in the backward, as the JAX
package wraps each scanned step in `jax.checkpoint`; serving runs the
blocks as they are. The ``shared_attn`` positions hold no parameters: the one
shared block is `Model.shared_attn` (the JAX package's
``params["shared_attn"]``), applied at each of them with its own cache.
Each layer's cache is its recurrent state for the recurrent kinds and a
`KVCache` for the attention kinds (``cross`` too, which never writes
it, as in the JAX package).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.device import resolve_device
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.base import ArchConfig, ParamTree, dense_init
from repro_torch.models.layers import (KVCache, attend, init_attn, init_mlp,
                                       mlp, rms_norm)
from repro_torch.models.sharding import (active_mesh, bind, hint, replicate,
                                         vocab_gather)

ATTN_KINDS = ("attn", "attn_local", "attn_moe", "shared_attn", "enc_attn")
KV_CACHE_KINDS = ("attn", "attn_local", "attn_moe", "shared_attn", "cross",
                  "dec_cross")


# --------------------------- stack specification ----------------------------

def build_stack_spec(cfg: ArchConfig):
    """Return [(pattern: tuple[str], repeats: int), ...] for the decoder."""
    L = cfg.n_layers
    if cfg.family == "ssm" and cfg.ssm_kind == "xlstm":
        per = cfg.slstm_period
        if per and L >= per:
            pat = ("mlstm",) * (per - 1) + ("slstm",)
            segs = [(pat, L // per)]
            if L % per:
                segs.append((("mlstm",), L % per))
            return segs
        return [(("mlstm",), L)]
    if cfg.family == "hybrid":
        per = cfg.attn_period
        pat = ("mamba",) * per + ("shared_attn",)
        segs = [(pat, L // per)]
        if L % per:
            segs.append((("mamba",), L % per))
        return segs
    if cfg.family == "vlm" and cfg.cross_attn_period:
        per = cfg.cross_attn_period
        pat = ("attn",) * (per - 1) + ("cross",)
        segs = [(pat, L // per)]
        if L % per:
            segs.append((("attn",), L % per))
        return segs
    if cfg.enc_dec:
        return [(("dec_cross",), L)]
    kind = "attn_moe" if cfg.n_experts else "attn"
    if cfg.n_experts and cfg.moe_period > 1:
        pat = ("attn",) * (cfg.moe_period - 1) + ("attn_moe",)
        segs = [(pat, L // cfg.moe_period)]
        if L % cfg.moe_period:
            segs.append((("attn",), L % cfg.moe_period))
        return segs
    if cfg.local_global_period:
        pat = ("attn_local", "attn") * (cfg.local_global_period // 2)
        return [(pat, L // cfg.local_global_period)]
    return [((kind,), L)]


def layer_kinds(cfg: ArchConfig) -> list[str]:
    """The block kind of every layer, in stack order."""
    return [kind for pattern, repeats in build_stack_spec(cfg)
            for _ in range(repeats) for kind in pattern]


# ------------------------------ blocks ---------------------------------------

class Block(nn.Module):
    """One block's parameters, named as the JAX package's block dict:
    norm1 and attn / mixer, then per kind gate_attn and gate_ffn (cross,
    float32 scalars), norm_x and xattn (dec_cross), norm2 and ffn (an MLP,
    or the MoE for attn_moe). ``placeholder=True`` holds nothing: a
    ``shared_attn`` position of the stack."""

    def __init__(self, cfg: ArchConfig, kind: str, generator, device,
                 placeholder: bool = False):
        super().__init__()
        self.kind = kind
        if placeholder:
            return
        D = cfg.d_model
        norm = lambda: nn.Parameter(torch.zeros(D, dtype=cfg.pdtype,
                                                device=device))
        self.norm1 = norm()
        if kind in ATTN_KINDS:
            self.attn = init_attn(cfg, generator, device)
            self.norm2 = norm()
            self.ffn = (moe_mod.init_moe(cfg, generator, device)
                        if kind == "attn_moe" else
                        init_mlp(cfg, generator, device))
        elif kind == "cross":
            self.attn = init_attn(cfg, generator, device)
            self.gate_attn = nn.Parameter(torch.zeros((), dtype=torch.float32,
                                                      device=device))
            self.gate_ffn = nn.Parameter(torch.zeros((), dtype=torch.float32,
                                                     device=device))
            self.norm2 = norm()
            self.ffn = init_mlp(cfg, generator, device)
        elif kind == "dec_cross":
            self.attn = init_attn(cfg, generator, device)
            self.norm_x = norm()
            self.xattn = init_attn(cfg, generator, device)
            self.norm2 = norm()
            self.ffn = init_mlp(cfg, generator, device)
        elif kind == "mamba":
            self.mixer = ssm.init_mamba2(cfg, generator, device)
        elif kind == "mlstm":
            self.mixer = ssm.init_mlstm(cfg, generator, device)
        elif kind == "slstm":
            self.mixer = ssm.init_slstm(cfg, generator, device)
            self.norm2 = norm()
            self.ffn = init_mlp(cfg, generator, device, d_ff=max(4 * D // 3, 8))
        else:
            raise ValueError(kind)


def init_block(cfg: ArchConfig, kind: str, generator, device) -> Block:
    return Block(cfg, kind, generator, device)


def init_cache_for_kind(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                        device):
    """An empty cache for one block: a `KVCache` (B, max_len, Kv, hd) in the
    compute dtype for the attention kinds; the recurrent state for mamba
    ((B, H, 64, N) float32, (B, 3, conv width) compute dtype), mlstm and
    slstm (float32, m at -1e30); None for enc_attn."""
    cd = cfg.cdtype
    zeros = lambda shape, dtype=torch.float32: torch.zeros(
        shape, dtype=dtype, device=device)
    if kind in KV_CACHE_KINDS:
        shape = (batch, max_len, cfg.n_kv, cfg.head_dim)
        return KVCache(zeros(shape, cd), zeros(shape, cd), 0)
    if kind == "mamba":
        inner, N, P, H = ssm.mamba_dims(cfg)
        return (zeros((batch, H, P, N)), zeros((batch, 3, inner + 2 * N), cd))
    if kind == "mlstm":
        hd = ssm.mlstm_head_dim(cfg)
        return (zeros((batch, cfg.n_heads, hd, hd)),
                zeros((batch, cfg.n_heads, hd)),
                torch.full((batch, cfg.n_heads), -1e30, dtype=torch.float32,
                           device=device))
    if kind == "slstm":
        return ssm.slstm_init_state(batch, cfg.d_model, device)
    if kind == "enc_attn":
        return None
    raise ValueError(kind)


def apply_block(p: Block, x, cfg: ArchConfig, kind: str, *, positions,
                memory=None, memory_positions=None, cache=None,
                shared_params=None, decode: bool = False, pad=None):
    """Apply one block; returns (x, new_cache, aux), aux the MoE
    load-balance loss (0.0 for the other kinds). ``pad`` reaches only the
    cached self-attention: recurrent mixers cannot mask a left pad, so the
    serving engine serves them equal-length waves."""
    aux = 0.0
    if kind == "shared_attn":
        p = shared_params
    if kind in ATTN_KINDS:
        sw = cfg.sliding_window if kind == "attn_local" else None
        h = rms_norm(x, p.norm1, cfg.rms_eps)
        a, cache = attend(p.attn, h, cfg, positions=positions,
                          causal=kind != "enc_attn", sliding_window=sw,
                          cache=cache, pad=pad)
        x = x + a
        h = rms_norm(x, p.norm2, cfg.rms_eps)
        if kind == "attn_moe":
            f, moe_aux = moe_mod.moe_ffn(p.ffn, h, cfg)
            aux = moe_aux["lb_loss"]
        else:
            f = mlp(p.ffn, h, cfg)
        return x + f, cache, aux
    if kind == "cross":
        h = rms_norm(x, p.norm1, cfg.rms_eps)
        a, _ = attend(p.attn, h, cfg, positions=positions, kv=memory,
                      kv_positions=memory_positions, causal=False)
        x = x + torch.tanh(p.gate_attn).to(x.dtype) * a
        h = rms_norm(x, p.norm2, cfg.rms_eps)
        x = x + torch.tanh(p.gate_ffn).to(x.dtype) * mlp(p.ffn, h, cfg)
        return x, cache, aux
    if kind == "dec_cross":
        h = rms_norm(x, p.norm1, cfg.rms_eps)
        a, cache = attend(p.attn, h, cfg, positions=positions, causal=True,
                          cache=cache, pad=pad)
        x = x + a
        h = rms_norm(x, p.norm_x, cfg.rms_eps)
        a, _ = attend(p.xattn, h, cfg, positions=positions, kv=memory,
                      kv_positions=memory_positions, causal=False)
        x = x + a
        h = rms_norm(x, p.norm2, cfg.rms_eps)
        return x + mlp(p.ffn, h, cfg), cache, aux
    if kind == "mamba":
        h = rms_norm(x, p.norm1, cfg.rms_eps)
        if decode:
            state, conv_buf = cache
            y, state, conv_buf = ssm.mamba2_step(p.mixer, h, state, cfg,
                                                 conv_buf)
            return x + y, (state, conv_buf), aux
        if cache is not None:   # prefill: produce the recurrent state
            y, cache = ssm.mamba2_seq(p.mixer, h, cfg, return_state=True)
            return x + y, cache, aux
        return x + ssm.mamba2_seq(p.mixer, h, cfg), cache, aux
    if kind == "mlstm":
        h = rms_norm(x, p.norm1, cfg.rms_eps)
        if decode:
            y, cache = ssm.mlstm_step(p.mixer, h, cache, cfg)
            return x + y, cache, aux
        if cache is not None:
            y, cache = ssm.mlstm_seq(p.mixer, h, cfg, return_state=True)
            return x + y, cache, aux
        return x + ssm.mlstm_seq(p.mixer, h, cfg), cache, aux
    if kind == "slstm":
        h = rms_norm(x, p.norm1, cfg.rms_eps)
        if decode:
            y, cache = ssm.slstm_step(p.mixer, h, cache, cfg)
        elif cache is not None:
            y, cache = ssm.slstm_seq(p.mixer, h, cfg, return_state=True)
        else:
            y = ssm.slstm_seq(p.mixer, h, cfg)
        x = x + y
        h = rms_norm(x, p.norm2, cfg.rms_eps)
        return x + mlp(p.ffn, h, cfg), cache, aux
    raise ValueError(kind)


# ------------------------------- the model ----------------------------------

POS_EMBED_ROWS = 32_768       # the JAX package's learned positions (enc-dec)


class Model(nn.Module):
    """A decoder of any family, with the VLM projection or the audio
    encoder where the config has one. Parameters are drawn from a
    `torch.Generator` seeded with ``seed`` on ``device`` (None means CUDA,
    and raises where there is none; ``"meta"`` allocates nothing, for
    counting or for loading weights with ``load_state_dict(...,
    assign=True)``). The draws are not JAX's: tests carry JAX parameters
    across with `repro_torch.convert.lm_params_from_numpy`."""

    def __init__(self, cfg: ArchConfig, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        gen = None
        if device.type != "meta":
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
        self.cfg = cfg
        D = cfg.d_model
        init = lambda shape, **kw: nn.Parameter(
            dense_init(shape, cfg.pdtype, gen, device, **kw))
        self.embed = init((cfg.vocab, D), scale=0.02)
        self.final_norm = nn.Parameter(torch.zeros(D, dtype=cfg.pdtype,
                                                   device=device))
        if not cfg.tie_embeddings:
            self.lm_head = init((D, cfg.vocab))
        kinds = layer_kinds(cfg)
        self.layers = nn.ModuleList(
            Block(cfg, kind, gen, device, placeholder=kind == "shared_attn")
            for kind in kinds)
        if "shared_attn" in kinds:
            self.shared_attn = init_block(cfg, "shared_attn", gen, device)
        if cfg.family == "vlm":
            self.vision_proj = init((cfg.vision_dim, D))
        if cfg.enc_dec:
            self.encoder = ParamTree(
                stack=nn.ModuleList(init_block(cfg, "enc_attn", gen, device)
                                    for _ in range(cfg.n_enc_layers)),
                final_norm=nn.Parameter(torch.zeros(D, dtype=cfg.pdtype,
                                                    device=device)),
                frame_proj=init((cfg.vision_dim, D)))
            # sized for 32k decode positions; the real whisper caps at 448
            self.pos_embed = init((POS_EMBED_ROWS, D), scale=0.02)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _block(self, layer, x, kind, **kw):
        """`apply_block`, under `checkpoint` where autograd records, the
        config sets remat and no cache is written (the JAX package's
        condition): recomputed in the backward, under the same mesh rules
        (`sharding.bind`)."""
        block = bind(apply_block)
        if self.cfg.remat and torch.is_grad_enabled() and \
                kw.get("cache") is None and not kw.get("decode"):
            return checkpoint(block, layer, x, self.cfg, kind,
                              use_reentrant=False, preserve_rng_state=False,
                              **kw)
        return block(layer, x, self.cfg, kind, **kw)

    # ---------------- embedding / heads ----------------
    def _embed(self, tokens):
        cfg = self.cfg
        if active_mesh() is not None:
            # a vocab-sharded table is gathered from where its rows lie
            x = vocab_gather(self.embed, tokens, cfg.cdtype)
        elif torch.is_grad_enabled() and self.embed.requires_grad:
            # cast the table, then gather, as the JAX package does: the
            # gradient is then scattered in the compute dtype, as JAX's is
            x = self.embed.to(cfg.cdtype)[tokens]
        else:
            # gather, then cast: the same values, without the table's cast
            x = self.embed[tokens].to(cfg.cdtype)
        if cfg.embed_scale_sqrt_d:
            # sqrt(d_model) rounded to the compute dtype first, as in JAX
            x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=cfg.cdtype))
        return hint(x, "batch", None, None)

    def _logits(self, x):
        cfg = self.cfg
        x = rms_norm(x, self.final_norm, cfg.rms_eps)
        head = self.embed.T if cfg.tie_embeddings else self.lm_head
        logits = x @ head.to(cfg.cdtype)
        if cfg.final_softcap:
            logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
        return hint(logits, "batch", None, "vocab")

    def _run_stack(self, x, *, positions, memory=None, memory_positions=None,
                   caches=None, decode=False, pad=None):
        """Every decoder layer in order; returns (x, caches or None, aux)."""
        shared = getattr(self, "shared_attn", None)
        new_caches, aux = [], 0.0
        for i, layer in enumerate(self.layers):
            if self.cfg.seq_parallel_residual and not decode:
                # Megatron-style sequence parallelism: the block-boundary
                # residual (what remat saves) is sharded seq-over-TP
                x = hint(x, "batch", "seq_mp", None)
            x, c, a = self._block(
                layer, x, layer.kind, positions=positions,
                memory=memory, memory_positions=memory_positions,
                cache=None if caches is None else caches[i],
                shared_params=shared, decode=decode, pad=pad)
            new_caches.append(c)
            aux = aux + a
        if not torch.is_tensor(aux):
            aux = replicate(torch.zeros((), dtype=torch.float32,
                                        device=x.device))
        return x, (new_caches if caches is not None else None), aux

    def _positions(self, B, S, device):
        return replicate(torch.arange(S, device=device)[None, :].expand(B, S))

    def _encode_memory(self, batch):
        """(memory (B, M, D), memory positions (M,)) of the VLM projection
        (``batch["patch_embeds"]``, the stub vision tower's output) or the
        audio encoder (``batch["frames"]``); (None, None) otherwise."""
        cfg = self.cfg
        cd = cfg.cdtype
        if cfg.family == "vlm":
            mem = batch["patch_embeds"].to(cd) @ self.vision_proj.to(cd)
            return mem, replicate(torch.arange(mem.shape[1], device=mem.device))
        if cfg.enc_dec:
            enc = self.encoder
            mem = batch["frames"].to(cd) @ enc.frame_proj.to(cd)
            pos = replicate(torch.arange(mem.shape[1], device=mem.device))
            for layer in enc.stack:
                mem, _, _ = self._block(layer, mem, "enc_attn", positions=pos)
            return rms_norm(mem, enc.final_norm, cfg.rms_eps), pos
        return None, None

    def _with_positions(self, x, start: int):
        """Enc-dec: add the learned positions start .. start + S - 1."""
        if self.cfg.enc_dec:
            S = x.shape[1]
            x = x + self.pos_embed[start:start + S].to(x.dtype)[None]
        return x

    # ---------------- public entry points ----------------
    def forward(self, batch):
        """Teacher-forced forward: batch = {"tokens": (B, S)} and, for the
        VLM / audio families, "patch_embeds" / "frames". Returns (logits
        (B, S, V) in the compute dtype, aux: the summed MoE load-balance
        loss, a float32 scalar)."""
        return bind(self._forward)(batch)

    def _forward(self, batch):
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self._with_positions(self._embed(tokens), 0)
        memory, mem_pos = self._encode_memory(batch)
        x, _, aux = self._run_stack(x, positions=self._positions(B, S, x.device),
                                    memory=memory, memory_positions=mem_pos)
        return self._logits(x), aux

    def init_cache(self, batch_size: int, max_len: int) -> list:
        """One empty cache per decoder layer, in stack order."""
        return [init_cache_for_kind(self.cfg, layer.kind, batch_size, max_len,
                                    self.device) for layer in self.layers]

    def prefill(self, batch, caches, pad=None):
        """Fill the caches with the prompt (and encode the memory of the
        VLM / audio families from ``batch``); returns (logits of the last
        position (B, 1, V), caches). ``pad`` ((B,) left-pad lengths) serves
        a ragged wave: row b's logical positions run -pad[b] .. S-1-pad[b]
        and its pad slots are masked downstream."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self._with_positions(self._embed(tokens), 0)
        memory, mem_pos = self._encode_memory(batch)
        positions = self._positions(B, S, x.device)
        if pad is not None:
            positions = positions - pad[:, None]
        x, caches, _ = self._run_stack(x, positions=positions, memory=memory,
                                       memory_positions=mem_pos,
                                       caches=caches, pad=pad)
        return self._logits(x[:, -1:, :]), caches

    def decode_step(self, token, pos: int, caches, memory=None, mem_pos=None,
                    pad=None):
        """token (B, 1); ``pos`` the current buffer position (cache slot),
        a Python int; ``memory`` / ``mem_pos`` from `_encode_memory` for
        the VLM / audio families. With ``pad``, row b's logical position is
        pos - pad[b]. Returns (logits (B, 1, V), caches)."""
        B = token.shape[0]
        x = self._with_positions(self._embed(token), pos)
        positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
        if pad is not None:
            positions = positions - pad[:, None]
        x, caches, _ = self._run_stack(x, positions=positions, memory=memory,
                                       memory_positions=mem_pos,
                                       caches=caches, decode=True, pad=pad)
        return self._logits(x), caches
