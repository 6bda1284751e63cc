"""Model assembly (the port of `repro.models.transformer`) for the dense
family: the blocks ``attn`` (self-attention + gated MLP) and
``attn_local`` (the same with a sliding window, gemma2's odd layers).

`build_stack_spec` is the JAX package's, for every kind. The model's
layers are an `nn.ModuleList` in stack order (segment, then repeat, then
pattern position), where the JAX package stacks each pattern position's
parameters along the repeats and scans them; serving needs neither scan
nor remat. The other kinds (``attn_moe``, ``mamba``, ``mlstm``,
``slstm``, ``shared_attn``, ``cross``, ``enc_attn``, ``dec_cross``) raise
`NotImplementedError`: ROADMAP queue A item 8 ports them.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.device import resolve_device
from repro_torch.models.base import ArchConfig, dense_init
from repro_torch.models.layers import (KVCache, attend, init_attn, init_mlp,
                                       mlp, rms_norm)

PORTED_KINDS = ("attn", "attn_local")


def _unported(what: str):
    return NotImplementedError(
        f"{what}: not ported to PyTorch yet (ROADMAP queue A item 8: "
        "MoE, SSM / hybrid, VLM and audio blocks)")


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
    """One ``attn`` / ``attn_local`` block: norm1, attn, norm2, ffn."""

    def __init__(self, cfg: ArchConfig, kind: str, generator, device):
        super().__init__()
        if kind not in PORTED_KINDS:
            raise _unported(f"the {kind!r} block")
        self.kind = kind
        D = cfg.d_model
        self.norm1 = nn.Parameter(torch.zeros(D, dtype=cfg.pdtype, device=device))
        self.attn = init_attn(cfg, generator, device)
        self.norm2 = nn.Parameter(torch.zeros(D, dtype=cfg.pdtype, device=device))
        self.ffn = init_mlp(cfg, generator, device)


def init_block(cfg: ArchConfig, kind: str, generator, device) -> Block:
    return Block(cfg, kind, generator, device)


def init_cache_for_kind(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                        device) -> KVCache:
    if kind not in PORTED_KINDS:
        raise _unported(f"the {kind!r} cache")
    shape = (batch, max_len, cfg.n_kv, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=cfg.cdtype, device=device),
                   torch.zeros(shape, dtype=cfg.cdtype, device=device), 0)


def apply_block(p: Block, x, cfg: ArchConfig, kind: str, *, positions,
                cache=None, pad=None):
    """Apply one block; returns (x, new_cache). (The JAX package also
    returns the MoE auxiliary loss, which these blocks do not have.)"""
    if kind not in PORTED_KINDS:
        raise _unported(f"the {kind!r} block")
    sw = cfg.sliding_window if kind == "attn_local" else None
    h = rms_norm(x, p.norm1, cfg.rms_eps)
    a, cache = attend(p.attn, h, cfg, positions=positions, sliding_window=sw,
                      cache=cache, pad=pad)
    x = x + a
    h = rms_norm(x, p.norm2, cfg.rms_eps)
    return x + mlp(p.ffn, h, cfg), cache


# ------------------------------- the model ----------------------------------

class Model(nn.Module):
    """A dense-family decoder. Parameters are drawn from a `torch.Generator`
    seeded with ``seed`` on ``device`` (None means CUDA, and raises where
    there is none; ``"meta"`` allocates nothing, for counting or for
    loading weights with ``load_state_dict(..., assign=True)``). The draws
    are not JAX's: tests carry JAX parameters across with
    `repro_torch.convert.lm_params_from_numpy`."""

    def __init__(self, cfg: ArchConfig, device=None, seed: int = 0):
        super().__init__()
        unported = sorted(set(layer_kinds(cfg)) - set(PORTED_KINDS))
        if unported:
            raise _unported(f"the {cfg.family} family's {unported} blocks")
        device = resolve_device(device)
        gen = None
        if device.type != "meta":
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
        self.cfg = cfg
        D = cfg.d_model
        self.embed = nn.Parameter(dense_init((cfg.vocab, D), cfg.pdtype, gen,
                                             device, scale=0.02))
        self.final_norm = nn.Parameter(torch.zeros(D, dtype=cfg.pdtype,
                                                   device=device))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(dense_init((D, cfg.vocab), cfg.pdtype,
                                                   gen, device))
        self.layers = nn.ModuleList(init_block(cfg, kind, gen, device)
                                    for kind in layer_kinds(cfg))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ---------------- embedding / heads ----------------
    def _embed(self, tokens):
        cfg = self.cfg
        # gather, then cast: the same values as casting the whole table first
        x = self.embed[tokens].to(cfg.cdtype)
        if cfg.embed_scale_sqrt_d:
            # sqrt(d_model) rounded to the compute dtype first, as in JAX
            x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=cfg.cdtype))
        return x

    def _logits(self, x):
        cfg = self.cfg
        x = rms_norm(x, self.final_norm, cfg.rms_eps)
        head = self.embed.T if cfg.tie_embeddings else self.lm_head
        logits = x @ head.to(cfg.cdtype)
        if cfg.final_softcap:
            logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
        return logits

    def _run_stack(self, x, *, positions, caches=None, pad=None):
        new_caches = []
        for i, layer in enumerate(self.layers):
            x, c = apply_block(layer, x, self.cfg, layer.kind,
                               positions=positions,
                               cache=None if caches is None else caches[i],
                               pad=pad)
            new_caches.append(c)
        return x, (new_caches if caches is not None else None)

    def _positions(self, B, S, device):
        return torch.arange(S, device=device)[None, :].expand(B, S)

    # ---------------- public entry points ----------------
    def forward(self, batch):
        """Teacher-forced forward: batch = {"tokens": (B, S)}; returns the
        logits (B, S, V) in the compute dtype."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self._embed(tokens)
        x, _ = self._run_stack(x, positions=self._positions(B, S, x.device))
        return self._logits(x)

    def init_cache(self, batch_size: int, max_len: int) -> list[KVCache]:
        """One empty KV cache per layer, in stack order."""
        return [init_cache_for_kind(self.cfg, layer.kind, batch_size, max_len,
                                    self.device) for layer in self.layers]

    def prefill(self, batch, caches, pad=None):
        """Fill the caches with the prompt; returns (logits of the last
        position (B, 1, V), caches). ``pad`` ((B,) left-pad lengths) serves
        a ragged wave: row b's logical positions run -pad[b] .. S-1-pad[b]
        and its pad slots are masked downstream."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self._embed(tokens)
        positions = self._positions(B, S, x.device)
        if pad is not None:
            positions = positions - pad[:, None]
        x, caches = self._run_stack(x, positions=positions, caches=caches,
                                    pad=pad)
        return self._logits(x[:, -1:, :]), caches

    def decode_step(self, token, pos: int, caches, pad=None):
        """token (B, 1); ``pos`` the current buffer position (cache slot),
        a Python int. With ``pad``, row b's logical position is
        pos - pad[b]. Returns (logits (B, 1, V), caches)."""
        B = token.shape[0]
        x = self._embed(token)
        positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
        if pad is not None:
            positions = positions - pad[:, None]
        x, caches = self._run_stack(x, positions=positions, caches=caches,
                                    pad=pad)
        return self._logits(x), caches
