"""Architecture config schema and parameter init helpers (the port of
`repro.models.base`).

`ArchConfig` keeps every field of the JAX package's, so the config modules
carry over as data, and adds ``embed_scale_sqrt_d``, which the JAX package
derives from the arch's name; `cdtype` / `pdtype` return torch dtypes. Parameters
are float32 (``param_dtype``) and are cast to ``compute_dtype`` at every
matmul, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int

    # attention details
    head_dim: Optional[int] = None          # default d_model // n_heads
    qkv_bias: bool = False                  # qwen2
    rope_theta: float = 10_000.0
    rotary_pct: float = 1.0                 # stablelm partial rotary
    attn_softcap: Optional[float] = None    # gemma2 50.0
    final_softcap: Optional[float] = None   # gemma2 30.0
    sliding_window: Optional[int] = None    # gemma2 local layers
    local_global_period: int = 0            # gemma2: 2 => alternate local/global
    query_scale: Optional[float] = None
    tie_embeddings: bool = False
    act: str = "silu"                       # silu | gelu
    embed_scale_sqrt_d: bool = False        # gemma: embedding x sqrt(d_model)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    n_shared_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_period: int = 1                     # every k-th layer is MoE

    # SSM / hybrid
    ssm_kind: str = ""                      # mamba2 | xlstm
    ssm_state: int = 64
    ssm_heads: int = 0
    ssm_expand: int = 2
    slstm_period: int = 0                   # xlstm: every k-th block is sLSTM
    attn_period: int = 0                    # zamba2: shared attn every k ssm layers

    # VLM
    cross_attn_period: int = 0              # llama3.2-vision: every 5th layer
    n_patches: int = 1601                   # stub vision tokens
    vision_dim: int = 1280                  # stub patch embedding dim

    # audio (enc-dec)
    enc_dec: bool = False
    n_enc_layers: int = 0
    n_enc_frames: int = 1500                # stub conv-frontend output length

    # numerics
    rms_eps: float = 1e-6
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # substrate behaviour: remat recomputes each block in the backward
    # (`Model._block`); seq_parallel_residual and moe_shard_cap lay out
    # activations under a mesh (`models.sharding`); scan_layers is kept as
    # data (the port has no scan)
    remat: bool = True
    scan_layers: bool = True
    attn_impl: str = "dense"                # dense | chunked | pallas_flash
    attn_chunk: int = 1024                  # KV chunk of the chunked path
    seq_parallel_residual: bool = False
    moe_shard_cap: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv, 1) != 0:
            raise ValueError("GQA group mismatch: n_heads % n_kv != 0")

    @property
    def cdtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    @property
    def pdtype(self) -> torch.dtype:
        return torch.float32 if self.param_dtype == "float32" else torch.bfloat16

    def param_count(self) -> int:
        """Exact parameter count: the sum of ``numel`` over a model built
        on the ``meta`` device (no allocation)."""
        from repro_torch.models.transformer import Model  # lazy: no cycle
        return sum(p.numel() for p in Model(self, device="meta").parameters())

    def _param_count_analytic(self) -> int:
        D, H, Kv, hd = self.d_model, self.n_heads, self.n_kv, self.head_dim
        attn = D * H * hd + 2 * D * Kv * hd + H * hd * D
        if self.family in ("ssm", "hybrid") and self.ssm_kind:
            inner = self.ssm_expand * D
            mixer = D * inner * 2 + inner * D + inner * (2 * self.ssm_state)
        else:
            mixer = attn
        if self.n_experts:
            ff_moe = 3 * D * self.expert_d_ff * self.n_experts \
                + D * self.n_experts \
                + 3 * D * self.expert_d_ff * self.n_shared_experts
            n_moe = self.n_layers // self.moe_period
            n_dense = self.n_layers - n_moe
            ff_total = n_moe * ff_moe + n_dense * 3 * D * self.d_ff
            ff = ff_total / max(self.n_layers, 1)
        else:
            ff = 3 * D * self.d_ff
        per_layer = mixer + ff + 2 * D
        n_dec = self.n_layers
        total = n_dec * per_layer \
            + self.vocab * D * (1 if self.tie_embeddings else 2)
        if self.enc_dec:
            # encoder layers + decoder cross-attention
            total += self.n_enc_layers * (attn + 3 * D * self.d_ff + 2 * D)
            total += n_dec * (attn + D)
        if self.cross_attn_period:
            n_x = self.n_layers // self.cross_attn_period
            total += n_x * (attn + 3 * D * self.d_ff + 2 * D)
        return int(total)

    def active_param_count(self) -> int:
        """Parameters active per token (MoE: only top_k + shared experts)."""
        if not self.n_experts:
            return self.param_count()
        inactive = (self.n_experts - self.top_k) * 3 * self.d_model \
            * self.expert_d_ff
        return int(self.param_count()
                   - self.n_layers // self.moe_period * inactive)


def dense_init(shape, dtype, generator: torch.Generator, device,
               scale: float | None = None) -> torch.Tensor:
    """Normal(0, 1) * scale (default fan_in ** -0.5), drawn in float32 from
    ``generator``. On the ``meta`` device nothing is drawn."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else fan_in ** -0.5
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * scale).to(dtype)


class ParamTree(nn.Module):
    """Named parameters and sub-trees of one block part, read like the JAX
    package's parameter dicts (``p["router"]``, ``p["shared"]["wi"]``), so
    the layer functions take either this or a plain dict of tensors."""

    def __init__(self, **items):
        super().__init__()
        for name, value in items.items():
            setattr(self, name, value)

    def __getitem__(self, name):
        if name in self._parameters or name in self._modules:
            return getattr(self, name)
        raise KeyError(name)

    def __contains__(self, name) -> bool:
        return name in self._parameters or name in self._modules
