"""zamba2-7b [hybrid] — Mamba2 + shared attn blocks [arXiv:2411.15242;
unverified].

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
Backbone: Mamba2 blocks; ONE weight-shared attention+MLP block invoked every
6 mamba layers (13 invocations + 3 trailing mamba layers). The real model
adds per-invocation LoRA deltas on the shared block; we share weights
exactly and note the simplification in DESIGN.md.
"""
from repro_torch.configs import shrink
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv=32, d_ff=14336, vocab=32000,
    ssm_kind="mamba2", ssm_state=64, ssm_expand=2, attn_period=6,
)

SMOKE = shrink(CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv=4, d_ff=128,
               vocab=512, ssm_state=16, attn_period=3)
