"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].

94L d_model=4096 64H (GQA kv=4) d_ff=1536 (per expert) vocab=151936,
MoE 128e top-8, head_dim=128, every layer MoE.
"""
from repro_torch.configs import shrink
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen3-moe-235b-a22b", family="moe", n_layers=94, d_model=4096,
    n_heads=64, n_kv=4, d_ff=1536, vocab=151936, head_dim=128,
    n_experts=128, top_k=8, expert_d_ff=1536, moe_period=1,
    rope_theta=1_000_000.0,
)

SMOKE = shrink(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2,
               head_dim=16, d_ff=32, expert_d_ff=32, n_experts=8, top_k=2,
               vocab=512)
