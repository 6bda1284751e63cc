"""llama4-maverick-400b-a17b [moe] — MoE top-1 + shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1,
interleaved dense/MoE layers (moe_period=2), one shared expert.
Early fusion: multimodal tokens share the decoder (text-only here; the
modality frontend is out of the assigned backbone scope).
"""
from repro_torch.configs import shrink
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="llama4-maverick-400b-a17b", family="moe", n_layers=48,
    d_model=5120, n_heads=40, n_kv=8, d_ff=8192, vocab=202048, head_dim=128,
    n_experts=128, top_k=1, expert_d_ff=8192, n_shared_experts=1,
    moe_period=2, rope_theta=500_000.0,
)

SMOKE = shrink(CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv=2,
               head_dim=16, d_ff=64, expert_d_ff=64, n_experts=8, top_k=1,
               vocab=512)
