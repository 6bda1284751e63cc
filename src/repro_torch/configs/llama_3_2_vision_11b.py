"""llama-3.2-vision-11b [vlm] — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; every 5th layer is
a gated cross-attention layer over vision patch embeddings. The vision tower
is a STUB: input_specs() provides precomputed patch embeddings
(B, 1601, 1280) projected into d_model.
"""
from repro_torch.configs import shrink
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="llama-3.2-vision-11b", family="vlm", n_layers=40, d_model=4096,
    n_heads=32, n_kv=8, d_ff=14336, vocab=128256, head_dim=128,
    cross_attn_period=5, n_patches=1601, vision_dim=1280,
    rope_theta=500_000.0,
)

SMOKE = shrink(CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv=2,
               head_dim=16, d_ff=128, vocab=512, n_patches=16, vision_dim=32)
