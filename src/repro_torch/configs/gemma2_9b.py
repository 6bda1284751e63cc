"""gemma2-9b [dense] — local+global alternating, logit softcap
[arXiv:2408.00118; hf].

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000. head_dim=256,
sliding window 4096 on odd (local) layers, attn softcap 50, final softcap 30,
GeGLU, tied embeddings, query scale 1/sqrt(256).
"""
from repro_torch.configs import shrink
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="gemma2-9b", family="dense", n_layers=42, d_model=3584,
    n_heads=16, n_kv=8, d_ff=14336, vocab=256000, head_dim=256,
    local_global_period=2, sliding_window=4096,
    attn_softcap=50.0, final_softcap=30.0, act="gelu",
    tie_embeddings=True, rope_theta=10_000.0, embed_scale_sqrt_d=True,
)

SMOKE = shrink(CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv=2,
               head_dim=16, d_ff=128, vocab=512, sliding_window=8)
