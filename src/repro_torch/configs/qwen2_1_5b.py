"""qwen2-1.5b [dense] — GQA, QKV bias [arXiv:2407.10671; hf].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
"""
from repro_torch.configs import shrink
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen2-1.5b", family="dense", n_layers=28, d_model=1536,
    n_heads=12, n_kv=2, d_ff=8960, vocab=151936, qkv_bias=True,
    rope_theta=1_000_000.0, tie_embeddings=True,
)

SMOKE = shrink(CONFIG, n_layers=2, d_model=48, n_heads=4, n_kv=2, d_ff=96,
               vocab=512)
