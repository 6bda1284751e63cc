"""internlm2-1.8b [dense] — GQA [arXiv:2403.17297; hf].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
"""
from repro_torch.configs import shrink
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="internlm2-1.8b", family="dense", n_layers=24, d_model=2048,
    n_heads=16, n_kv=8, d_ff=8192, vocab=92544, rope_theta=1_000_000.0,
)

SMOKE = shrink(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
               vocab=512)
