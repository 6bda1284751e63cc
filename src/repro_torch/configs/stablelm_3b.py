"""stablelm-3b [dense] — [hf:stabilityai/stablelm-2-1_6b; unverified].

32L d_model=2560 32H (GQA kv=32 == MHA) d_ff=6912 vocab=50304.
StableLM-2 family uses partial rotary (25%).
"""
from repro_torch.configs import shrink
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="stablelm-3b", family="dense", n_layers=32, d_model=2560,
    n_heads=32, n_kv=32, d_ff=6912, vocab=50304, rotary_pct=0.25,
)

SMOKE = shrink(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128,
               vocab=512)
