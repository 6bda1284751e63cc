"""whisper-large-v3 [audio] — enc-dec, conv frontend (stub)
[arXiv:2212.04356; unverified].

32L d_model=1280 20H (kv=20) d_ff=5120 vocab=51866. Encoder-decoder: 32
bidirectional encoder layers over stub conv-frontend frame embeddings
(B, 1500, 1280) + 32 decoder layers with cross-attention. Decoder uses
learned positions. The real model caps decoding at 448 positions; the
assigned 32k decode cells exercise the backbone beyond that cap (noted in
DESIGN.md).
"""
from repro_torch.configs import shrink
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="whisper-large-v3", family="audio", n_layers=32, d_model=1280,
    n_heads=20, n_kv=20, d_ff=5120, vocab=51866,
    enc_dec=True, n_enc_layers=32, n_enc_frames=1500, vision_dim=1280,
    rotary_pct=0.0,   # whisper uses absolute positions, not RoPE
)

SMOKE = shrink(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128,
               vocab=512, n_enc_layers=2, n_enc_frames=16, vision_dim=64)
