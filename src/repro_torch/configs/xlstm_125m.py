"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

12L d_model=768 4H (GQA kv=4) d_ff=0 vocab=50304. xLSTM[7:1]: every 8th
block is sLSTM, the rest mLSTM (d_ff=0: blocks carry their own projections —
mLSTM pre-up-projection x2, sLSTM post-FFN 4/3).
"""
from repro_torch.configs import shrink
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="xlstm-125m", family="ssm", n_layers=12, d_model=768,
    n_heads=4, n_kv=4, d_ff=0, vocab=50304,
    ssm_kind="xlstm", ssm_expand=2, slstm_period=8,
)

SMOKE = shrink(CONFIG, n_layers=9, d_model=64, n_heads=4, n_kv=4, vocab=512)
