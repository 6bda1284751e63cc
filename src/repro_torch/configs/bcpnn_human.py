"""Human-scale BCPNN (paper §II.A): 2M HCUs, R=10000, C=100.

The port stores 20 bytes a cell (Zij, Eij, Pij, Wij as float32, Tij as
int32), so an HCU's ij planes take 10000 * 100 * 20 B = 20 MB (its
i-vectors 0.16 MB more). One 80 GB H100 holds about 4,000 such HCUs of
state, before the connectivity and the tick's temporaries: 256 HCUs (5.1
GB) is the cut `chip_smoke.py` runs. The full 2M-HCU network needs 40 TB
of planes, about 500 such cards, and is reported analytically. The
dry-run config (`launch.dryrun.lower_bcpnn`) shards 65,536 HCUs over 256
ranks: 256 HCUs, 5.2 GB, a rank.
"""
from repro_torch.core.params import human_scale

CONFIG = human_scale()                    # full 2M-HCU spec (analytic)
DRYRUN_N_HCU = 65_536
SMOKE = human_scale(n_hcu=2)
