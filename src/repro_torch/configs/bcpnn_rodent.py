"""Rodent-scale BCPNN (paper §VII.C): 32K HCUs, R=1200, C=70.

At the port's 20 bytes a cell an HCU's ij planes take 1200 * 70 * 20 B =
1.68 MB, and the whole network's 53.76 GB (plus 2.69 GB of connectivity
and 0.61 GB of i-vectors): the paper's demonstrated network fits one 80
GB H100 whole, and `chip_smoke.py` runs it there. The dry-run config
(`launch.dryrun.lower_bcpnn`) shards 32,768 HCUs (a power of two, for even
sharding) over 256 ranks: 128 HCUs, 0.23 GB, a rank.
"""
from repro_torch.core.params import rodent_scale

CONFIG = rodent_scale()
DRYRUN_N_HCU = 32_768                     # pow2 for even sharding (paper: 32K)
SMOKE = rodent_scale(n_hcu=2)
