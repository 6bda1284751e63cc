"""BCPNN model parameters and scale presets (the port's own copy of
`repro.core.params`, which the port may not import).

Scales follow the paper (§II.A for human scale, §VII.C for rodent scale):
  human : 2M HCUs, R=10000 synaptic rows, C=100 MCUs/HCU
  rodent: 32K HCUs, R=1200,  C=70
Trace time constants follow the standard spiking BCPNN literature
(Tully, Hennig & Lansner 2014): tau_z ~ 5 ms, tau_e ~ 100 ms, tau_p ~ 1000 ms.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BCPNNParams:
    # --- network dimensions -------------------------------------------------
    n_hcu: int = 16          # total HCUs in the network
    rows: int = 10_000       # R: synaptic inputs per HCU (i index)
    cols: int = 100          # C: MCUs per HCU (j index)
    fanout: int = 100        # output spike fanout (target HCUs per spike)

    # --- trace time constants (ms) -----------------------------------------
    tau_zi: float = 5.0
    tau_zj: float = 5.0
    tau_e: float = 100.0
    tau_p: float = 1000.0
    tau_m: float = 10.0      # support/membrane integration constant

    # --- rates & dimensioning (paper §II.A, §IV) ----------------------------
    dt_ms: float = 1.0            # simulation tick
    in_rate: float = 10.0         # mean input spikes / ms / HCU (Poisson lambda)
    out_rate: float = 0.1         # mean output spikes / ms / HCU (100 /s)
    active_queue: int = 36        # worst-case spikes/ms (Fig 7 dimensioning)
    max_delay: int = 16           # delay-queue horizon (ms); mean biological delay 4 ms
    mean_delay: float = 4.0

    # --- numerics ------------------------------------------------------------
    eps: float = 1e-4        # probability floor for log()
    p_init: float = 0.01     # initial P-trace background activity
    wta_temp: float = 1.0    # soft-WTA softmax temperature

    def __post_init__(self):
        # closed-form decay requires distinct time constants
        tz = self.tau_z_ij
        if not (abs(tz - self.tau_e) > 1e-6 and abs(self.tau_e - self.tau_p) > 1e-6
                and abs(tz - self.tau_p) > 1e-6):
            raise ValueError("tau_z', tau_e, tau_p must be distinct")

    @property
    def tau_z_ij(self) -> float:
        """Effective time constant of the Zij = Zi*Zj product trace."""
        return (self.tau_zi * self.tau_zj) / (self.tau_zi + self.tau_zj)

    # --- derived requirement numbers (paper Table 1) -------------------------
    @property
    def cell_bytes(self) -> int:
        return 6 * 4  # 192-bit cell: Zij,Eij,Pij,Wij,Tij,(pad) as f32

    @property
    def hcu_storage_bytes(self) -> int:
        return self.rows * self.cols * self.cell_bytes

    @property
    def network_storage_bytes(self) -> int:
        return self.n_hcu * self.hcu_storage_bytes


def human_scale(n_hcu: int = 2_000_000) -> BCPNNParams:
    return BCPNNParams(n_hcu=n_hcu, rows=10_000, cols=100, fanout=100)


def rodent_scale(n_hcu: int = 32_000) -> BCPNNParams:
    return BCPNNParams(n_hcu=n_hcu, rows=1200, cols=70, fanout=100)


def test_scale(n_hcu: int = 4, rows: int = 64, cols: int = 16) -> BCPNNParams:
    """Tiny preset for unit tests and CPU smoke runs."""
    return BCPNNParams(n_hcu=n_hcu, rows=rows, cols=cols, fanout=min(8, n_hcu),
                       active_queue=8, max_delay=8)
