"""BCPNN core of the port: parameters, traces, threefry RNG, HCU state, the
plane layouts (flat and column-blocked), the worklist, the network queues,
the eager reference and the tick engine."""
from repro_torch.core.params import BCPNNParams, human_scale, rodent_scale, test_scale
from repro_torch.core.engine import (DenseBackend, Simulator, WorklistBackend,
                                     select_backend, tick)
from repro_torch.core.network import (Connectivity, NetworkState, init_network,
                                      make_connectivity, network_run,
                                      network_tick, run, stage_external)
