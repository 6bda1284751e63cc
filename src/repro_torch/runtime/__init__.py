"""Runtime services of the port: crash recovery with bitwise replay,
DRAM-retention fault injection and drop-budget health accounting
(`resilience`), over the host-side restart and straggler machinery
(`elastic`), and the sharded `ElasticRunner` that survives the loss of
ranks by re-placing whole HCUs (`remesh`, `remesh_network`). Exports the
JAX package's `repro.runtime` names."""
from repro_torch.runtime.elastic import (DeviceLoss, InjectedFailure,
                                         RestartableLoop,
                                         RestartBudgetExceeded,
                                         StragglerMonitor, remesh,
                                         remesh_network)
from repro_torch.runtime.resilience import (ElasticRunner, HealthMonitor,
                                            ResilientRunner,
                                            ServingHealthMonitor, flip_bits,
                                            inject_retention_faults)

__all__ = [
    "DeviceLoss", "ElasticRunner", "HealthMonitor", "InjectedFailure",
    "ResilientRunner", "RestartableLoop", "RestartBudgetExceeded",
    "ServingHealthMonitor",
    "StragglerMonitor", "flip_bits", "inject_retention_faults", "remesh",
    "remesh_network",
]
