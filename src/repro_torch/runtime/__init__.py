"""Runtime services of the port: crash recovery with bitwise replay,
DRAM-retention fault injection and drop-budget health accounting
(`resilience`), over the host-side restart and straggler machinery
(`elastic`). Exports the JAX package's `repro.runtime` names; the sharded
ones (`ElasticRunner`, `remesh`, `remesh_network`) raise until the sharded
runtime is ported (ROADMAP queue A item 7)."""
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
