"""BCPNN core of the port: parameters, traces, threefry RNG, HCU state, the
plane layouts (flat and column-blocked), the worklist, the network queues
and drivers (the chunked `network_run` is a CUDA-graph replay a chunk on
the card), the eager reference and the tick engine.

Exports every name of the JAX package's `repro.core` that the port has;
`queues`, `stack_sessions`, `write_sessions` and `take_session` are not
ported yet (ROADMAP queue A items 5 and 6)."""
from repro_torch.core.params import BCPNNParams, human_scale, rodent_scale, test_scale
from repro_torch.core.hcu import (HCUState, init_hcu_state, init_hcu_batch,
                                  hcu_tick_pre, column_update, row_updates,
                                  periodic_update, flush, dedup_rows)
from repro_torch.core.network import (NetworkState, Connectivity, init_network,
                                      make_connectivity, network_tick,
                                      network_run, stage_external, run,
                                      enqueue_spikes, hcu_view, select_fired)
from repro_torch.core.layout import (RowMergeLayout, FlatLayout, BlockedLayout,
                                     batched_state, flat_state)
from repro_torch.core.engine import (Simulator, TickBackend, DenseBackend,
                                     WorklistBackend, select_backend, tick,
                                     column_updates_batched)
from repro_torch.core import traces, worklist

__all__ = [
    "BCPNNParams", "human_scale", "rodent_scale", "test_scale",
    "Simulator", "TickBackend", "DenseBackend", "WorklistBackend",
    "select_backend",
    "HCUState", "init_hcu_state", "init_hcu_batch", "hcu_tick_pre",
    "column_update", "row_updates", "periodic_update", "flush", "dedup_rows",
    "NetworkState", "Connectivity", "init_network", "make_connectivity",
    "network_tick", "network_run", "stage_external", "run",
    "enqueue_spikes", "hcu_view", "select_fired", "column_updates_batched",
    "RowMergeLayout", "FlatLayout", "BlockedLayout", "batched_state",
    "flat_state", "traces", "worklist",
]
