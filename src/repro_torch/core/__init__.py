"""BCPNN core of the port: parameters, traces, threefry RNG, HCU state, the
plane layouts (flat and column-blocked), the worklist, the network queues
and drivers (the chunked `network_run` is a CUDA-graph replay a chunk on
the card), the eager reference and the tick engine.

Exports every name of the JAX package's `repro.core`, in its order: the
session lanes of the recall server (`stack_sessions`, `write_sessions`,
`take_session`) and the Fig 7 queue math (`queues`) included."""
from repro_torch.core.params import BCPNNParams, human_scale, rodent_scale, test_scale
from repro_torch.core.hcu import (HCUState, init_hcu_state, init_hcu_batch,
                                  hcu_tick_pre, column_update, row_updates,
                                  periodic_update, flush, dedup_rows)
from repro_torch.core.network import (NetworkState, Connectivity, init_network,
                                      make_connectivity, network_tick,
                                      network_run, stage_external, run,
                                      enqueue_spikes, hcu_view, select_fired,
                                      stack_sessions, write_sessions,
                                      take_session)
from repro_torch.core.layout import (RowMergeLayout, FlatLayout, BlockedLayout,
                                     batched_state, flat_state)
from repro_torch.core.engine import (Simulator, TickBackend, DenseBackend,
                                     WorklistBackend, select_backend, tick,
                                     column_updates_batched)
from repro_torch.core import traces, queues, worklist

__all__ = [
    "BCPNNParams", "human_scale", "rodent_scale", "test_scale",
    "Simulator", "TickBackend", "DenseBackend", "WorklistBackend",
    "select_backend",
    "HCUState", "init_hcu_state", "init_hcu_batch", "hcu_tick_pre",
    "column_update", "row_updates", "periodic_update", "flush", "dedup_rows",
    "NetworkState", "Connectivity", "init_network", "make_connectivity",
    "network_tick", "network_run", "stage_external", "run",
    "enqueue_spikes", "hcu_view", "select_fired", "column_updates_batched",
    "stack_sessions", "write_sessions", "take_session",
    "RowMergeLayout", "FlatLayout", "BlockedLayout", "batched_state",
    "flat_state", "traces", "queues", "worklist",
]
