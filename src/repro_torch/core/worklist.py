"""The network-global worklist of touched plane rows (the port of
`repro.core.worklist`'s `build_worklist` and `compact_mask`).

The paper's lazy model keeps per-tick synaptic traffic proportional to
spikes, not synapses (§VI.D). Each tick the deduplicated per-HCU row slots
become one worklist of global flat row indices, and the row kernel
(`repro_torch.kernels.ops.fused_row_update`) rewrites exactly those rows of
the flat planes in place. The JAX package's while-loop staging and
writeback primitives exist only for XLA's buffer aliasing and have no
counterpart here.
"""
from __future__ import annotations

import torch

from repro_torch.core.layout import global_row


def build_worklist(rows_u: torch.Tensor, n_rows: int):
    """Build the network-global worklist from per-HCU deduped row slots.

    rows_u: (H, A) per-HCU deduplicated row indices (padding == n_rows).
    Returns (g_row, order, nv):
      g_row (H*A,) int32 — global flat row index h*R + r per slot, h-major
                           slot order; padding slots == H*R (sentinel);
      order (H*A,) int32 — stable compaction permutation, valid slots first;
      nv    ()     int32 — number of valid entries.

    Rows are unique network-wide: `dedup_rows` dedups within each HCU and
    rows of different HCUs map to disjoint global indices.
    """
    n_hcu, A = rows_u.shape
    valid = rows_u < n_rows
    h = torch.arange(n_hcu, dtype=torch.int32, device=rows_u.device)[:, None]
    g = torch.where(valid, global_row(h, rows_u, n_rows), n_hcu * n_rows)
    order, nv = compact_mask(valid.reshape(-1))
    return g.reshape(-1).to(torch.int32), order, nv


def compact_mask(mask: torch.Tensor):
    """Stable valid-first compaction of a boolean mask without a sort.

    Returns (order, count): order (N,) int32 with order[e] = index of the
    (e+1)-th True entry for e < count (positions past count hold 0). True
    entry i lands at position cumsum(mask)[i] - 1; the False entries'
    writes go to a spare slot past the end, which is cut off (the JAX
    package's out-of-range `mode="drop"`).
    """
    N = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), dim=0) - 1
    dest = torch.where(mask, pos, N)
    buf = torch.zeros(N + 1, dtype=torch.int32, device=mask.device)
    buf[dest] = torch.arange(N, dtype=torch.int32, device=mask.device)
    return buf[:N], mask.sum().to(torch.int32)
