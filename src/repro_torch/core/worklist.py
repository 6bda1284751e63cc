"""The network-global worklist of touched plane rows (the port of
`repro.core.worklist`'s `build_worklist`, `compact_mask` and
`patch_cells`).

The paper's lazy model keeps per-tick synaptic traffic proportional to
spikes, not synapses (§VI.D). Each tick the deduplicated per-HCU row slots
become one worklist of global flat row indices, and the row kernel
(`repro_torch.kernels.ops.fused_row_update`) rewrites exactly those rows of
the flat planes in place. The JAX package's while-loop staging and
writeback primitives exist only for XLA's buffer aliasing: here the
callers gather and scatter through the layout's index maps
(`layout.cell_index` and the row / column maps built on it).
"""
from __future__ import annotations

import torch

from repro_torch.core import hcu as H
from repro_torch.core import layout as L
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


def patch_cells(zf, mask, rows_u, ziv, fired, n_rows: int, n_cols: int,
                layout=None) -> None:
    """Merged-mode same-tick patch, in place on the stored Zij plane ``zf``
    (flat (H*R, C), or stored in ``layout``): Zi(now) added to cell
    (h, row, fired[h]) for every row of this tick in every HCU h where
    ``mask`` (H,) (the fired HCUs whose column did not overflow).

    rows_u (H, A) this tick's deduplicated rows (valid first, padding ==
    n_rows), ziv (H, A) their post-increment Zi values. Fired HCUs and
    deduplicated rows are unique, so the adds need no ordering; padding
    rows and unmasked HCUs write their cells' old values back
    (`hcu.drop_redirect`), which is the JAX package's ``mode="drop"`` and
    its early-exiting loop. The offsets are `layout.cell_index`'s, the
    index map of `layout.add_cell`."""
    n = rows_u.shape[0]
    h = torch.arange(n, device=rows_u.device)[:, None]
    j = torch.clamp(fired, min=0)[:, None]
    cell = L.as_layout(layout, n_rows, n_cols).cell_index(
        h, torch.clamp(rows_u, max=n_rows - 1), j)               # (H, A)
    flat = zf.view(-1)
    old = flat[cell]
    valid = (rows_u < n_rows) & mask[:, None]
    H.put_drop(flat, old + ziv, old, H.drop_redirect(cell, valid))
