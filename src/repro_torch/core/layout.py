"""The flat (H*R, C) plane layout (the flat half of `repro.core.layout`).

The flat layout is the stored form of `NetworkState.hcus`: ij planes
(H*R, C), i-vectors (H*R,), j-vectors (H, C). HCU h's synaptic row r is the
plane row with global index

    g = h * R + r          (`global_row` below),

and HCU h's column j is the (R, 1) block at (h*R, j). The batched
(H, R, C) view is a reshape of the same storage (`batched_state`), so
both views share memory: writing through one writes the other.

The column-blocked Row-Merge layout of the JAX package is not ported yet
(ROADMAP queue A item 7).
"""
from __future__ import annotations

_FLAT_PLANE_FIELDS = ("zij", "eij", "pij", "wij", "tij")
_FLAT_VEC_FIELDS = ("zi", "ei", "pi", "ti")


def flat_state(hcus):
    """Batched (H, R, C)/(H, R) HCUState -> the flat layout (views)."""
    upd = {f: getattr(hcus, f).reshape(-1, getattr(hcus, f).shape[-1])
           for f in _FLAT_PLANE_FIELDS}
    upd.update({f: getattr(hcus, f).reshape(-1) for f in _FLAT_VEC_FIELDS})
    return hcus._replace(**upd)


def batched_state(hcus, n_hcu: int):
    """Flat HCUState -> the per-HCU batched (H, R, C)/(H, R) view (views of
    the same storage)."""
    upd = {f: getattr(hcus, f).reshape(n_hcu, -1, getattr(hcus, f).shape[-1])
           for f in _FLAT_PLANE_FIELDS}
    upd.update({f: getattr(hcus, f).reshape(n_hcu, -1)
                for f in _FLAT_VEC_FIELDS})
    return hcus._replace(**upd)


def global_row(h, r, rows: int):
    """(hcu, row) -> global flat row index; broadcastable."""
    return h * rows + r
