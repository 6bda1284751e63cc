"""The yardstick's table of peaks and its counts of the work a tick needs.

Peaks are NVIDIA's data sheet for the H100 SXM (80 GB HBM3) at its 700 W
limit: 3.35 TB/s of HBM bandwidth and 67 TFLOP/s of float32 outside the
tensor cores. A bound is the larger of bytes over bandwidth and operations
over the float32 peak; a share of it is bound time over measured time.

Counts are of what the inputs need, never of a kernel's launch arguments:
``nv`` the distinct rows delivered to the HCUs in a tick (live worklist
slots), ``W`` the tick's row slots (n HCUs x (queue capacity + drive
width)), ``nf`` the fired minicolumns in the fired batch, ``K`` its slots.
Every input byte is counted as read once and every output byte as written
once.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# float32 operations of one cell update (three exp, one log and one
# division counted as one each), the kernels' arithmetic
OPS_PER_CELL = 33
# the whole tick's count per touched cell, as the port's dry run counts:
# 20 bytes read and 20 written (Zij, Eij, Pij, Wij, Tij), 60 float32
# operations with a transcendental as 8
TICK_BYTES_PER_CELL = 40
TICK_FLOPS_PER_CELL = 60


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)


def row_phase_bytes(nv, W, n, C):
    """Bytes of the fused row phase: each live slot reads and writes its
    row of the five planes (Tij read, Zij, Eij, Pij read and written, Wij
    written: 9 row accesses of C x 4 bytes), writes its weight row and 4
    i-vector cells; each other slot writes a zero weight row; the (n, C)
    j-vectors Zj and Pj are read once; the six per-slot operands once."""
    row = C * 4
    return nv * (9 * row + C * 4 + 16) + (W - nv) * C * 4 + n * C * 8 + W * 24


def row_phase_ops(nv, C):
    return nv * C * OPS_PER_CELL


def col_phase_bytes(nf, K, R):
    """Bytes of the fused column phase: each fired entry's column of the
    five planes (9 column accesses of R x 4 bytes) and its R cells of the
    four i-vectors; the batch's two index vectors."""
    col = R * 4
    return nf * (9 * col + R * 16 + 4) + K * 8


def col_phase_ops(nf, R):
    return nf * R * OPS_PER_CELL


def tick_cells(nv, C, nf, R):
    """Cells a tick touches: each live row slot's C and each fired
    minicolumn's R."""
    return nv * C + nf * R


def tick_bound_s(cells) -> float:
    return bound_s(cells * TICK_BYTES_PER_CELL, cells * TICK_FLOPS_PER_CELL)
