"""The WTA kernel's share of its bound: for each traced tick, the larger of
the bytes the tick's soft winner-take-all needs over the HBM bandwidth and
its drive's float32 operations over the float32 peak, at the rows these
inputs delivered; summed, over the kernel's traced device time. Reads
nothing where the program has no such kernel."""
from h100_bench import roofline as RL

KERNEL = "wta_draw_kernel"


def wta_bytes(nv, n, C):
    """Bytes of one tick's WTA: each delivered row's weight row (C x 4)
    and its count (4); the (n, C) support and Pj read and the support
    written; one fired index an HCU written. Padding and duplicate slots,
    whose counts are 0, add nothing to the drive and are not counted."""
    return nv * (C * 4 + 4) + n * C * 12 + n * 4


def wta_ops(nv, C):
    """float32 operations of the drive: a multiply and an add a delivered
    row's cell."""
    return 2 * nv * C


def read(ctx):
    if ctx is None or ctx.trace is None or not ctx.ticks:
        return None
    t = ctx.trace.op_seconds(KERNEL)
    if t <= 0:
        return None
    bound = sum(RL.bound_s(wta_bytes(nv, ctx.n, ctx.C), wta_ops(nv, ctx.C))
                for nv in ctx.nv)
    return 100.0 * bound / t
