"""The fused row kernel's share of its bound: for each traced tick, the
larger of the row phase's bytes over the HBM bandwidth and its float32
operations over the float32 peak, at the rows these inputs delivered;
summed, over the kernel's traced device time."""
from h100_bench import roofline as RL

KERNEL = "fused_row_kernel"


def read(ctx):
    if ctx is None or ctx.trace is None or not ctx.ticks:
        return None
    t = ctx.trace.op_seconds(KERNEL)
    if t <= 0:
        return None
    bound = sum(RL.bound_s(RL.row_phase_bytes(nv, ctx.W, ctx.n, ctx.C),
                           RL.row_phase_ops(nv, ctx.C)) for nv in ctx.nv)
    return 100.0 * bound / t
