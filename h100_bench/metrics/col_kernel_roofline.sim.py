"""The fused column kernel's share of its bound: for each traced tick, the
larger of the column phase's bytes over the HBM bandwidth and its float32
operations over the float32 peak, at the minicolumns that fired into the
batch; summed, over the kernel's traced device time."""
from h100_bench import roofline as RL

KERNEL = "fused_col_kernel"


def read(ctx):
    if ctx is None or ctx.trace is None or not ctx.ticks:
        return None
    t = ctx.trace.op_seconds(KERNEL)
    if t <= 0:
        return None
    bound = sum(RL.bound_s(RL.col_phase_bytes(nf, ctx.K, ctx.R),
                           RL.col_phase_ops(nf, ctx.R)) for nf in ctx.nf)
    return 100.0 * bound / t
