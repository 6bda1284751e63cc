"""The whole tick's share of the card's peak: each traced tick's bound
(every touched cell, 40 bytes and 60 float32 operations, at the rows
delivered and minicolumns fired), summed, over the device's busy time in
the traced chunk (the union of its operations). The profiler stretches
the traced chunk's wall time (about twice at 256 HCUs), not the device's
work, so the busy time stands for the tick's. It bounds the tick whatever
kernels implement it."""
from h100_bench import roofline as RL


def read(ctx):
    if ctx is None or ctx.trace is None or not ctx.ticks:
        return None
    if ctx.trace.busy_s <= 0:
        return None
    bound = sum(RL.tick_bound_s(RL.tick_cells(nv, ctx.C, nf, ctx.R))
                for nv, nf in zip(ctx.nv, ctx.nf))
    return 100.0 * bound / ctx.trace.busy_s
