"""Device time a tick of every operation but the two fused BCPNN kernels
(the tick glue: bucket, dedup, worklist, threefry keys, WTA, fired batch,
fan-out and enqueue), over the traced chunk of `Simulator.run`."""

KERNELS = ("fused_row_kernel", "fused_col_kernel")


def read(ctx):
    if ctx is None or ctx.trace is None or not ctx.ticks:
        return None
    glue = ctx.trace.op_seconds() - sum(ctx.trace.op_seconds(k)
                                        for k in KERNELS)
    return glue / ctx.ticks * 1e6
