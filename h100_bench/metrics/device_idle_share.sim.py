"""The share of the traced chunk's wall time in which no device operation
ran: 1 - (the union of the device operations' intervals) / window. The
profiler stretches what it traces, so this is the traced run's share."""


def read(ctx):
    if ctx is None or ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
