"""Device time of the traced server steps (the union of their device
operations) over the lane-ticks they ran (steps x lanes x ticks a step)."""


def read(ctx):
    if ctx is None or ctx.trace is None or not ctx.lane_ticks:
        return None
    return ctx.trace.busy_s / ctx.lane_ticks * 1e3
