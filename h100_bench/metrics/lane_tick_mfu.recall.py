"""A lane-tick's bound over its traced device time (`lane_tick_ms.recall`):
the column cells of the minicolumns that fired (each R cells of 40 bytes
and 60 float32 operations). The delivered rows are not counted, so this
is a lower bound of the share."""
from h100_bench import roofline as RL


def read(ctx):
    if ctx is None or ctx.trace is None or not ctx.lane_ticks:
        return None
    if not ctx.col_cells or ctx.trace.busy_s <= 0:
        return None
    bound = RL.tick_bound_s(ctx.col_cells)
    return 100.0 * bound / ctx.trace.busy_s
