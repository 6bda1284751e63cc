"""Nodes of the captured chunk's CUDA graph (`cuGraphGetNodes`) over its
ticks: the device operations one simulated tick costs."""


def read(ctx):
    if ctx is None or not ctx.graph_nodes:
        return None
    return ctx.graph_nodes / ctx.chunk
