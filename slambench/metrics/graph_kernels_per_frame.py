"""Device operations per replayed (fused) frame inside the CUDA-graph
replays of the traced sub-window."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.replays:
        return None
    return len(t.graph_ops()) / t.replays
