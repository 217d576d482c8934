"""Device time of the kernels that ran inside CUDA-graph replays of the
frame step, per replayed (fused) frame, over the traced sub-window."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.replays:
        return None
    ns = sum(o.end - o.start for o in t.graph_ops())
    return ns / 1e6 / t.replays
