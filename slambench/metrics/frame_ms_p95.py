"""95th percentile, over every frame of the window, of the frame's
latency: from the start of the ``track_monocular_batch`` call that took
it to that call's return (host clock)."""
import numpy as np


def read(ctx):
    if not ctx.calls:
        return None
    ms = [(t1 - t0) / 1e6 for t0, t1, n in ctx.calls for _ in range(n)]
    return float(np.percentile(np.asarray(ms, np.float64), 95))
