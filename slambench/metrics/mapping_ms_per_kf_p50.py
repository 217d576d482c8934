"""Median wall time of ``LocalMapper.process_keyframe`` over the window,
from the span the benchmark records around each call."""
import numpy as np


def read(ctx):
    ms = [s.ms for s in ctx.spans if s.name == "process_keyframe"]
    return float(np.median(ms)) if ms else None
