"""Median of the mapper's own local-BA timer (``t_local_ba_ms`` of
``LocalMapper.last_stats``), kept after each ``process_keyframe`` call of
the window."""
import numpy as np


def read(ctx):
    ms = [s.info["t_local_ba_ms"] for s in ctx.spans
          if s.name == "process_keyframe" and "t_local_ba_ms" in s.info]
    return float(np.median(ms)) if ms else None
