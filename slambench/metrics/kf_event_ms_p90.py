"""90th percentile, over the window's keyframe events, of the time the
tracking thread spends on one: its own keyframe step (the program's
``t_kf_ms`` on the record: the whole of a hard event, the submit of a
soft one) plus, for a soft event, the chunk call's wait for the worker to
map it (the ``kf_wait`` span that found it pending). Soft events (records
with ``t_kf_submit_ms``) and pending waits pair in order; None where
there is no event, or where they do not pair."""
import numpy as np


def read(ctx):
    events = sorted((r for r in ctx.records if "t_kf_ms" in r),
                    key=lambda r: r["frame_id"])
    if not events:
        return None
    waits = sorted((s for s in ctx.spans
                    if s.name == "kf_wait" and s.info.get("pending")),
                   key=lambda s: s.t0)
    soft = [r for r in events if "t_kf_submit_ms" in r]
    if len(soft) != len(waits):
        return None
    wait_ms = {id(r): w.ms for r, w in zip(soft, waits)}
    ms = [r["t_kf_ms"] + wait_ms.get(id(r), 0.0) for r in events]
    return float(np.percentile(ms, 90))
