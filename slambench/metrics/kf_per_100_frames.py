"""Keyframe events per 100 window frames: the window's tracking records
that carry the program's keyframe flag (``t_kf_ms``, set on the record of
the frame whose keyframe the tracker decided)."""


def read(ctx):
    if not ctx.records:
        return None
    n = sum(1 for r in ctx.records if "t_kf_ms" in r)
    return 100.0 * n / len(ctx.records)
