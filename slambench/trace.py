"""Reduction of one torch.profiler session over the traced sub-window to
what the per-layer metrics read: device busy time as the union of the
intervals in which an operation ran on the device, the kernels that ran
inside CUDA-graph replays, the Hamming search's kernels, the operations
that took most time, and the longest idle gaps named by the host span
they fell in. The arithmetic of ``eval/profile_fused.py`` (device events
of the session, their time by name), extended by the union and the
graph-launch correlation."""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

TOP = 10
MARK_PREFIX = "slambench."


@dataclass
class DeviceOp:
    name: str
    start: int              # ns, the trace's clock
    end: int
    graph: bool             # ran inside a CUDA-graph replay
    launch: int             # correlation id of the launching API call


@dataclass
class Summary:
    window_s: float
    busy_s: float
    ops: list
    replays: int
    calls: list = field(default_factory=list)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    def graph_ops(self):
        return [o for o in self.ops if o.graph]


def union_seconds(intervals, lo, hi):
    """Length of the union of [start, end) intervals clipped to [lo, hi),
    in seconds (ns in), and the gaps between them as (start, end)."""
    busy = 0
    gaps = []
    cur = lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if cur < hi:
        gaps.append((cur, hi))
    return busy / 1e9, gaps


def _events(prof):
    """The session's raw events, read without building the profiler's
    event tree (which takes minutes for a million kernels)."""
    return prof.profiler.kineto_results.events()


def span_namer(spans, offset_ns):
    """name_at(ns): the innermost host span (shortest of those covering
    the trace time ns) on any thread; spans are on the host's
    perf_counter_ns clock, ``offset_ns`` ahead of which the trace runs."""
    def name_at(ns):
        best = None
        for s in spans:
            if s.t0 + offset_ns <= ns <= s.t1 + offset_ns and (
                    best is None or s.t1 - s.t0 < best.t1 - best.t0):
                best = s
        return best.name if best is not None else "no_span"
    return name_at


def reduce(prof, window_mark, clock_mark, call_mark, host_clock_ns, spans):
    """Summary of a session in which the harness marked the traced
    sub-window (``record_function(window_mark)``), each call in it
    (``call_mark``), and one instant whose host time was host_clock_ns
    (``clock_mark``)."""
    lo = hi = None
    clock = None
    calls = []
    graph_launches = set()
    ops = []
    for e in _events(prof):
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name.startswith(MARK_PREFIX) or getattr(
                    e, "is_user_annotation", lambda: False)():
                continue        # a host mark's shadow on the device
            ops.append((name, e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.correlation_id()))
        elif name == window_mark:
            lo, hi = e.start_ns(), e.start_ns() + e.duration_ns()
        elif name == call_mark:
            calls.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name == clock_mark:
            clock = e.start_ns()
        elif "GraphLaunch" in name:
            graph_launches.add(e.correlation_id())
    if lo is None or not ops:
        return None
    dev = [DeviceOp(n, s, t, c in graph_launches, c) for n, s, t, c in ops
           if t > lo and s < hi]
    busy, gaps = union_seconds([(o.start, o.end) for o in dev], lo, hi)
    by_name: dict = {}
    for o in dev:
        by_name[o.name] = by_name.get(o.name, 0) + (o.end - o.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    name_at = span_namer(spans, 0 if clock is None else clock - host_clock_ns)
    return Summary(
        window_s=(hi - lo) / 1e9, busy_s=busy, ops=dev,
        replays=len({o.launch for o in dev if o.graph}),
        calls=sorted(calls),
        device_ops=[[n[:160], t / 1e9] for n, t in top],
        idle_gaps=[[name_at((s + e) // 2), (e - s) / 1e9]
                   for s, e in longest])
