"""The metric arithmetic on synthetic inputs: a rate over the whole
window, a percentile over all frames, the idle share as a union of
intervals, and each per-layer reader."""
from types import SimpleNamespace

import numpy as np
import pytest

from slambench import bench
from slambench.catalog import Catalog
from slambench.spans import Span
from slambench.trace import DeviceOp, Summary, union_seconds

MS = 1_000_000


def test_rate_is_over_the_whole_window_and_p95_over_all_frames():
    # three calls of 8 frames: 100, 100 and 500 ms, a 50 ms gap each
    calls = [(0, 100 * MS, 8), (150 * MS, 250 * MS, 8),
             (300 * MS, 800 * MS, 8)]
    e = bench.end_to_end(calls, setup_s=12.5)
    assert e["window_s"] == pytest.approx(0.8)
    assert e["track_fps"] == pytest.approx(24 / 0.8)
    assert e["setup_s"] == 12.5
    p95 = Catalog().reader("frame_ms_p95")(SimpleNamespace(calls=calls))
    lat = [100.0] * 16 + [500.0] * 8
    assert p95 == pytest.approx(np.percentile(lat, 95))
    assert p95 == pytest.approx(500.0)


def test_idle_share_is_one_minus_the_union_of_device_intervals():
    iv = [(0, 10), (5, 20), (30, 40), (35, 38), (90, 120)]
    busy, gaps = union_seconds(iv, 0, 100)
    assert busy == pytest.approx(40 / 1e9)        # [0,20) [30,40) [90,100)
    assert gaps == [(20, 30), (40, 90)]
    busy, gaps = union_seconds([(10, 20)], 0, 30)
    assert gaps == [(0, 10), (20, 30)]


def _ctx():
    ops = [DeviceOp("k", 0, 4 * MS, True, 1), DeviceOp("k", 5 * MS,
                                                         9 * MS, True, 1),
           DeviceOp("k", 10 * MS, 12 * MS, True, 2),
           DeviceOp("copy", 12 * MS, 13 * MS, False, 7)]
    tr = Summary(window_s=0.02, busy_s=0.012, ops=ops, replays=2)
    recs = [dict(frame_id=i) for i in range(20)]
    # a hard event (whole on the tracking thread), then two soft ones
    # (submitted, then waited for)
    recs[3].update(t_kf_ms=40.0, kf_hard=True)
    recs[11].update(t_kf_ms=0.5, kf_hard=False, t_kf_submit_ms=0.4)
    recs[19].update(t_kf_ms=0.25, kf_hard=False, t_kf_submit_ms=0.2)
    spans = [Span("process_keyframe", 0, 300 * MS, 1, {"t_local_ba_ms": 200}),
             Span("process_keyframe", 0, 100 * MS, 1, {"t_local_ba_ms": 50}),
             Span("process_keyframe", 0, 200 * MS, 1, {}),
             Span("chunk_call", 0, 900 * MS, 2, {}),
             Span("kf_wait", 10 * MS, 10 * MS + 1000, 2, {"pending": False}),
             Span("kf_wait", 700 * MS, 1100 * MS, 2, {"pending": True}),
             Span("kf_wait", 400 * MS, 700 * MS, 2, {"pending": True})]
    calls = [(0, 100 * MS, 8), (150 * MS, 250 * MS, 8)]
    return SimpleNamespace(records=recs, spans=spans, trace=tr,
                           roofline=(0.5e-6, 20e-6, {}), frames=20,
                           calls=calls)


@pytest.mark.parametrize("metric,want", [
    ("kf_per_100_frames", 15.0),
    # the soft events pair with the pending waits in order: 300, 400 ms
    ("kf_event_ms_p90", float(np.percentile([40.0, 300.5, 400.25], 90))),
    ("frame_ms_p95", 100.0),
    ("graph_device_ms_per_frame", 5.0),
    ("graph_kernels_per_frame", 1.5),
    ("mapping_ms_per_kf_p50", 200.0),
    ("local_ba_ms_p50", 125.0),
    ("hamming_roofline", 2.5),
    ("device_idle_pct", 40.0),
])
def test_per_layer_reader(metric, want):
    assert Catalog().reader(metric)(_ctx()) == pytest.approx(want)


@pytest.mark.parametrize("metric", [
    "kf_event_ms_p90", "frame_ms_p95", "graph_device_ms_per_frame",
    "graph_kernels_per_frame", "mapping_ms_per_kf_p50", "local_ba_ms_p50",
    "hamming_roofline", "device_idle_pct"])
def test_a_reader_with_nothing_to_read_returns_nothing(metric):
    empty = SimpleNamespace(records=[dict(frame_id=0)], spans=[],
                            trace=None, roofline=None, frames=1, calls=[])
    assert Catalog().reader(metric)(empty) is None


def test_keyframe_events_that_do_not_pair_with_waits_give_nothing():
    ctx = _ctx()
    ctx.spans = [s for s in ctx.spans if s.name != "kf_wait"]
    assert Catalog().reader("kf_event_ms_p90")(ctx) is None


def test_the_wait_span_says_whether_a_soft_keyframe_was_pending():
    from slambench.spans import Spans, _soft_pending

    class Tracker:
        kf_mapped = None

        def wait_for_keyframe_mapping(self):
            self.kf_mapped = None

    t = Tracker()
    sp = Spans()
    sp.wrap(t, "wait_for_keyframe_mapping", "kf_wait", before=_soft_pending)
    t.wait_for_keyframe_mapping()
    t.kf_mapped = object()
    t.wait_for_keyframe_mapping()
    assert [s.info["pending"] for s in sp.spans] == [False, True]


class _Event:
    def __init__(self, name, start, dur, corr, cuda, annotation=False):
        self._v = (name, start, dur, corr, cuda, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        import torch
        return (torch.autograd.DeviceType.CUDA if self._v[4]
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return self._v[5]


def test_trace_reduction_keeps_device_work_and_names_gaps():
    from slambench import trace as TR
    from slambench.spans import Span
    ev = [
        _Event("slambench.clock", 1000, 1, 0, False),
        _Event("slambench.traced_window", 1000, 1000, 0, False),
        _Event("slambench.traced_window", 1000, 1000, 0, True, True),
        _Event("slambench.call", 1000, 400, 0, False),
        _Event("slambench.call", 1500, 500, 0, False),
        _Event("cudaGraphLaunch", 1010, 5, 7, False),
        _Event("cudaGraphLaunch", 1510, 5, 8, False),
        _Event("k1", 1100, 100, 7, True),        # replay 7
        _Event("k2", 1150, 100, 7, True),
        _Event("k1", 1600, 100, 8, True),        # replay 8
        _Event("memcpy", 1800, 50, 9, True),     # not in a replay
    ]
    prof = type("P", (), {})()
    prof.profiler = type("Q", (), {})()
    prof.profiler.kineto_results = type(
        "R", (), {"events": staticmethod(lambda: ev)})()
    spans = [Span("chunk_call", 0, 10_000, 1),
             Span("process_keyframe", 200, 500, 2)]
    s = TR.reduce(prof, "slambench.traced_window", "slambench.clock",
                  "slambench.call", host_clock_ns=0, spans=spans)
    assert s.window_s == pytest.approx(1000e-9)
    assert s.busy_s == pytest.approx(300e-9)   # [1100,1250) [1600,1700) ...
    assert s.replays == 2 and len(s.graph_ops()) == 3
    assert s.calls == [(1000, 1400), (1500, 2000)]
    assert all(not n.startswith("slambench.") for n, _ in s.device_ops)
    longest = s.idle_gaps[0]
    assert longest[1] == pytest.approx(350e-9)          # [1250, 1600)
    assert longest[0] == "process_keyframe"   # 1425 lies in [1200, 1500)
