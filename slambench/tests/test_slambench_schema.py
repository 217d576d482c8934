"""The last line of a run: its keys, the cell's metric names and units,
the device keys, the traced run's breakdown, and the compared numbers
last."""
import json

from slambench import bench
from slambench.catalog import Catalog
from slambench.trace import DeviceOp, Summary

CELL = "euroc_mono.wall_walk"
MS = 1_000_000


def _out():
    ops = [DeviceOp("hamming_search_kernel", 0, MS, True, 1)]
    return dict(
        correct=True, attempted=240, failed=0,
        e2e=dict(track_fps=6.5, setup_s=48.0),
        timing=[(0, 1200 * MS, 8), (1200 * MS, 2000 * MS, 8)],
        device=dict(platform="gpu", kind="NVIDIA H100 80GB HBM3", count=1,
                    memory_peak_bytes=123456789),
        lines=[("failed_frames", 0.0, 0, True),
               ("ate_mm", 3.2, 20.0, True)],
        records=[dict(frame_id=0, t_kf_ms=5.0), dict(frame_id=1)],
        spans=[], roofline=(1e-6, 1e-4, {}),
        summary=Summary(window_s=1.5, busy_s=1.0, ops=ops, replays=1,
                        device_ops=[["hamming_search_kernel", 0.001]],
                        idle_gaps=[["process_keyframe", 0.25]]))


def test_untraced_line():
    line = bench.result_line(CELL, _out(), False)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    want = {m["name"]: m["unit"] for m in Catalog().metrics(
        CELL, "end_to_end")}
    assert {k: v["unit"] for k, v in line["metrics"].items()} == want
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["checks"] == {"failed_frames": {"value": 0.0, "limit": 0},
                              "ate_mm": {"value": 3.2, "limit": 20.0}}
    json.dumps(line)


def test_traced_line():
    line = bench.result_line(CELL, _out(), True)
    assert list(line)[-1] == "checks" and "breakdown" in line
    assert line["device"]["busy_s"] == 1.0
    assert line["device"]["window_s"] == 1.5
    names = {m["name"] for m in Catalog().metrics(CELL, "per_layer")}
    assert set(line["metrics"]) <= names
    assert "kf_per_100_frames" in line["metrics"]
    assert line["metrics"]["frame_ms_p95"] == {"value": 1200.0,
                                               "unit": "ms"}
    for key in ("device_ops", "idle_gaps"):
        rows = line["breakdown"][key]
        assert len(rows) <= 10 and all(
            isinstance(n, str) and isinstance(s, float) for n, s in rows)
    json.dumps(line)
