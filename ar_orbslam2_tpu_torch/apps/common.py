"""Shared CLI runner plumbing — parity with the reference example mains
(Examples/Monocular/mono_tum.cc etc.): load settings, feed the sequence
frame by frame, time each frame, print the median/mean tracking time, save
trajectories.

Port of ar_orbslam2_tpu/apps/common.py. The system runs on ``device``: the
GPU unless the caller asks for the CPU; there is no quiet move to the CPU.
"""
from __future__ import annotations

import json
import time

import numpy as np

from ..mapstore.map import MapConfig
from ..system.slam import SlamConfig, SlamSystem
from ..system.tracking import TrackingConfig
from ..utils.config import Settings


def build_system(settings: Settings, sensor="MONOCULAR",
                 enable_loops=True, async_mapping=False,
                 device=None) -> SlamSystem:
    """The system the apps run: nFeatures rounded up to a power of two (at
    least 512) gives the padded keypoint count; a keyframe at least once
    per second of video."""
    tcfg = TrackingConfig(
        max_kp=max(512, 1 << (settings.n_features - 1).bit_length()),
        scale_factor=settings.scale_factor, n_levels=settings.n_levels,
        max_frames_between_kf=int(settings.fps))
    cfg = SlamConfig(sensor=sensor, tracking=tcfg,
                     map=MapConfig(max_kp=tcfg.max_kp),
                     orb_n_features=settings.n_features,
                     enable_loop_closing=enable_loops,
                     depth_threshold=settings.th_depth,
                     async_mapping=async_mapping)
    return SlamSystem(settings.camera, cfg, device=device)


def precompile(slam: SlamSystem):
    """Warm every kernel and capture every CUDA graph on the main thread
    before the timed sequence (the Hamming kernel is built by nvcc at its
    first use, and a capture in the steady state is a stall of seconds).
    Same call the benchmark makes."""
    t0 = time.perf_counter()
    slam.precompile()
    print(f"precompile: {time.perf_counter() - t0:.1f}s")


def jsonable(v):
    """json.dumps fallback for the numpy values of a metrics record."""
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    raise TypeError(f"{type(v).__name__} in a metrics record")


def metrics_rows(metrics):
    """The JSONL rows of the tracking records: the pose matrices R and t
    become the camera centre twc."""
    for rec in metrics:
        row = {k: v for k, v in rec.items() if k not in ("R", "t")}
        if "t" in rec:
            row["twc"] = (-(rec["R"].T @ rec["t"])).tolist()
        yield json.dumps(row, default=jsonable)


def run_sequence(slam: SlamSystem, frames, metrics_path=None,
                 traj_prefix=None, realtime_fps=0.0, chunk=0):
    """frames: iterable of (timestamp, kwargs-for-track_*). Each item is
    (ts, dict(image_u8=...)), (ts, dict(image_u8, depth_m)), or
    (ts, dict(left_u8, right_u8)).

    chunk > 1 enables fused chunked tracking for monocular images
    (track_monocular_batch): one graph replay per frame and one readback
    per `chunk` frames — the bench's throughput mode (offline datasets have
    no latency constraint). Non-mono frames and realtime mode track per
    frame. Returns the per-frame host times (s); a chunk's time is shared
    by its frames."""
    times = []
    buf_im, buf_ts = [], []

    def flush():
        if not buf_im:
            return
        t0 = time.perf_counter()
        slam.track_monocular_batch(buf_im, timestamps=buf_ts,
                                   chunk=min(chunk, len(buf_im)))
        per = (time.perf_counter() - t0) / len(buf_im)
        times.extend([per] * len(buf_im))
        buf_im.clear()
        buf_ts.clear()

    for ts, kw in frames:
        if chunk > 1 and realtime_fps <= 0 and "image_u8" in kw \
                and "depth_m" not in kw:
            buf_im.append(kw["image_u8"])
            buf_ts.append(ts)
            if len(buf_im) >= chunk:
                flush()
            continue
        flush()
        t0 = time.perf_counter()
        if "left_u8" in kw:
            slam.track_stereo(kw["left_u8"], kw["right_u8"], timestamp=ts)
        elif "depth_m" in kw:
            slam.track_rgbd(kw["image_u8"], kw["depth_m"], timestamp=ts)
        else:
            slam.track_monocular(kw["image_u8"], timestamp=ts)
        dt = time.perf_counter() - t0
        times.append(dt)
        if realtime_fps > 0:
            lag = 1.0 / realtime_fps - dt
            if lag > 0:
                time.sleep(lag)
    flush()
    times = np.asarray(times)
    print(f"median tracking time: {np.median(times)*1e3:.2f} ms")
    print(f"mean tracking time:   {times.mean()*1e3:.2f} ms")
    if metrics_path:
        with open(metrics_path, "w") as f:
            for row in metrics_rows(slam.tracking.metrics):
                f.write(row + "\n")
    if traj_prefix:
        slam.save_keyframe_trajectory_tum(traj_prefix + "_kf_tum.txt")
        slam.save_trajectory_tum(traj_prefix + "_tum.txt")
        slam.save_trajectory_kitti(traj_prefix + "_kitti.txt")
    return times
