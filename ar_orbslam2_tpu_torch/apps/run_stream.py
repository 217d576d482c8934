"""Live-stream SLAM entry point — the ROS-node analog.

Port of ar_orbslam2_tpu/apps/run_stream.py. Parity: Examples/ROS/
ORB_SLAM2/src/ros_mono.cc / ros_mono_ar.cc: where the reference subscribes
to a ROS image topic and feeds each callback frame to
System::TrackMonocular, this entry point consumes any frame source cv2
can open — a webcam index ("0"), a video file, or an image glob — and
tracks frames as they arrive. With --ar the per-frame pose drives the
plane-anchored AR overlay (ViewerAR parity) written to --out.

  python -m ar_orbslam2_tpu_torch.apps.run_stream <settings.yaml> <source> \
      [--ar] [--out overlay_dir] [--max-frames N] [--metrics m.jsonl] \
      [--load-map map.npz] [--localization] [--device cpu]

Frames are processed at arrival rate (no sleep-to-timestamp: a live
source paces itself); per-frame metrics stream to --metrics JSONL.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

from ..utils.config import load_settings
from .common import build_system, jsonable


def frame_source(src: str):
    """Yield grayscale uint8 frames from a webcam index, video file, or
    image glob — the transport-agnostic stand-in for the image topic."""
    import cv2
    if src.isdigit() or src.endswith((".mp4", ".avi", ".mkv", ".mov")):
        cap = cv2.VideoCapture(int(src) if src.isdigit() else src)
        if not cap.isOpened():
            raise RuntimeError(f"cannot open stream {src!r}")
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                if frame.ndim == 3:
                    frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
                yield frame
        finally:
            cap.release()
    else:
        paths = sorted(glob.glob(src)) if any(c in src for c in "*?[") \
            else sorted(glob.glob(os.path.join(src, "*")))
        for p in paths:
            img = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
            if img is not None:
                yield img


def main(argv=None):
    """Returns the SlamSystem after the stream ends (shut down)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("source", help="webcam index, video file, or image glob")
    ap.add_argument("--ar", action="store_true")
    ap.add_argument("--out", default=None, help="AR overlay frame dir")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--metrics", default=None, help="JSONL metrics path")
    ap.add_argument("--localization", action="store_true",
                    help="track against a loaded map without extending it")
    ap.add_argument("--load-map", default=None)
    ap.add_argument("--save-traj", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; no GPU raises)")
    args = ap.parse_args(argv)

    st = load_settings(args.settings)
    slam = build_system(st, sensor="MONOCULAR", device=args.device)
    if args.load_map:
        slam.load_map(args.load_map, localization_only=args.localization)
    elif args.localization:
        slam.activate_localization_mode()

    viewer = None
    if args.ar:
        from ..ar.viewer import ViewerAR
        viewer = ViewerAR(cam=st.camera, device=slam.device)
        if args.out:
            os.makedirs(args.out, exist_ok=True)

    mf = open(args.metrics, "w") if args.metrics else None
    times = []
    n = 0
    try:
        for img in frame_source(args.source):
            t0 = time.perf_counter()
            T = slam.track_monocular(np.asarray(img), timestamp=time.time())
            times.append(time.perf_counter() - t0)
            rec = slam.tracking.metrics[-1]
            if mf:
                mf.write(json.dumps({k: v for k, v in rec.items()
                                     if not isinstance(v, np.ndarray)},
                                    default=jsonable) + "\n")
            if viewer is not None:
                overlay = viewer.render(np.asarray(img), T,
                                        state=slam.tracking.state)
                if args.out:
                    import cv2
                    cv2.imwrite(os.path.join(args.out, f"{n:06d}.png"),
                                overlay)
            n += 1
            if args.max_frames and n >= args.max_frames:
                break
    finally:
        if mf:
            mf.close()
    if args.save_traj:
        slam.save_trajectory_tum(args.save_traj)
    slam.shutdown()
    if times:
        t = np.asarray(times)
        print(f"{n} frames, median {np.median(t)*1e3:.1f} ms/frame, "
              f"mean {t.mean()*1e3:.1f} ms "
              f"({1.0/max(np.median(t),1e-9):.1f} fps), "
              f"state={slam.tracking.state} "
              f"kf={slam.store.n_keyframes()}", file=sys.stderr)
    return slam


if __name__ == "__main__":
    main()
