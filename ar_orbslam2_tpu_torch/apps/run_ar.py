"""AR demo runner — the fork's headline app, headless.

Port of ar_orbslam2_tpu/apps/run_ar.py. Parity: ros_mono_ar.cc + ViewerAR:
per frame, track monocular, detect the dominant plane from currently
tracked landmarks, anchor virtual cubes, render the overlay to PNG frames /
MP4. A marker anchor (cv2.aruco) is maintained alongside.

  python -m ar_orbslam2_tpu_torch.apps.run_ar <settings.yaml> <tum_seq_dir> \
      --out ar_frames/ [--add-cube-at 30] [--video out.mp4] [--device cpu]

The overlay's tracked dots and the cube's plane come from the frame just
tracked. The JAX app reads ``slam.last_frame``, which the fused path never
sets, so after initialization it draws the last per-frame frame's
keypoints; here the frame comes from ``tracked_frame``.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..ar.marker import MarkerAnchor
from ..ar.viewer import ViewerAR
from ..data import datasets
from ..utils.config import load_settings
from .common import build_system


def tracked_frame(slam, rec):
    """The Frame of the tracking record `rec`, the frame track_monocular
    just returned from: the tracker's last frame where the per-frame path
    (or a keyframe event) set it, else the fused frontend's current state,
    read back in one batched readback."""
    lf = slam.tracking.last_frame
    if lf is not None and lf.frame_id == rec["frame_id"]:
        return lf
    return slam.tracking.fused.materialize_frame(rec["timestamp"],
                                                 rec["frame_id"])


def main(argv=None):
    """Returns dict(viewer, slam, cube_frame, plane_ms, frame_ms,
    drawn (frame_id per overlay), dots (tracked uv per overlay))."""
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("seq_dir")
    ap.add_argument("--out", default="ar_frames")
    ap.add_argument("--video", default=None)
    ap.add_argument("--add-cube-at", type=int, default=30,
                    help="frame index at which to 'press Add Cube'")
    ap.add_argument("--cube-size", type=float, default=0.05)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--markers", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; no GPU raises)")
    args = ap.parse_args(argv)

    import cv2
    st = load_settings(args.settings)
    slam = build_system(st, sensor="MONOCULAR", device=args.device)
    viewer = ViewerAR(cam=st.camera, device=slam.device)
    markers = MarkerAnchor(st.camera, device=slam.device) \
        if args.markers else None
    os.makedirs(args.out, exist_ok=True)

    ts, paths = datasets.load_tum_monocular(args.seq_dir)
    out = dict(viewer=viewer, slam=slam, cube_frame=None, plane_ms=None,
               frame_ms=[], drawn=[], dots=[])
    writer = None
    for i, (t, p) in enumerate(zip(ts, paths)):
        if args.max_frames and i >= args.max_frames:
            break
        im = datasets.imread_gray(p)
        t0 = time.perf_counter()
        T = slam.track_monocular(im, timestamp=t)
        rec = slam.tracking.metrics[-1]
        frame = tracked_frame(slam, rec)
        tracked = frame.mp >= 0
        if markers is not None:
            markers.update(im, T)
        if i == args.add_cube_at and T is not None:
            pts = slam.store.mp_pos[np.maximum(frame.mp, 0)]
            t1 = time.perf_counter()
            if viewer.add_cube(pts, tracked, Tcw=T,
                               size=args.cube_size) is not None:
                out["cube_frame"] = i
            out["plane_ms"] = (time.perf_counter() - t1) * 1e3
        overlay = viewer.render(im, T, tracked_uv=frame.uv[tracked],
                                state=rec["state"],
                                n_tracked=int(tracked.sum()))
        out["frame_ms"].append((time.perf_counter() - t0) * 1e3)
        out["drawn"].append(frame.frame_id)
        out["dots"].append(frame.uv[tracked])
        cv2.imwrite(os.path.join(args.out, f"{i:06d}.png"), overlay)
        if args.video:
            if writer is None:
                writer = cv2.VideoWriter(
                    args.video, cv2.VideoWriter_fourcc(*"mp4v"),
                    st.fps, (overlay.shape[1], overlay.shape[0]))
            writer.write(overlay)
    if writer is not None:
        writer.release()
    slam.shutdown()
    print(f"AR frames in {args.out}; cubes: {len(viewer.cubes)}")
    return out


if __name__ == "__main__":
    main()
