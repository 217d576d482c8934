"""Every loop-closing attempt on chip_smoke.py phase 8's room loop
(synthetic.render_room_loop: `--turns` turns of a circle of radius
`--radius` in an 8 m room, looking outward at walls that each carry their
own texture, in `--frames` frames), through SlamConfig() (or
SlamConfig(async_mapping=True)) at full width, with LoopCloserConfig()'s
defaults and track_monocular_batch(chunk=8), as phase 8 runs it.
One JSON line per run: the loops closed, the accepted S12's rotation
against the map's and against the true relative rotation of its two
keyframes, the keyframe ATE, the wall time, the first frame past the
half turn whose keyframe is already covisible with a keyframe of frames
0-12 (`rebound_at`: from then on the database never proposes those),
and, for each attempt, the two keyframes' source frames and what each
stage of ComputeSim3 kept (brute-force matches, RANSAC inliers,
SearchBySim3 pairs, optimize_sim3 inliers, top-up total) against the
gates (20, -, -, 20, 40). With `--detections` it also lists, for each
loop detection from three quarters of the turn on, the candidates'
source frames and which keyframes of frames 0-12 are covisible with the
query; with `--timeline` each frame's state, inliers, local-map points
visible and keyframe count. The first line is the frame-level reference:
brute-force ORB matches between the first frame and the frame where the
circle revisits it. With --observe every ComputeSim3 is rejected, so a
run shows what the database proposes all the way round; with --no-loops
the system runs without a loop closer.

  python -m ar_orbslam2_tpu_torch.eval.loop_attempts [--runs 3] \
      [--async-mapping] [--observe] [--no-loops] [--frames 440] \
      [--turns 1.1] [--radius 1.5] [--timeline] [--detections]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..core.camera import Camera
from ..core.device import resolve_device
from ..data import synthetic
from ..eval.ate import ate_rmse
from ..frontend.orb import OrbConfig, extract_orb
from ..matching import matcher
from ..ops import hamming as H
from ..system.slam import SlamConfig, SlamSystem

EARLY = 12          # source frames whose keyframes the circle revisits


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--async-mapping", action="store_true")
    ap.add_argument("--observe", action="store_true",
                    help="reject every ComputeSim3: no loop closes")
    ap.add_argument("--no-loops", action="store_true",
                    help="SlamConfig(enable_loop_closing=False)")
    ap.add_argument("--radius", type=float, default=1.5,
                    help="the circle's radius (m; phase 8's: 1.5)")
    ap.add_argument("--frames", type=int, default=440)
    ap.add_argument("--turns", type=float, default=1.1)
    ap.add_argument("--timeline", action="store_true",
                    help="add each frame's state, inliers, local-map "
                    "points visible and keyframe count")
    ap.add_argument("--detections", action="store_true",
                    help="list the loop detections of the last quarter")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; no GPU raises)")
    args = ap.parse_args(argv)
    cam = Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640,
                 height=480)
    imgs, R_cw, t_cw = synthetic.render_room_loop(
        cam, n_frames=args.frames, turns=args.turns, radius=args.radius)
    angles = 2 * np.pi * args.turns * np.arange(args.frames) / max(
        args.frames - 1, 1)
    gt = -(np.swapaxes(R_cw, -1, -2) @ t_cw[..., None])[..., 0]
    n_frames = len(imgs)
    half, late, revisit = (int(np.argmin(np.abs(angles - f * np.pi)))
                           for f in (1.0, 1.5, 2.0))
    dev = resolve_device(args.device)
    f0, f1 = (extract_orb(torch.as_tensor(imgs[i], device=dev),
                          OrbConfig(n_features=1024)) for i in (0, revisit))
    idx, _ = matcher.search_brute_force(
        H.to_signs(f0["desc_bits"]), f0["valid"],
        H.to_signs(f1["desc_bits"]), f1["valid"])
    print(json.dumps(dict(frames=(0, revisit), radius=args.radius,
                          turns=args.turns,
                          bf_matches=int((idx >= 0).sum()))), flush=True)
    for run in range(args.runs):
        slam = SlamSystem(cam, SlamConfig(
            async_mapping=args.async_mapping,
            enable_loop_closing=not args.no_loops), device=args.device)
        lc = slam.tracking.loop_closer
        detections, rebound, r12_deg, r12_true = [], [], [], []
        if lc is not None:
            if args.observe:
                lc._compute_sim3 = lambda kf, cand, stats=None: None
            detect = lc.kfdb.detect_loop_candidates

            def watched(kf, bow=None, s=slam.store, detect=detect):
                cands = detect(kf, bow)
                frame = int(s.kf_frame_id[kf])
                if frame < half:
                    return cands
                covis = set(int(k) for k in s.covisible_keyframes(kf))
                early = [int(s.kf_frame_id[k]) for k in s.keyframe_ids()
                         if s.kf_frame_id[k] <= EARLY and int(k) in covis]
                if early and not rebound:
                    rebound.append(frame)
                if frame >= late:
                    detections.append(dict(
                        frame=frame,
                        cands=[int(s.kf_frame_id[c]) for c in cands],
                        early_covisible=early))
                return cands
            lc.kfdb.detect_loop_candidates = watched
            correct = lc._correct_loop

            def checked(kf, cand, sim3, *a, s=slam.store, correct=correct):
                # the accepted S12's rotation against the map's own
                # relative rotation of the two keyframes (degrees)
                f1, f2 = int(s.kf_frame_id[kf]), int(s.kf_frame_id[cand])
                for R_ref, out in ((s.kf_R[kf] @ s.kf_R[cand].T, r12_deg),
                                   (R_cw[f1] @ R_cw[f2].T, r12_true)):
                    c = (np.trace(sim3["R12"] @ R_ref.T) - 1.0) / 2.0
                    out.append(round(float(
                        np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))), 2))
                return correct(kf, cand, sim3, *a)
            lc._correct_loop = checked
        slam.precompile()
        t0 = time.perf_counter()
        poses = slam.track_monocular_batch(
            list(imgs), timestamps=[i / 30.0 for i in range(n_frames)],
            chunk=8)
        slam.shutdown()
        wall = time.perf_counter() - t0
        fid = slam.store.kf_frame_id
        ts_k, _, t_k = slam.keyframe_trajectory()
        idx_k = np.round(np.asarray(ts_k) * 30.0).astype(int)
        stats = [] if lc is None else lc.stats_log
        attempts = [
            dict(frames=(int(fid[st["kf"]]), int(fid[st["cand"]])),
                 **{k: v for k, v in st.items()
                    if k in ("bf_matches", "ransac_inliers", "pairs",
                             "sim3_inliers", "n_total")})
            for st in stats]
        out = dict(
            run=run, async_mapping=args.async_mapping,
            loops=[] if lc is None else
            [(int(fid[lp["kf"]]), int(fid[lp["cand"]])) for lp in lc.loops],
            r12_vs_map_deg=r12_deg, r12_vs_truth_deg=r12_true,
            rebound_at=rebound[0] if rebound else None,
            keyframes=slam.store.n_keyframes(),
            tracked=sum(p is not None for p in poses),
            ate_keyframes=float(ate_rmse(t_k, gt[idx_k], with_scale=True)),
            wall_s=round(wall, 2),
            bf_matches_max=max((a.get("bf_matches", 0) for a in attempts),
                               default=0),
            sim3_inliers=sorted({a["sim3_inliers"] for a in attempts
                                 if "sim3_inliers" in a}),
            attempts=attempts)
        if args.detections:
            out["detections"] = detections
        if args.timeline:
            out["timeline"] = " ".join(
                f"{r['frame_id']}:{r['state'][0]}{r['n_inliers']}/"
                f"{r.get('local_visible', 0)}k{r['n_kf']}"
                + ("H" if r.get("kf_hard") else "K" if "t_kf_ms" in r
                   else "") for r in slam.tracking.metrics)
        print(json.dumps(out), flush=True)
        del slam
        if dev.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
