"""Where the error of a trajectory lies, frame by frame, on the first
`--frames` frames of chip_smoke.py phase 8's room loop
(synthetic.render_room_loop, 440 frames rendered, radius 1.5 m), through
SlamConfig(enable_loop_closing=False) (sync) or SlamConfig(async_mapping=
True, enable_loop_closing=False) at full width and
track_monocular_batch(chunk=8).

Every position is compared with the truth under ONE sim3: the one that
fits the keyframe trajectory (the map's quality) to the truth. Per frame:
its state and inliers, the source frame of the keyframe its record is
anchored to, and the error of three positions: the pose the system
returned (the record's R/t), the exported pose (SlamSystem.
frame_trajectory: the record's pose relative to its reference keyframe,
composed with that keyframe's final pose; what save_trajectory_tum
writes), and the reference keyframe's final pose. The last line is a JSON
summary: the keyframe ATE, the exported ATE (its own sim3, as run_eval
and chip_smoke score it), the worst frames and the wall time.

With --loop-closing the run closes loops (SlamConfig()'s loop closer;
--frames 440 walks the whole room). The summary then also holds, for each
global BA the loop closer launched, the keyframe ATE of the keyframes it
optimised: as gathered (after the essential graph), after the BA's 20
iterations, and after 60: how far the map's accuracy is the BA's optimum
rather than its iteration count.

  python -m ar_orbslam2_tpu_torch.eval.room_trajectory [--frames 120] \\
      [--async-mapping] [--loop-closing] [--device cpu] [--threads 3]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..core.camera import Camera
from ..data import synthetic
from ..eval.ate import align_umeyama, ate_rmse
from ..mapping.global_ba import dispatch_global_ba, read_result
from ..system.slam import SlamConfig, SlamSystem


def _centre(R_cw, t_cw):
    return -(np.asarray(R_cw, np.float64).T @ np.asarray(t_cw, np.float64))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--async-mapping", action="store_true")
    ap.add_argument("--loop-closing", action="store_true",
                    help="close loops, and measure each global BA's map")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; no GPU raises)")
    ap.add_argument("--threads", type=int, default=0,
                    help="torch intra-op threads on the CPU (0: torch's)")
    args = ap.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)
    cam = Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640,
                 height=480)
    imgs, R_cw, t_cw = synthetic.render_room_loop(cam, n_frames=440)
    n = args.frames
    imgs, R_cw, t_cw = imgs[:n], R_cw[:n], t_cw[:n]
    gt = -(np.swapaxes(R_cw, -1, -2) @ t_cw[..., None])[..., 0]
    slam = SlamSystem(cam, SlamConfig(async_mapping=args.async_mapping,
                                      enable_loop_closing=args.loop_closing),
                      device=args.device)
    gba_problems = []       # (gathered problem, its keyframes' timestamps)
    if args.loop_closing:
        gba = slam.tracking.loop_closer.gba
        launch = gba.launch

        def launch_and_keep():
            launch()
            g = gba._job.g
            gba_problems.append(
                (g, slam.store.kf_timestamp[g["kf_arr"][:g["n_kf"]]].copy()))
        gba.launch = launch_and_keep
    t0 = time.perf_counter()
    slam.track_monocular_batch(list(imgs),
                               timestamps=[i / 30.0 for i in range(n)],
                               chunk=8)
    slam.shutdown()
    wall = time.perf_counter() - t0

    s = slam.store
    ts_k, _, t_k = slam.keyframe_trajectory()
    kf_frame = np.round(np.asarray(ts_k) * 30.0).astype(int)
    sc, R, t = align_umeyama(t_k, gt[kf_frame])

    def err(c, f):
        return float(np.linalg.norm(sc * R @ c + t - gt[f]))

    ts, _, t_wc = slam.frame_trajectory()
    exp_frame = np.round(np.asarray(ts) * 30.0).astype(int)
    exported = {int(f): err(c, f) for f, c in zip(exp_frame, t_wc)}
    worst = {}
    for rec in slam.tracking.metrics:
        f = int(round(rec["timestamp"] * 30.0))
        row = dict(frame=f, state=rec["state"], inliers=rec["n_inliers"])
        if "R" in rec and rec["ok"]:
            row["returned"] = round(err(_centre(rec["R"], rec["t"]), f), 4)
            row["exported"] = round(exported[f], 4)
            ref = rec.get("ref_kf", -1)
            if ref >= 0 and s.slot_is(ref, rec["ref_seq"]):
                fk = int(s.kf_frame_id[ref])
                row["ref_kf_frame"] = fk
                row["ref_kf"] = round(err(_centre(s.kf_R[ref], s.kf_t[ref]),
                                          fk), 4)
            for k in ("returned", "exported"):
                if row[k] > worst.get(k, (0.0, -1))[0]:
                    worst[k] = (row[k], f)
        print(json.dumps(row), flush=True)
    gba_maps = []
    for g, ts_g in gba_problems:
        f_g = np.round(ts_g * 30.0).astype(int)

        def kf_ate(R_cw_g, t_cw_g):
            c = -(np.swapaxes(R_cw_g[:len(f_g)], -1, -2)
                  @ t_cw_g[:len(f_g), :, None])[..., 0]
            return round(float(ate_rmse(c, gt[f_g], with_scale=True)), 5)
        row = dict(keyframes=len(f_g),
                   ate_gathered=kf_ate(g["cam_R"], g["cam_t"]))
        for iters in (20, 60):
            R_g, t_g, _, cost = read_result(dispatch_global_ba(
                g, cam, n_iters=iters, distributed=False,
                device=slam.device))
            row[f"ate_ba_{iters}"] = kf_ate(R_g, t_g)
            row[f"cost_ba_{iters}"] = round(cost, 1)
        gba_maps.append(row)
    print(json.dumps(dict(
        frames=n, async_mapping=args.async_mapping,
        loop_closing=args.loop_closing,
        loops=[] if not args.loop_closing else [
            (int(lp["kf"]), int(lp["cand"]))
            for lp in slam.tracking.loop_closer.loops],
        global_ba_maps=gba_maps,
        keyframes=s.n_keyframes(), keyframe_frames=kf_frame.tolist(),
        ate_keyframes=round(float(ate_rmse(t_k, gt[kf_frame],
                                           with_scale=True)), 5),
        ate_exported=round(float(ate_rmse(t_wc, gt[exp_frame],
                                          with_scale=True)), 5),
        worst_returned=worst.get("returned"),
        worst_exported=worst.get("exported"),
        rescue_keyframes_dropped=slam.tracking.n_rescue_dropped,
        wall_s=round(wall, 2), device=str(slam.device))), flush=True)


if __name__ == "__main__":
    main()
