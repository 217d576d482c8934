"""One-command dataset runbook: run -> save trajectories -> ATE/RPE vs
ground truth -> gate against BASELINE.md -> exit nonzero on miss.

Port of ar_orbslam2_tpu/apps/run_eval.py. Parity: the reference's manual
evaluation flow (example binary + external evaluate_ate.py + KITTI
devkit), folded into one command:

  python -m ar_orbslam2_tpu_torch.apps.run_eval tum <settings> <seq_dir> \
      [--gt groundtruth.txt] [--gate-ate 0.05] [--out prefix]
  python -m ar_orbslam2_tpu_torch.apps.run_eval kitti <settings> <seq_dir> \
      [--stereo] [--gt poses.txt] [--gate-ate 1.3]

Ground truth defaults: TUM <seq_dir>/groundtruth.txt (TUM format),
KITTI <seq_dir>/poses.txt (KITTI format). Gates default to the
BASELINE.md bounds x2 (mono scale ambiguity + synthetic-free tuning);
pass --gate-ate to tighten to paper bounds. Runs on the GPU;
``--device cpu --no-precompile`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

# BASELINE.md ATE RMSE bounds (meters) — reference ORB-SLAM2 paper values
BASELINE_ATE = {
    "tum": 0.016,      # fr1 bound class (0.009-0.016 m)
    "tum-rgbd": 0.016,
    "kitti": 1.3,      # KITTI 00 stereo w/ loop closure
    "euroc": 0.08,
}


def run(argv=None) -> dict:
    """Run, evaluate and gate; returns dict(code, ate, rpe_t, rpe_r,
    n_eval, slam, times), code being the CLI's exit code."""
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset", choices=["tum", "kitti", "tum-rgbd", "euroc"])
    ap.add_argument("settings")
    ap.add_argument("seq_dir")
    ap.add_argument("--stereo", action="store_true")
    ap.add_argument("--gt", default=None,
                    help="ground-truth file (default: dataset layout)")
    ap.add_argument("--gate-ate", type=float, default=None,
                    help="fail if ATE RMSE exceeds this (m); default = "
                         "2x the BASELINE.md paper bound")
    ap.add_argument("--out", default="eval")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--no-loops", action="store_true")
    ap.add_argument("--no-precompile", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; no GPU raises)")
    args = ap.parse_args(argv)

    from ..eval.ate import associate, ate_rmse, rpe
    from ..eval.trajectory import load_kitti, load_tum
    from . import run_dataset

    # 1. run the sequence through the standard dataset CLI path
    run_args = [args.dataset, args.settings, args.seq_dir,
                "--out", args.out, "--chunk", str(args.chunk),
                "--metrics", args.out + "_metrics.jsonl"]
    if args.stereo:
        run_args.append("--stereo")
    if args.max_frames:
        run_args += ["--max-frames", str(args.max_frames)]
    if args.no_loops:
        run_args.append("--no-loops")
    if args.no_precompile:
        run_args.append("--no-precompile")
    if args.device:
        run_args += ["--device", args.device]
    slam, times = run_dataset.main(run_args)
    result = dict(code=2, ate=None, rpe_t=None, rpe_r=None, n_eval=0,
                  slam=slam, times=times)

    # 2. load estimate + ground truth
    if args.dataset == "kitti":
        gt_path = args.gt or os.path.join(args.seq_dir, "poses.txt")
        R_gt, t_gt = load_kitti(gt_path)
        R_est, t_est = load_kitti(args.out + "_kitti.txt")
        n = min(len(t_gt), len(t_est))
        R_gt, t_gt, R_est, t_est = R_gt[:n], t_gt[:n], R_est[:n], t_est[:n]
    else:
        gt_path = args.gt or os.path.join(args.seq_dir, "groundtruth.txt")
        ts_gt, R_gt, t_gt = load_tum(gt_path)
        ts_est, R_est, t_est = load_tum(args.out + "_tum.txt")
        pairs = associate(ts_est, ts_gt)
        if len(pairs) < 10:
            print(f"EVAL FAIL: only {len(pairs)} associated frames")
            return result
        ia = np.array([p[0] for p in pairs])
        ib = np.array([p[1] for p in pairs])
        R_est, t_est = R_est[ia], t_est[ia]
        R_gt, t_gt = R_gt[ib], t_gt[ib]

    # 3. ATE (Umeyama-aligned; scale solved for monocular) + RPE
    mono = args.dataset in ("tum", "euroc", "kitti") and not args.stereo
    ate = ate_rmse(t_est, t_gt, with_scale=mono)
    rpe_t, rpe_r = rpe(R_est, t_est, R_gt, t_gt)
    print(f"frames evaluated: {len(t_est)}")
    print(f"ATE RMSE: {ate:.4f} m (scale {'solved' if mono else 'fixed'})")
    print(f"RPE: {rpe_t:.4f} m / {rpe_r:.3f} deg per frame-step")

    # 4. gate
    gate = args.gate_ate
    if gate is None:
        gate = 2.0 * BASELINE_ATE[args.dataset]
    status = "PASS" if ate <= gate else "FAIL"
    print(f"gate: ATE {ate:.4f} <= {gate:.4f} m -> {status}")
    result.update(code=0 if status == "PASS" else 1, ate=float(ate),
                  rpe_t=float(rpe_t), rpe_r=float(rpe_r), n_eval=len(t_est))
    return result


def main(argv=None):
    sys.exit(run(argv)["code"])


if __name__ == "__main__":
    main()
