"""Trajectory evaluation: ATE (absolute trajectory error) and RPE.

The reference has no built-in evaluator — users run the external TUM
benchmark scripts (SURVEY.md §4). We build it in: Umeyama Sim(3)/SE(3)
alignment + RMSE, matching the semantics of TUM's evaluate_ate.py so the
BASELINE.md numbers are directly comparable.
"""
from __future__ import annotations

import numpy as np


def align_umeyama(est, gt, with_scale=True):
    """Least-squares similarity aligning est -> gt (both (N, 3)).

    Returns (s, R, t) with gt ≈ s * R @ est + t. with_scale=True for
    monocular (scale-free) trajectories, False for stereo/RGB-D.
    """
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    xe = est - mu_e
    xg = gt - mu_g
    cov = xg.T @ xe / len(est)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_e = (xe ** 2).sum() / len(est)
    s = float(np.trace(np.diag(D) @ S) / var_e) if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est_t, gt_t, with_scale=True):
    """Absolute trajectory error RMSE after Umeyama alignment (meters)."""
    s, R, t = align_umeyama(est_t, gt_t, with_scale)
    aligned = (s * (R @ np.asarray(est_t, np.float64).T)).T + t
    err = np.linalg.norm(aligned - np.asarray(gt_t, np.float64), axis=1)
    return float(np.sqrt((err ** 2).mean()))


def associate(ts_a, ts_b, max_dt=0.02):
    """Greedy nearest-timestamp association (parity with TUM associate.py,
    reference: Examples/RGB-D/associate.py). Returns index pairs."""
    ts_a = np.asarray(ts_a)
    ts_b = np.asarray(ts_b)
    pairs = []
    used_b = set()
    for i, ta in enumerate(ts_a):
        j = int(np.argmin(np.abs(ts_b - ta)))
        if abs(ts_b[j] - ta) < max_dt and j not in used_b:
            pairs.append((i, j))
            used_b.add(j)
    return pairs


def rpe(R_est, t_est, R_gt, t_gt, delta=1):
    """Relative pose error over a frame delta.

    Returns (trans_rmse, rot_rmse_deg). Poses are camera-to-world.
    """
    R_est = np.asarray(R_est, np.float64)
    t_est = np.asarray(t_est, np.float64)
    R_gt = np.asarray(R_gt, np.float64)
    t_gt = np.asarray(t_gt, np.float64)
    n = len(R_est) - delta
    terr, rerr = [], []
    for i in range(n):
        # relative motions
        dR_e = R_est[i].T @ R_est[i + delta]
        dt_e = R_est[i].T @ (t_est[i + delta] - t_est[i])
        dR_g = R_gt[i].T @ R_gt[i + delta]
        dt_g = R_gt[i].T @ (t_gt[i + delta] - t_gt[i])
        E_R = dR_g.T @ dR_e
        terr.append(np.linalg.norm(dt_e - dt_g))
        c = np.clip((np.trace(E_R) - 1) / 2, -1, 1)
        rerr.append(np.degrees(np.arccos(c)))
    return (float(np.sqrt(np.mean(np.square(terr)))),
            float(np.sqrt(np.mean(np.square(rerr)))))
