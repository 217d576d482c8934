"""Plain float64 NumPy geometry for judging poses and maps against the
truth: camera undistortion, the similarity that best maps a monocular
trajectory onto the truth, and the errors measured after it."""
from __future__ import annotations

import numpy as np


def distort_normalized(cam, x, y):
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return xd, yd


def distort_px(cam, uv):
    """Undistorted pixels (N, 2) -> the raw pixels the camera records."""
    uv = np.asarray(uv, np.float64)
    x = (uv[:, 0] - cam.cx) / cam.fx
    y = (uv[:, 1] - cam.cy) / cam.fy
    xd, yd = distort_normalized(cam, x, y)
    return np.stack([xd * cam.fx + cam.cx, yd * cam.fy + cam.cy], -1)


def project_so3(M):
    U, _, Vt = np.linalg.svd(M)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    return U @ D @ Vt


def camera_frames(R_cw, t_cw):
    """World-to-camera poses -> (R_wc (N, 3, 3), centres (N, 3))."""
    R_cw = np.asarray(R_cw, np.float64)
    t_cw = np.asarray(t_cw, np.float64)
    R_wc = np.swapaxes(R_cw, -1, -2)
    return R_wc, -np.einsum("nij,nj->ni", R_wc, t_cw)


def align(R_wc_true, c_true, R_wc_est, c_est):
    """The similarity x -> s R x + t that maps the estimate's world onto
    the truth's: R from the orientations (the rotation nearest to
    sum_i R_true_i R_est_i^T), then s and t from the centres by least
    squares. Well posed for a straight path, where centres alone leave
    the rotation about it free."""
    R = project_so3(np.einsum("nij,nkj->ik", R_wc_true, R_wc_est))
    mt, me = c_true.mean(0), c_est.mean(0)
    de = (c_est - me) @ R.T
    s = float((de * (c_true - mt)).sum() / max((de * de).sum(), 1e-300))
    return s, R, mt - s * me @ R.T


def apply(sim, x):
    s, R, t = sim
    return s * np.asarray(x, np.float64) @ R.T + t


def ate(sim, c_true, c_est):
    """RMS distance between true and mapped centres."""
    d = apply(sim, c_est) - c_true
    return float(np.sqrt((d * d).sum(-1).mean()))


def rpe(sim, c_true, c_est):
    """RMS error of the mapped frame-to-frame displacement (the relative
    pose error's translation at a step of one frame)."""
    de = np.diff(apply(sim, c_est), axis=0)
    dt = np.diff(c_true, axis=0)
    d = de - dt
    return float(np.sqrt((d * d).sum(-1).mean()))


def rotation_error_deg(sim, R_wc_true, R_wc_est):
    """RMS angle between each true orientation and the mapped estimate."""
    _, R, _ = sim
    M = np.einsum("nji,jk,nkl->nil", R_wc_true, R, R_wc_est)
    cos = np.clip((np.trace(M, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    ang = np.degrees(np.arccos(cos))
    return float(np.sqrt((ang * ang).mean()))
