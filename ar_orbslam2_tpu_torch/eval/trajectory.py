"""Trajectory file IO with reference format parity.

TUM format (timestamp tx ty tz qx qy qz qw) matches the reference's
System::SaveKeyFrameTrajectoryTUM / SaveTrajectoryTUM (src/System.cc:≈480,
≈540); KITTI format (12 numbers of the 3x4 Twc row-major) matches
System::SaveTrajectoryKITTI (src/System.cc:≈590). Poses handled here are
camera-to-world (Twc), as in the reference's exports.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import lie


def save_tum(path, timestamps, R_wc, t_wc):
    """Write TUM-format trajectory. R_wc: (N,3,3), t_wc: (N,3)."""
    q = lie.rot_to_quat(torch.as_tensor(np.asarray(R_wc, np.float32))).numpy()
    t = np.asarray(t_wc)
    with open(path, "w") as f:
        for i, ts in enumerate(timestamps):
            f.write(f"{ts:.6f} {t[i,0]:.7f} {t[i,1]:.7f} {t[i,2]:.7f} "
                    f"{q[i,0]:.7f} {q[i,1]:.7f} {q[i,2]:.7f} {q[i,3]:.7f}\n")


def save_kitti(path, R_wc, t_wc):
    """Write KITTI-format trajectory (3x4 Twc row-major per line)."""
    R = np.asarray(R_wc)
    t = np.asarray(t_wc)
    with open(path, "w") as f:
        for i in range(len(R)):
            P = np.concatenate([R[i], t[i][:, None]], axis=1).reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in P) + "\n")

