"""Robust losses as IRLS weights + chi-square gates.

Port of ar_orbslam2_tpu/core/robust.py: g2o's Huber kernel (deltas
sqrt(5.991) mono / sqrt(7.815) stereo, src/Optimizer.cc) as a per-residual
IRLS weight, so the normal-equation assembly stays a pure einsum.
"""
from __future__ import annotations

import torch

# chi-square 95% quantiles used throughout the reference as gates
CHI2_2DOF = 5.991   # monocular edges (2-dof reprojection)
CHI2_3DOF = 7.815   # stereo edges (3-dof: u, v, u_right)


def huber_weight(chi2, delta2):
    """IRLS weight for the Huber kernel given squared error and delta^2:
    1 for chi2 <= delta2, else delta / sqrt(chi2)."""
    chi2 = torch.clamp(chi2, min=1e-12)
    return torch.where(chi2 <= delta2, torch.ones_like(chi2),
                       torch.sqrt(delta2 / chi2))

