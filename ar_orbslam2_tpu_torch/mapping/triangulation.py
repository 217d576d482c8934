"""New-landmark creation: epipolar search + gated triangulation.

Port of ar_orbslam2_tpu/mapping/triangulation.py (the reference's
LocalMapping::CreateNewMapPoints and ORBmatcher::SearchForTriangulation):
the full keypoint x keypoint Hamming matrix masked with the epipolar band,
then every triangulation gate (parallax / depth / reprojection / scale
consistency — the reference's thresholds) as a batched, masked computation.
One call handles one keyframe pair.
"""
from __future__ import annotations

import torch

from ..core import camera as cam_mod
from ..core import geometry
from ..ops import hamming as H

INVALID = H.DESC_BITS + 1
CHI2_2DOF = 5.991
CHI2_1DOF = 3.84


def _K(cam, ref):
    return torch.as_tensor(cam.K, device=ref.device)


def epipolar_search(cam, R1, t1, R2, t2,
                    uv1, signs1, oct1, free1,
                    uv2, signs2, oct2, free2,
                    angles1=None, angles2=None,
                    scale_factor=1.2, th=H.TH_LOW):
    """Match unbound features of KF1 against KF2 along epipolar lines.

    Parity: ORBmatcher::SearchForTriangulation — descriptor distance
    < TH_LOW, point-to-epipolar-line distance < 3.84 sigma^2 (octave of
    the KF2 keypoint), epipole-proximity rejection, rotation consistency,
    mutual best. `free*` masks features not yet bound to a landmark.

    Returns (idx (N1,) int32 into KF2 or -1, dist (N1,)).
    """
    R12 = R2 @ R1.T
    t12 = t2 - (R12 @ t1[..., None])[..., 0]
    K = _K(cam, R1)
    F12 = geometry.fundamental_from_pose(R12, t12, K, K)

    D = H.hamming_matrix(signs1, signs2, free1, free2, invalid_dist=INVALID)
    ep_sq = geometry.epipolar_sq_dist(F12, uv1[:, None, :], uv2[None, :, :])
    sigma2_2 = scale_factor ** (2.0 * oct2.to(torch.float32))
    in_band = ep_sq < CHI2_1DOF * sigma2_2[None, :]
    # epipole of camera 1 in image 2: project camera-1 center into KF2
    c1w = geometry.camera_center(R1, t1)
    e2 = cam_mod.project(cam, (R2 @ c1w) + t2)
    d_epi_sq = ((uv2 - e2[None, :]) ** 2).sum(-1)
    far_from_epipole = d_epi_sq >= 100.0 * scale_factor ** oct2.to(
        torch.float32)
    mask = in_band & far_from_epipole[None, :]
    D = torch.where(mask, D, torch.full_like(D, INVALID))
    idx, dist = H.best_match(D, th=th, nn_ratio=1.0)
    idx_back, _ = H.best_match(D.T, th=th, nn_ratio=1.0)
    idx = H.mutual_filter(idx, idx_back)
    if angles1 is not None and angles2 is not None:
        idx = H.rotation_consistency(angles1, angles2, idx)
    return idx, dist


def triangulate_candidates(cam, R1, t1, R2, t2,
                           uv1, oct1, uv2, oct2, idx,
                           scale_factor=1.2,
                           cos_parallax_max=0.9998):
    """Triangulate matched pairs and apply the reference's creation gates:
    ray-parallax cos < 0.9998, positive depth in both views, reprojection
    chi2 < 5.991 sigma^2 per view, and scale consistency (distance ratio
    within 1.5*scaleFactor of the octave scale ratio).

    Args:
      idx: (N1,) match into KF2 per KF1 feature (-1 = none).
    Returns dict(xw (N1,3), good (N1,) bool, cos_parallax).
    """
    f32 = torch.float32
    matched = idx >= 0
    j = torch.clamp(idx, min=0).long()
    uv2m = uv2[j]
    oct2m = oct2[j]

    Kinv = torch.linalg.inv(_K(cam, R1))
    ones = torch.ones(uv1.shape[:-1] + (1,), dtype=uv1.dtype,
                      device=uv1.device)
    xn1 = (torch.cat([uv1, ones], -1) @ Kinv.T)[..., :2]
    xn2 = (torch.cat([uv2m, ones], -1) @ Kinv.T)[..., :2]

    # parallax between viewing rays (world frame)
    r1 = torch.cat([xn1, ones], -1) @ R1          # = R1^T xn1
    r2 = torch.cat([xn2, ones], -1) @ R2
    cosp = (r1 * r2).sum(-1) / torch.clamp(
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1),
        min=1e-9)

    xw = geometry.triangulate_linear(R1, t1, R2, t2, xn1, xn2)
    z1 = geometry.depth_in_view(R1, t1, xw)
    z2 = geometry.depth_in_view(R2, t2, xw)

    uv1_hat = cam_mod.project(cam, (xw @ R1.T) + t1)
    uv2_hat = cam_mod.project(cam, (xw @ R2.T) + t2)
    s2_1 = scale_factor ** (2.0 * oct1.to(f32))
    s2_2 = scale_factor ** (2.0 * oct2m.to(f32))
    e1 = ((uv1_hat - uv1) ** 2).sum(-1)
    e2 = ((uv2_hat - uv2m) ** 2).sum(-1)
    reproj_ok = (e1 < CHI2_2DOF * s2_1) & (e2 < CHI2_2DOF * s2_2)

    c1 = geometry.camera_center(R1, t1)
    c2 = geometry.camera_center(R2, t2)
    d1 = torch.linalg.norm(xw - c1, dim=-1)
    d2 = torch.linalg.norm(xw - c2, dim=-1)
    ratio_dist = d2 / torch.clamp(d1, min=1e-9)
    ratio_oct = (scale_factor ** oct1.to(f32)
                 / scale_factor ** oct2m.to(f32))
    rf = 1.5 * scale_factor
    scale_ok = (ratio_dist * rf >= ratio_oct) & (ratio_dist <= ratio_oct * rf)

    good = (matched & (cosp > 0) & (cosp < cos_parallax_max)
            & (z1 > 0) & (z2 > 0) & reproj_ok & scale_ok
            & torch.isfinite(xw).all(-1))
    return dict(xw=xw, good=good, cos_parallax=cosp)
