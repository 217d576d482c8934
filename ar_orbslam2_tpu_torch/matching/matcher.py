"""Descriptor search — dense masked Hamming searches.

Port of ar_orbslam2_tpu/matching/matcher.py. Where the reference walks
per-keypoint grid cells (Frame::GetFeaturesInArea), every query is tested
against every keypoint with the spatial window / octave / threshold / ratio
gates as masks. The windowed searches go through the hand kernel
(ops/cuda_hamming.fused_windowed_top2); the unwindowed brute-force search
is a plain f32 matmul, as it was plain XLA in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import camera as cam_mod
from ..ops import hamming as H
from ..ops.cuda_hamming import fused_windowed_top2

INVALID = H.DESC_BITS + 1


def windowed_match(query_uv, query_signs, query_valid, radius,
                   kp_uv, kp_signs, kp_octave, kp_valid,
                   octave_lo=None, octave_hi=None,
                   th=H.TH_HIGH, nn_ratio=1.0, mutual=True):
    """Generic windowed descriptor search.

    For each query find the best target keypoint with |du|,|dv| <= radius,
    octave in [lo, hi], Hamming <= th, passing the NN-ratio test; optionally
    mutual-best. Descriptors may be ±1 int8 signs or packed uint8.

    Returns (idx (N,) int32 — matched keypoint or -1, dist (N,) int32).
    """
    n = query_uv.shape[0]
    dev = query_uv.device
    if torch.is_tensor(radius):
        r = radius.to(torch.float32).expand(n).contiguous()
    else:       # torch.full: a host-made tensor would cost a stream sync
        r = torch.full((n,), float(radius), dtype=torch.float32, device=dev)
    if octave_lo is None:
        octave_lo = torch.full((n,), -(10 ** 6), dtype=torch.int32, device=dev)
        octave_hi = torch.full((n,), 10 ** 6, dtype=torch.int32, device=dev)
    return fused_windowed_top2(
        query_signs, query_uv.contiguous(), r,
        octave_lo.to(torch.int32).contiguous(),
        octave_hi.to(torch.int32).contiguous(), query_valid.contiguous(),
        kp_signs, kp_uv.contiguous(), kp_octave.to(torch.int32).contiguous(),
        kp_valid.contiguous(), th=th, nn_ratio=nn_ratio, mutual=mutual)


def search_for_initialization(uv1, signs1, valid1, uv2, signs2, valid2,
                              window=100.0, th=H.TH_LOW, nn_ratio=0.9,
                              angles1=None, angles2=None):
    """Frame-frame search for monocular initialization.

    Parity: ORBmatcher::SearchForInitialization — window search around the
    same location, TH_LOW, ratio 0.9, rotation consistency, mutual-best.
    """
    octave0 = torch.zeros(uv1.shape[0], dtype=torch.int32, device=uv1.device)
    idx, dist = windowed_match(
        uv1, signs1, valid1, window, uv2, signs2,
        kp_octave=octave0, kp_valid=valid2,
        th=th, nn_ratio=nn_ratio, mutual=True)
    if angles1 is not None and angles2 is not None:
        idx = H.rotation_consistency(angles1, angles2, idx)
    return idx, dist


def project_map_points(cam, R_cw, t_cw, xw, normals, dmin, dmax, valid,
                       n_levels=8, scale_factor=1.2, view_cos_limit=0.5):
    """Frustum + view-angle + distance gate for map points, with scale
    prediction. Parity: Frame::isInFrustum + MapPoint::PredictScale.

    Returns dict(uv, pred_octave, visible, view_cos).
    """
    xc = (R_cw @ xw[..., None])[..., 0] + t_cw
    z = xc[..., 2]
    uv = cam_mod.project(cam, xc)
    in_img = ((uv[..., 0] >= 0) & (uv[..., 0] < cam.width)
              & (uv[..., 1] >= 0) & (uv[..., 1] < cam.height))
    ow = -(R_cw.transpose(-1, -2) @ t_cw[..., None])[..., 0]   # cam center
    po = xw - ow
    dist = torch.linalg.norm(po, dim=-1)
    in_range = (dist >= 0.8 * dmin) & (dist <= 1.2 * dmax)
    view_cos = (po * normals).sum(-1) / torch.clamp(dist, min=1e-9)
    # predicted pyramid level from distance (PredictScale)
    ratio = torch.clamp(dmax, min=1e-9) / torch.clamp(dist, min=1e-9)
    # log(scale) in f32, as jnp.log(scale_factor) gives it: the ceil below
    # sits on integer boundaries, so the divisor must match to the bit
    log_s = float(np.log(np.float32(scale_factor)))
    lvl = torch.ceil(torch.log(torch.clamp(ratio, min=1e-9))
                     / log_s).to(torch.int32)
    lvl = torch.clamp(lvl, 0, n_levels - 1)
    visible = valid & (z > 0) & in_img & in_range & (view_cos > view_cos_limit)
    return dict(uv=uv, pred_octave=lvl, visible=visible, view_cos=view_cos)


def search_local_points(cam, R_cw, t_cw, mp_xw, mp_signs, mp_normals,
                        mp_dmin, mp_dmax, mp_valid,
                        kp_uv, kp_signs, kp_octave, kp_valid,
                        th_radius=4.0, th=H.TH_HIGH, nn_ratio=0.8,
                        n_levels=8, scale_factor=1.2):
    """Project local-map points into the frame and window-search.

    Parity: Tracking::SearchLocalPoints -> ORBmatcher::SearchByProjection:
    radius = (2.5 if viewCos > 0.998 else th_radius) * scale^level, octave
    window [lvl-1, lvl]. Returns (kp match idx per map point (-1 none),
    visible mask, dist).
    """
    proj = project_map_points(cam, R_cw, t_cw, mp_xw, mp_normals,
                              mp_dmin, mp_dmax, mp_valid,
                              n_levels=n_levels, scale_factor=scale_factor)
    scale_pow = scale_factor ** proj["pred_octave"].to(torch.float32)
    base_r = torch.where(proj["view_cos"] > 0.998, 2.5, th_radius)
    radius = base_r * scale_pow
    idx, dist = windowed_match(
        proj["uv"], mp_signs, proj["visible"], radius,
        kp_uv, kp_signs, kp_octave, kp_valid,
        octave_lo=proj["pred_octave"] - 1, octave_hi=proj["pred_octave"],
        th=th, nn_ratio=nn_ratio, mutual=True)
    return idx, proj["visible"], dist


def search_by_projection_frame(cam, R_cw, t_cw, last_xw, last_signs,
                               last_octave, last_valid,
                               kp_uv, kp_signs, kp_octave, kp_valid,
                               th_radius=7.0, scale_factor=1.2,
                               th=H.TH_HIGH, angles_q=None, angles_kp=None):
    """Motion-model search: project the last frame's map points with the
    predicted pose, window radius th * scale^last_octave, octave ±1.
    Parity: ORBmatcher::SearchByProjection(Frame&, Frame&, th, bMono).
    """
    xc = (R_cw @ last_xw[..., None])[..., 0] + t_cw
    uv = cam_mod.project(cam, xc)
    vis = (xc[..., 2] > 0.05) & last_valid
    vis &= ((uv[..., 0] >= 0) & (uv[..., 0] < cam.width)
            & (uv[..., 1] >= 0) & (uv[..., 1] < cam.height))
    radius = th_radius * scale_factor ** last_octave.to(torch.float32)
    idx, dist = windowed_match(
        uv, last_signs, vis, radius,
        kp_uv, kp_signs, kp_octave, kp_valid,
        octave_lo=last_octave - 1, octave_hi=last_octave + 1,
        th=th, nn_ratio=0.9, mutual=True)
    if angles_q is not None and angles_kp is not None:
        idx = H.rotation_consistency(angles_q, angles_kp, idx)
    return idx, dist


def search_brute_force(signs_a, valid_a, signs_b, valid_b,
                       th=H.TH_LOW, nn_ratio=0.75, mutual=True):
    """Unwindowed descriptor-only search (the SearchByBoW replacement):
    full Hamming matrix, TH_LOW + 0.75 ratio, mutual-best."""
    D = H.hamming_matrix(signs_a, signs_b, valid_a, valid_b,
                         invalid_dist=INVALID)
    idx, dist = H.best_match(D, th=th, nn_ratio=nn_ratio)
    if mutual:
        idx_back, _ = H.best_match(D.T, th=th, nn_ratio=1.0)
        idx = H.mutual_filter(idx, idx_back)
    return idx, dist
