"""Stereo feature matching — a row-banded Hamming search over all pairs.

Port of ar_orbslam2_tpu/frontend/stereo.py (the redesign of
Frame::ComputeStereoMatches, src/Frame.cc): instead of the reference's
per-row candidate lists, the full left x right Hamming matrix is masked by
the epipolar row band (|v_l - v_r| <= 2 * scale(octave)) and the disparity
window (0.1 < u_l - u_r <= max_disparity), one matmul for the whole frame
(exact in float32: TF32 is off package-wide). The SAD subpixel refinement
runs for all keypoints at once as gathers from the two images. Depth =
bf / disparity, right-u coordinate parity with mvuRight/mvDepth.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import hamming as H


def match_stereo(uv_l, signs_l, oct_l, valid_l, uv_r, signs_r, oct_r,
                 valid_r, max_disparity, scale_factor=1.2, th=H.TH_HIGH):
    """Match left keypoints to right keypoints along epipolar rows (JAX
    stereo.py:21-46).

    Returns (uvr (N,) right-u per left kp or -1, idx (N,) right index).
    """
    invalid = H.DESC_BITS + 1
    D = H.hamming_matrix(signs_l, signs_r, valid_l, valid_r,
                         invalid_dist=invalid)
    dv = (uv_l[:, None, 1] - uv_r[None, :, 1]).abs()
    band = 2.0 * scale_factor ** oct_l.to(torch.float32)
    disp = uv_l[:, None, 0] - uv_r[None, :, 0]
    in_band = (dv <= band[:, None]) & (disp > 0.1) & (disp <= max_disparity)
    # octave agreement +-1 (the reference gates levels via candidate lists)
    in_oct = (oct_l[:, None] - oct_r[None, :]).abs() <= 1
    D = torch.where(in_band & in_oct, D, invalid)
    idx, _ = H.best_match(D, th=th, nn_ratio=1.0)
    idx_back, _ = H.best_match(D.T, th=th, nn_ratio=1.0)
    idx = H.mutual_filter(idx, idx_back)
    uvr = torch.where(idx >= 0, uv_r[torch.clamp(idx, min=0).long(), 0],
                      torch.full_like(uv_l[:, 0], -1.0))
    return uvr, idx


def refine_stereo_subpixel(img_l, img_r, uv_l, uvr, valid, window=5,
                           search=5):
    """SAD subpixel refinement of matched right-u coordinates (JAX
    stereo.py:49-94).

    Parity: the correlation pass of Frame::ComputeStereoMatches — an 11x11
    centre-normalised window around the left keypoint slides ±5 px over the
    right image at the matched location; the best SAD column is refined by
    a parabola (deltaR = (d- − d+) / (2(d- + d+ − 2 d0))). As in the JAX
    package it runs on the level-0 images for all octaves; a minimum on the
    search border or a step beyond 1 px keeps the matched right-u, and an
    unmatched or invalid keypoint gets -1.

    All keypoints at once: the windows are gathered from the images with
    clamped starts (the JAX function's clips, which ``dynamic_slice``
    would apply too), the 11 shifted windows are an ``unfold`` of the
    strip. Every SAD is a sum of integers below 2**24, exact in float32 in
    any order, and ``argmin`` takes the first of equal SADs, like JAX's.

    Returns refined uvr (N,) with -1 where rejected/invalid.
    """
    W = 2 * window + 1
    S = 2 * search + 1
    h, w = img_l.shape
    dev = uv_l.device
    il = img_l.to(torch.float32)
    ir = img_r.to(torch.float32)
    ok = valid & (uvr > 0)
    ui = torch.clamp(torch.round(uv_l[:, 0]).to(torch.int64), window,
                     w - window - 1)
    vi = torch.clamp(torch.round(uv_l[:, 1]).to(torch.int64), window,
                     h - window - 1)
    uri = torch.clamp(torch.round(uvr).to(torch.int64), window + search,
                      w - window - search - 1)
    off = torch.arange(W, device=dev) - window
    rows = (vi[:, None] + off)[:, :, None]                      # (N, W, 1)
    patch = il[rows, (ui[:, None] + off)[:, None, :]]           # (N, W, W)
    patch = patch - patch[:, window, window][:, None, None]
    cols = uri[:, None] - window - search \
        + torch.arange(W + 2 * search, device=dev)
    strip = ir[rows, cols[:, None, :]]                          # (N, W, W+2s)
    wins = strip.unfold(2, W, 1)                                # (N, W, S, W)
    centre = strip[:, window, window:window + S]                # (N, S)
    sads = (patch[:, :, None, :]
            - (wins - centre[:, None, :, None])).abs().sum((1, 3))
    best = torch.argmin(sads, dim=1)
    interior = (best > 0) & (best < S - 1)
    bc = torch.clamp(best, 1, S - 2)
    d_m = sads.gather(1, (bc - 1)[:, None])[:, 0]
    d_0 = sads.gather(1, bc[:, None])[:, 0]
    d_p = sads.gather(1, (bc + 1)[:, None])[:, 0]
    denom = d_m + d_p - 2.0 * d_0
    delta = (d_m - d_p) / torch.clamp(2.0 * denom, min=1e-6)
    good = ok & interior & (delta.abs() <= 1.0) & (denom > 0)
    ur_new = (uri + (bc - search)).to(torch.float32) + delta
    return torch.where(good, ur_new,
                       torch.where(ok, uvr, torch.full_like(uvr, -1.0)))


def stereo_frame_features(slam, left_u8, right_u8, max_disparity=None,
                          subpixel=True):
    """Extract ORB on both images and stereo-match (+ SAD subpixel) on the
    system's device (JAX stereo.py:97-122).

    Returns (features dict for the LEFT image, uvr (P,), depth (P,)).
    """
    dev = slam.device
    fl = slam._extract(left_u8)
    fr = slam._extract(right_u8)
    cam = slam.cam
    if max_disparity is None:
        max_disparity = max(cam.bf / max(cam.fx * 0.02, 1e-6), 64.0)

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)
    uv_l, valid_l = up(fl["uv"]), up(fl["valid"])
    uvr_dev, _ = match_stereo(
        uv_l, H.to_signs(fl["desc_bits"], device=dev), up(fl["octave"]),
        valid_l, up(fr["uv"]), H.to_signs(fr["desc_bits"], device=dev),
        up(fr["octave"]), up(fr["valid"]), float(max_disparity))
    if subpixel:
        uvr_dev = refine_stereo_subpixel(up(left_u8), up(right_u8), uv_l,
                                         uvr_dev, valid_l)
    uvr = uvr_dev.cpu().numpy()
    disp = fl["uv"][:, 0] - uvr
    good = (uvr > 0) & (disp > 0.1)
    depth = np.where(good, cam.bf / np.maximum(disp, 0.1), -1.0)
    feats = dict(uv=fl["uv"], desc=fl["desc_bits"], octave=fl["octave"],
                 valid=fl["valid"], angle=fl["angle"])
    return feats, np.where(good, uvr, -1.0).astype(np.float32), \
        depth.astype(np.float32)
