"""Two-view monocular initialization: batched H/F RANSAC + reconstruction.

Port of ar_orbslam2_tpu/estimation/initializer.py (the reference's
Initializer, src/Initializer.cc). Each model is one batched hypothesis set
(fixed count, argmax score); the model choice RH = SH/(SH+SF) > 0.40, the
chi-square scoring gates (3.841 / 5.991) and the cheirality/parallax checks
of ReconstructF/ReconstructH are kept.

Random draws: the hypotheses' sample indices come from a torch.Generator,
or are passed in precomputed ((n_hyp, 8) int tensor) so a test can feed the
JAX package's draw (``jax.random.categorical``) to both packages.

Sign ambiguity: the 8-point/DLT solutions are eigenvectors, defined up to
sign. H is normalized by its signed H[2,2], which removes the sign; F is
normalized by |F[2,2]|, and every use of F (epipolar distances, E = K^T F K
decomposed with both ±t) is invariant to its sign.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import geometry

TH_F = 3.841          # 1-dof chi2 gate for epipolar distance
TH_SCORE = 5.991      # scoring offset (both models) and H gate
MIN_PARALLAX_DEG = 1.0
MIN_TRIANGULATED = 50


def _normalize(pts, valid):
    """Hartley normalization over valid points: returns (pts_n, T 3x3)."""
    w = valid.to(pts.dtype)
    n = torch.clamp(w.sum(), min=1.0)
    mean = (pts * w[:, None]).sum(0) / n
    d = (pts - mean).abs() * w[:, None]
    meandev = d.sum(0) / n
    s = 1.0 / torch.clamp(meandev, min=1e-6)
    pts_n = (pts - mean) * s
    zero, one = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], zero, -mean[0] * s[0]]),
                     torch.stack([zero, s[1], -mean[1] * s[1]]),
                     torch.stack([zero, zero, one])])
    return pts_n, T


def _smallest_eigvec(AtA):
    _, V = torch.linalg.eigh(AtA)
    return V[..., :, 0]


def _compute_f(p1, p2, w=None):
    """8-point F from (B,K,2),(B,K,2) normalized points (optionally
    weighted — the all-inlier refit). F: p2' F p1 = 0. Batched over B."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    one = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2,
                     x1, y1, one], -1)                   # (B,K,9)
    Aw = A if w is None else A * w[..., None]
    f = _smallest_eigvec(A.transpose(-1, -2) @ Aw)
    F = f.reshape(f.shape[:-1] + (3, 3))
    U, S, Vt = torch.linalg.svd(F)                       # enforce rank 2
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    return (U * S[..., None, :]) @ Vt


def _compute_h(p1, p2, w=None):
    """DLT homography from (B,K,2),(B,K,2): p2 ~ H p1 (optionally
    weighted). Batched over B."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    one = torch.ones_like(x1)
    zero = torch.zeros_like(x1)
    r1 = torch.stack([zero, zero, zero, -x1, -y1, -one,
                      y2 * x1, y2 * y1, y2], -1)
    r2 = torch.stack([x1, y1, one, zero, zero, zero,
                      -x2 * x1, -x2 * y1, -x2], -1)
    A = torch.cat([r1, r2], -2)                          # (B,2K,9)
    Aw = A if w is None else A * torch.cat([w, w], -1)[..., None]
    h = _smallest_eigvec(A.transpose(-1, -2) @ Aw)
    return h.reshape(h.shape[:-1] + (3, 3))


def _epipolar_sq_dist(F, uv1, uv2):
    """Batched geometry.epipolar_sq_dist: F (B,3,3), uv (N,2) -> (B,N)."""
    ones = torch.ones(uv1.shape[:-1] + (1,), dtype=uv1.dtype,
                      device=uv1.device)
    line = torch.cat([uv1, ones], -1) @ F.transpose(-1, -2)     # (B,N,3)
    num = (torch.cat([uv2, ones], -1) * line).sum(-1)
    den = line[..., 0] ** 2 + line[..., 1] ** 2
    return num * num / torch.clamp(den, min=1e-12)


def _score_f(F, uv1, uv2, valid, sigma2=1.0):
    """Symmetric epipolar chi2 score (CheckFundamental parity)."""
    d2_21 = _epipolar_sq_dist(F, uv1, uv2) / sigma2
    d2_12 = _epipolar_sq_dist(F.transpose(-1, -2), uv2, uv1) / sigma2
    ok = (d2_21 <= TH_F) & (d2_12 <= TH_F) & valid
    zero = torch.zeros_like(d2_21)
    score = torch.where(d2_21 <= TH_F, TH_SCORE - d2_21, zero) + \
        torch.where(d2_12 <= TH_F, TH_SCORE - d2_12, zero)
    return (score * valid).sum(-1), ok


def _apply_h(Hm, uv):
    ones = torch.ones(uv.shape[:-1] + (1,), dtype=uv.dtype, device=uv.device)
    p = torch.cat([uv, ones], -1) @ Hm.transpose(-1, -2)
    w = torch.where(p[..., 2].abs() < 1e-9, 1e-9, p[..., 2])
    return p[..., :2] / w[..., None]


def _score_h(Hm, uv1, uv2, valid, sigma2=1.0):
    """Symmetric transfer chi2 score (CheckHomography parity)."""
    eye = torch.eye(3, dtype=Hm.dtype, device=Hm.device)
    Hinv = torch.linalg.inv(Hm + 1e-12 * eye)
    e21 = ((_apply_h(Hm, uv1) - uv2) ** 2).sum(-1) / sigma2
    e12 = ((_apply_h(Hinv, uv2) - uv1) ** 2).sum(-1) / sigma2
    ok = (e21 <= TH_SCORE) & (e12 <= TH_SCORE) & valid
    zero = torch.zeros_like(e21)
    score = torch.where(e21 <= TH_SCORE, TH_SCORE - e21, zero) + \
        torch.where(e12 <= TH_SCORE, TH_SCORE - e12, zero)
    return (score * valid).sum(-1), ok


def _norm_f(F):
    return F / torch.clamp(F[..., 2:3, 2:3].abs(), min=1e-9)


def _norm_h(Hm):
    h22 = Hm[..., 2:3, 2:3]
    return Hm / torch.where(h22.abs() < 1e-9, 1e-9, h22)


def sample_hypotheses(valid, n_hyp=256, generator=None):
    """(n_hyp, 8) indices drawn uniformly (with replacement) from the valid
    rows — the distribution of the JAX package's categorical draw."""
    p = valid.to(torch.float32)
    if float(p.sum()) <= 0:
        p = torch.ones_like(p)
    return torch.multinomial(p.expand(n_hyp, -1).contiguous(), 8,
                             replacement=True, generator=generator)


def ransac_fh(uv1, uv2, valid, n_hyp=256, generator=None, sample_idx=None):
    """Batched RANSAC for F and H simultaneously.

    sample_idx: optional precomputed (n_hyp, 8) sample indices; otherwise
    drawn from `generator`. Returns dict(F, H, score_f, score_h,
    inliers_f, inliers_h).
    """
    if sample_idx is None:
        sample_idx = sample_hypotheses(valid, n_hyp, generator)
    if not torch.is_tensor(sample_idx):
        sample_idx = torch.as_tensor(np.array(sample_idx))
    idx = sample_idx.to(uv1.device).long()
    p1n, T1 = _normalize(uv1, valid)
    p2n, T2 = _normalize(uv2, valid)
    T2inv = torch.linalg.inv(T2)

    s1, s2 = p1n[idx], p2n[idx]                          # (B,8,2)
    Fs = _norm_f(T2.T @ _compute_f(s1, s2) @ T1)
    Hs = _norm_h(T2inv @ _compute_h(s1, s2) @ T1)
    sf, _ = _score_f(Fs, uv1, uv2, valid)
    sh, _ = _score_h(Hs, uv1, uv2, valid)
    F, Hm = Fs[torch.argmax(sf)], Hs[torch.argmax(sh)]
    score_f, inl_f = _score_f(F, uv1, uv2, valid)
    score_h, inl_h = _score_h(Hm, uv1, uv2, valid)

    # All-inlier least-squares refit (two passes)
    for _ in range(2):
        Fr = _norm_f(T2.T @ _compute_f(p1n, p2n, inl_f.to(uv1.dtype)) @ T1)
        sfr, inl_fr = _score_f(Fr, uv1, uv2, valid)
        better_f = sfr > score_f
        F = torch.where(better_f, Fr, F)
        score_f = torch.where(better_f, sfr, score_f)
        inl_f = torch.where(better_f, inl_fr, inl_f)

        Hr = _norm_h(T2inv @ _compute_h(p1n, p2n, inl_h.to(uv1.dtype)) @ T1)
        shr, inl_hr = _score_h(Hr, uv1, uv2, valid)
        better_h = shr > score_h
        Hm = torch.where(better_h, Hr, Hm)
        score_h = torch.where(better_h, shr, score_h)
        inl_h = torch.where(better_h, inl_hr, inl_h)

    return dict(F=F, H=Hm, score_f=score_f, score_h=score_h,
                inliers_f=inl_f, inliers_h=inl_h)


def check_rt_batch(Rs, ts, uv1, uv2, inlier, K, sigma2=1.0):
    """Score candidate (R, t) relative poses by cheirality (CheckRT parity).

    For each candidate: triangulate all inlier matches in view1 frame vs
    (R, t); count points with positive depth in both views, parallax cos <
    0.99998, and reprojection chi2 < 4*sigma2 in both.
    Returns (n_good (C,), parallax_deg (C,), xw (C, N, 3), good (C, N)).
    """
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xn1 = torch.stack([(uv1[:, 0] - cx) / fx, (uv1[:, 1] - cy) / fy], -1)
    xn2 = torch.stack([(uv2[:, 0] - cx) / fx, (uv2[:, 1] - cy) / fy], -1)
    eye = torch.eye(3, dtype=uv1.dtype, device=uv1.device)
    z3 = torch.zeros(3, dtype=uv1.dtype, device=uv1.device)
    th2 = 4.0 * sigma2
    out = []
    for R, t in zip(Rs, ts):
        xw = geometry.triangulate_linear(eye, z3, R, t, xn1, xn2)
        finite = torch.isfinite(xw).all(-1)
        z1 = xw[:, 2]
        xc2 = xw @ R.T + t
        z2 = xc2[:, 2]
        c2 = geometry.camera_center(R, t)
        pcos = geometry.parallax_cos(z3, c2, xw)

        def nz(z):
            return torch.where(z == 0, 1e-9, z)
        u1 = fx * xw[:, 0] / nz(z1) + cx
        v1 = fy * xw[:, 1] / nz(z1) + cy
        e1 = (u1 - uv1[:, 0]) ** 2 + (v1 - uv1[:, 1]) ** 2
        u2 = fx * xc2[:, 0] / nz(z2) + cx
        v2 = fy * xc2[:, 1] / nz(z2) + cy
        e2 = (u2 - uv2[:, 0]) ** 2 + (v2 - uv2[:, 1]) ** 2
        good = (finite & inlier & (pcos < 0.99998)
                & (z1 > 0) & (z2 > 0) & (e1 < th2) & (e2 < th2))
        n_good = good.to(torch.int32).sum()
        # parallax statistic: ~50th best (reference takes min(50, n)-th)
        pang = torch.rad2deg(torch.arccos(torch.clamp(pcos, -1.0, 1.0)))
        pang = torch.where(good, pang, torch.zeros_like(pang))
        k = torch.clamp(torch.clamp(n_good, min=1), max=50)
        top = torch.topk(pang, 50).values          # values only: tie-safe
        parallax = top[torch.clamp(k - 1, max=49)]
        out.append((n_good, parallax, xw, good))
    return tuple(torch.stack(v) for v in zip(*out))


def _faugeras_hypotheses(A):
    """Faugeras SVD decomposition of a calibrated homography A = K^-1 H K
    into 8 (R, t, n) motion hypotheses (ReconstructH parity). NumPy host
    code — once per initialization attempt on a single 3x3."""
    U, w, Vt = np.linalg.svd(A.astype(np.float64))
    V = Vt.T
    s = np.linalg.det(U) * np.linalg.det(Vt)
    d1, d2, d3 = w
    if d1 / d2 < 1.00001 or d2 / d3 < 1.00001:
        return []  # degenerate (pure rotation-ish); reference returns false
    hyps = []
    aux1 = np.sqrt((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3))
    aux3 = np.sqrt((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3))
    x1s = [aux1, aux1, -aux1, -aux1]
    x3s = [aux3, -aux3, aux3, -aux3]
    # case d' > 0
    sin_t = np.sqrt((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3)) / ((d1 + d3) * d2)
    cos_t = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2)
    for x1, x3 in zip(x1s, x3s):
        eps1 = 1.0 if x1 >= 0 else -1.0
        eps3 = 1.0 if x3 >= 0 else -1.0
        st_signed = eps1 * eps3 * sin_t
        Rp = np.array([[cos_t, 0, -st_signed], [0, 1, 0],
                       [st_signed, 0, cos_t]])
        tp = np.array([x1, 0, -x3]) * (d1 - d3)
        np_ = np.array([x1, 0, x3])
        R = s * U @ Rp @ Vt
        t = U @ tp
        n = V @ np_
        if n[2] < 0:
            n = -n
        hyps.append((R, t / (np.linalg.norm(t) + 1e-12), n))
    # case d' < 0
    sin_p = np.sqrt((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3)) / ((d1 - d3) * d2)
    cos_p = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2)
    for x1, x3 in zip(x1s, x3s):
        eps1 = 1.0 if x1 >= 0 else -1.0
        eps3 = 1.0 if x3 >= 0 else -1.0
        sp = eps1 * eps3 * sin_p
        Rp = np.array([[cos_p, 0, sp], [0, -1, 0], [sp, 0, -cos_p]])
        tp = np.array([x1, 0, x3]) * (d1 + d3)
        np_ = np.array([x1, 0, x3])
        R = s * U @ Rp @ Vt
        t = U @ tp
        n = V @ np_
        if n[2] < 0:
            n = -n
        hyps.append((R, t / (np.linalg.norm(t) + 1e-12), n))
    return hyps


def initialize_two_view(uv1, uv2, valid, K, n_hyp=256, sigma=1.0,
                        generator=None, sample_idx=None):
    """Full monocular initialization (Initializer::Initialize parity).

    Args:
      uv1, uv2: (N, 2) matched undistorted pixel tensors (row i of uv1
        matches row i of uv2); valid: (N,) bool mask of real matches.
      K: 3x3 intrinsics (numpy or tensor). generator / sample_idx: the
        RANSAC draw (see ransac_fh).
    Returns:
      None on failure, else dict(R21, t21, xw (N,3), good (N,) bool) as
      numpy — pose of view 2 w.r.t. view 1, unit-norm translation.
    """
    dev = uv1.device
    uv1 = uv1.to(torch.float32)
    uv2 = uv2.to(torch.float32)
    K = torch.as_tensor(np.asarray(K, np.float32), device=dev)
    out = ransac_fh(uv1, uv2, valid, n_hyp=n_hyp, generator=generator,
                    sample_idx=sample_idx)
    sf = float(out["score_f"])
    sh = float(out["score_h"])
    if sf <= 0 and sh <= 0:
        return None
    rh = sh / max(sh + sf, 1e-9)

    if rh > 0.40:
        Kn = K.cpu().numpy()
        A = np.linalg.inv(Kn) @ out["H"].cpu().numpy() @ Kn
        hyps = _faugeras_hypotheses(A)
        if not hyps:
            return None
        Rs = torch.as_tensor(np.stack([h[0] for h in hyps]),
                             dtype=torch.float32, device=dev)
        ts = torch.as_tensor(np.stack([h[1] for h in hyps]),
                             dtype=torch.float32, device=dev)
        inl = out["inliers_h"]
    else:
        E = K.T @ out["F"] @ K
        R1, R2, t = geometry.decompose_essential(E)
        Rs = torch.stack([R1, R1, R2, R2])
        ts = torch.stack([t, -t, t, -t])
        inl = out["inliers_f"]

    n_good, parallax, xws, goods = (
        v.cpu().numpy() for v in check_rt_batch(
            Rs, ts, uv1, uv2, inl, K, sigma2=sigma * sigma))
    Rs, ts = Rs.cpu().numpy(), ts.cpu().numpy()
    n_inl = int(inl.sum())
    best = int(np.argmax(n_good))
    max_good = int(n_good[best])
    n_similar = int((n_good > 0.7 * max_good).sum())
    # reference gates: enough points, unambiguous winner, enough parallax
    if (max_good < MIN_TRIANGULATED or max_good < 0.5 * n_inl
            or n_similar > 1 or parallax[best] < MIN_PARALLAX_DEG):
        return None
    return dict(R21=Rs[best], t21=ts[best], xw=xws[best], good=goods[best],
                used_model="H" if rh > 0.40 else "F", rh=rh)
