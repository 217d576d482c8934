"""Batched RANSAC PnP — pose from 3D-2D matches.

Port of ar_orbslam2_tpu/estimation/pnp.py (the redesign of PnPsolver,
src/PnPsolver.cc): a FIXED batch of a few hundred DLT-PnP hypotheses runs
as one batched computation (batched 12x12 eigensolves, 3x3 SVDs, one (H, N)
reprojection pass) and the argmax-inlier hypothesis wins — no data-dependent
control flow. Final polish is motion-only BA (pose_optimization), exactly
as Tracking::Relocalization does. The JAX package computes all of it outside
any hand kernel, so ``torch.linalg`` is its counterpart here; float32, no
TF32 (the package's rule).

The sample draw comes from an explicit ``torch.Generator`` on the inputs'
device (``torch.multinomial`` with replacement over the valid matches, as
``jax.random.choice(..., replace=True, p=valid)``), or from ``samples=`` —
the two frameworks give different numbers from the same seed, so a test
hands both the same draw.

One repair of the reference. The DLT fits all 12 entries of the projection
matrix, and on coplanar landmarks (a wall, a table top, the bench scene's
textured plane) the columns of its design matrix are linearly dependent:
the null space is 4-dimensional and the fitted pose is arbitrary — on a
plane with 1 cm of depth noise the best of 256 hypotheses explains 4 of 449
matches. Every sample therefore yields a second hypothesis from the
homography of its best-fit plane (``_planar_pose``: exact for coplanar
points, poor for points in general position), and the inlier count picks
among all 2 x n_hyp, general ones first on a tie (the first n_hyp scores are
the reference's hypothesis set). No threshold decides which solver applies,
so there is still no data-dependent control flow.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import camera as cam_mod

CHI2_2DOF = 5.991
MIN_SAMPLE = 6          # DLT minimal-ish sample (vs EPnP's 4)


def _dlt_pose(X, xn):
    """DLT projection-matrix fit: X (..., S, 3) points, xn (..., S, 2)
    normalized image coords -> (R (..., 3, 3), t (..., 3)). Leading
    dimensions are a batch of samples."""
    ones = torch.ones_like(X[..., :1])
    zeros = torch.zeros(X.shape[:-1] + (4,), dtype=X.dtype, device=X.device)
    Xh = torch.cat([X, ones], -1)                             # (..., S, 4)
    rows_u = torch.cat([Xh, zeros, -xn[..., 0:1] * Xh], -1)
    rows_v = torch.cat([zeros, Xh, -xn[..., 1:2] * Xh], -1)
    A = torch.cat([rows_u, rows_v], -2)                       # (..., 2S, 12)
    p = _smallest_eigvec(A)
    P = p.reshape(p.shape[:-1] + (3, 4))
    # overall sign: the mean sample depth (P row 3 . [X,1]) must be > 0
    depth_mean = (Xh @ P[..., 2, :, None])[..., 0].mean(-1)
    P = P * torch.where(depth_mean < 0, -1.0, 1.0)[..., None, None]
    M = P[..., :, :3]
    # orthogonalize M ~ s R: R = U diag(1,1,det) V^T, s = mean singular val
    R, sv = _rotation_from(M)
    s = torch.clamp(sv.mean(-1), min=1e-12)
    t = P[..., :, 3] / s[..., None]
    return R, t


def _smallest_eigvec(A):
    """Eigenvector of the smallest eigenvalue of A^T A, (..., n)."""
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    return V[..., :, 0]


def _rotation_from(M):
    """Nearest rotation to M ~ s R: U diag(1, 1, det) V^T."""
    U, sv, Vt = torch.linalg.svd(M)
    d = torch.linalg.det(U @ Vt)
    D = torch.diag_embed(torch.stack(
        [torch.ones_like(d), torch.ones_like(d), d], -1))
    return U @ D @ Vt, sv


def _planar_pose(X, xn):
    """Pose of a sample from the homography of its best-fit plane: X
    (..., S, 3), xn (..., S, 2) -> (R (..., 3, 3), t (..., 3)).

    With the plane's frame B = [e1 e2 n] at the centroid c, X = c + a e1 +
    b e2 and x ~ R X + t = H [a b 1]^T, H = [R e1, R e2, R c + t] up to
    scale: a 9-parameter DLT, then R B from H's first two columns."""
    c = X.mean(-2, keepdim=True)
    Xc = X - c
    _, E = torch.linalg.eigh(Xc.transpose(-1, -2) @ Xc)
    e1, e2 = E[..., :, 2], E[..., :, 1]         # in-plane axes
    n = torch.linalg.cross(e1, e2, dim=-1)      # right-handed frame
    B = torch.stack([e1, e2, n], -1)
    ab = Xc @ B[..., :, :2]                                   # (..., S, 2)
    ph = torch.cat([ab, torch.ones_like(ab[..., :1])], -1)    # (..., S, 3)
    zeros = torch.zeros_like(ph)
    rows_u = torch.cat([ph, zeros, -xn[..., 0:1] * ph], -1)
    rows_v = torch.cat([zeros, ph, -xn[..., 1:2] * ph], -1)
    h = _smallest_eigvec(torch.cat([rows_u, rows_v], -2))
    Hm = h.reshape(h.shape[:-1] + (3, 3))
    # overall sign: the mean sample depth (H row 3 . [a b 1]) must be > 0
    depth_mean = (ph @ Hm[..., 2, :, None])[..., 0].mean(-1)
    Hm = Hm * torch.where(depth_mean < 0, -1.0, 1.0)[..., None, None]
    h1, h2, h3 = Hm[..., :, 0], Hm[..., :, 1], Hm[..., :, 2]
    s = torch.clamp(0.5 * (torch.linalg.norm(h1, dim=-1)
                           + torch.linalg.norm(h2, dim=-1)), min=1e-12)
    M = torch.stack([h1, h2, torch.linalg.cross(h1, h2, dim=-1)
                     / s[..., None]], -1)
    RB, _ = _rotation_from(M)
    R = RB @ B.transpose(-1, -2)
    t = h3 / s[..., None] - (R @ c.transpose(-1, -2))[..., 0]
    return R, t


@functools.lru_cache(maxsize=16)
def _k_inverse(cam, device):
    """inv(K) in float32 on `device`; cached, so the upload (a stream
    synchronisation) happens once per camera and device."""
    K = torch.as_tensor(np.asarray(cam.K, np.float32))
    return torch.linalg.inv(K).to(device)


def draw_samples(valid, n_hyp, generator=None, size=MIN_SAMPLE):
    """(n_hyp, size) indices drawn with replacement, uniformly over the
    valid matches."""
    p = valid.to(torch.float32)
    p = p / torch.clamp(p.sum(), min=1.0)
    # all-invalid input: multinomial refuses a zero distribution
    p = torch.where(p.sum() > 0, p, torch.full_like(p, 1.0 / p.shape[0]))
    return torch.multinomial(p.expand(n_hyp, -1), size,
                             replacement=True, generator=generator)


@torch.no_grad()
def pnp_ransac(xw, uv, octave, valid, cam, generator=None, n_hyp=256,
               scale_factor=1.2, samples=None):
    """Robust pose from 3D-2D matches.

    Args:
      xw (N,3) landmark positions; uv (N,2) observed pixels; octave (N,)
      pyramid level (per-scale chi2 gate, parity with PnPsolver's
      mvMaxError); valid (N,) bool; `generator` on the inputs' device, or
      `samples` (n_hyp, MIN_SAMPLE) integer indices to use instead of a
      draw.
    Returns dict(R, t, inlier (N,) bool, n_inliers, ok, scores (2H,): the
    general hypotheses then the planar ones, best) of tensors: no host read
    happens here.
    """
    if samples is None:
        samples = draw_samples(valid, n_hyp, generator)
    samples = samples.long()
    Kinv = _k_inverse(cam, uv.device)
    ones = torch.ones_like(uv[..., :1])
    xn = (torch.cat([uv, ones], -1) @ Kinv.T)[..., :2]

    Rs, ts = _dlt_pose(xw[samples], xn[samples])
    Rp, tp = _planar_pose(xw[samples], xn[samples])
    Rs, ts = torch.cat([Rs, Rp]), torch.cat([ts, tp])

    # score every hypothesis against every match: (H, N) chi2
    xc = torch.einsum("hij,nj->hni", Rs, xw) + ts[:, None, :]
    uv_hat = cam_mod.project(cam, xc)
    err2 = ((uv_hat - uv[None]) ** 2).sum(-1)
    sigma2 = scale_factor ** (2.0 * octave.to(torch.float32))
    inl = (err2 < CHI2_2DOF * sigma2[None, :]) & (xc[..., 2] > 0) \
        & valid[None, :]
    scores = inl.to(torch.int32).sum(-1)
    finite = torch.isfinite(Rs).all(-1).all(-1) & torch.isfinite(ts).all(-1)
    scores = torch.where(finite, scores, torch.full_like(scores, -1))
    best = torch.argmax(scores)
    return dict(R=Rs[best], t=ts[best], inlier=inl[best],
                n_inliers=scores[best], ok=scores[best] >= MIN_SAMPLE + 4,
                scores=scores, best=best)
