"""Lie groups SO(3) / SE(3) in torch.

Port of ar_orbslam2_tpu/core/lie.py: SO(3), SE(3), and the Sim(3) half
that loop closing uses. Everything is batch-first float32 with the
small-angle Taylor branches expressed as ``torch.where`` (no data-dependent
control flow).

Conventions (identical to the JAX package)
-----------------------------------------
* Rotations are 3x3 matrices ``R``; rigid transforms are ``(R, t)`` pairs
  mapping points as ``x' = R @ x + t`` (the reference's Tcw).
* SE3 tangent ``xi = (rho, omega)`` (6,), translation part FIRST.
* Quaternions are ``(x, y, z, w)`` to match TUM trajectory format.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_EPS = 1e-6


def _eye3(ref, shape):
    return torch.eye(3, dtype=ref.dtype, device=ref.device).expand(shape)


def hat(w):
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def so3_exp(omega):
    """Rodrigues: (..., 3) -> (..., 3, 3)."""
    theta2 = (omega * omega).sum(-1)
    small = theta2 < _EPS * _EPS
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(t2)
    W = hat(omega)
    W2 = W @ W
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / t2)
    return _eye3(omega, W.shape) + a[..., None, None] * W \
        + b[..., None, None] * W2


def so3_log(R):
    """Rotation matrix -> axis-angle vector via the quaternion (Shepperd's
    extraction + 2*atan2(|xyz|, w): well-conditioned at every angle, where
    the trace/arccos formula fails in f32 near theta = pi)."""
    q = rot_to_quat(R)
    xyz, w = q[..., :3], q[..., 3]
    sgn = torch.where(w < 0, -1.0, 1.0).to(q.dtype)   # shortest arc
    xyz = xyz * sgn[..., None]
    w = w * sgn
    n = torch.linalg.norm(xyz, dim=-1)
    theta = 2.0 * torch.atan2(n, w)
    small = n < _EPS
    factor = torch.where(small, 2.0 / torch.clamp(w, min=_EPS),
                         theta / torch.where(small, torch.ones_like(n), n))
    return xyz * factor[..., None]


def _V_coeffs(theta2):
    """Coefficients (b, c) of V = I + b*W + c*W^2 for SE3 exp."""
    small = theta2 < _EPS * _EPS
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(t2)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / t2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (t2 * theta))
    return b, c


def se3_exp(xi):
    """SE3 exponential. xi = (rho, omega) (..., 6) -> (R, t)."""
    rho, omega = xi[..., :3], xi[..., 3:]
    R = so3_exp(omega)
    W = hat(omega)
    W2 = W @ W
    b, c = _V_coeffs((omega * omega).sum(-1))
    V = _eye3(xi, W.shape) + b[..., None, None] * W + c[..., None, None] * W2
    t = (V @ rho[..., None])[..., 0]
    return R, t


def se3_log(R, t):
    """Inverse of se3_exp: (R, t) -> xi (..., 6)."""
    omega = so3_log(R)
    theta2 = (omega * omega).sum(-1)
    W = hat(omega)
    W2 = W @ W
    small = theta2 < _EPS * _EPS
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(t2)
    half = theta * 0.5
    sh = torch.sin(half)
    cot = half * torch.cos(half) / torch.where(sh.abs() < _EPS,
                                               torch.ones_like(sh), sh)
    k = torch.where(small, 1.0 / 12.0 + theta2 / 720.0, (1.0 - cot) / t2)
    Vinv = _eye3(R, W.shape) - 0.5 * W + k[..., None, None] * W2
    rho = (Vinv @ t[..., None])[..., 0]
    return torch.cat([rho, omega], -1)


def se3_mul(Ra, ta, Rb, tb):
    """(Ra, ta) ∘ (Rb, tb): first apply b, then a."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


# ---------------------------------------------------------------------------
# Sim(3) — similarity transforms x' = s * R @ x + t (g2o's Sim3, used by
# loop closing and the essential graph)
# ---------------------------------------------------------------------------
def _sim3_W(omega, sigma, n_terms=24):
    """W(omega, sigma) = int_0^1 e^{sigma u} exp(u hat(omega)) du.

    sigma*I commutes with hat(omega), so this is the phi_1 matrix function
    phi1(M) = sum_n M^n/(n+1)! of M = sigma*I + hat(omega), evaluated as a
    truncated Horner series: branch-free and smooth under forward-mode
    differentiation (the closed-form coefficients cancel catastrophically
    in float32 near theta = 0 / sigma = 0), accurate to float32 eps for
    |theta| <= pi with 24 terms.
    """
    I = _eye3(omega, omega.shape[:-1] + (3, 3))
    M = hat(omega) + sigma[..., None, None] * I
    P = I * (1.0 / math.factorial(n_terms + 1))
    for n in range(n_terms - 1, -1, -1):
        P = I * (1.0 / math.factorial(n + 1)) + M @ P
    return P


def sim3_exp(v):
    """Sim3 exponential. v = (rho, omega, sigma) (..., 7) -> (R, t, s),
    t = W(omega, sigma) @ rho."""
    rho, omega, sigma = v[..., :3], v[..., 3:6], v[..., 6]
    R = so3_exp(omega)
    t = (_sim3_W(omega, sigma) @ rho[..., None])[..., 0]
    return R, t, torch.exp(sigma)


def sim3_log(R, t, s):
    """Inverse of sim3_exp through a 3x3 solve of W rho = t (W's
    eigenvalues (e^z - 1)/z, z = sigma +/- i*theta, stay away from 0 for
    |theta| < pi)."""
    omega = so3_log(R)
    sigma = torch.log(s)
    W = _sim3_W(omega, sigma)
    # the _ex form checks nothing, so it never waits for the device; a
    # singular W gives non-finite values, as jnp.linalg.solve does
    rho = torch.linalg.solve_ex(W, t[..., None]).result[..., 0]
    return torch.cat([rho, omega, sigma[..., None]], -1)


def sim3_inv(R, t, s):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return Rt, -s_inv[..., None] * (Rt @ t[..., None])[..., 0], s_inv


def sim3_mul(Ra, ta, sa, Rb, tb, sb):
    """Compose: apply b then a, x -> sa*Ra*(sb*Rb x + tb) + ta."""
    return Ra @ Rb, sa[..., None] * (Ra @ tb[..., None])[..., 0] + ta, sa * sb


def sim3_apply(R, t, s, x):
    return s[..., None] * (R @ x[..., None])[..., 0] + t


# ---------------------------------------------------------------------------
# Quaternions (x, y, z, w) — trajectory IO (TUM format parity)
# ---------------------------------------------------------------------------
def rot_to_quat(R):
    """Rotation matrix -> unit quaternion (x, y, z, w), Shepperd's method."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # four candidate constructions; pick numerically best by largest pivot
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                      1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    qw = torch.sqrt(torch.clamp(qw, min=1e-12)) * 0.5
    w0, x1, y2, z3 = qw[..., 0], qw[..., 1], qw[..., 2], qw[..., 3]
    cand = torch.stack([
        torch.stack([(m21 - m12) / (4 * w0), (m02 - m20) / (4 * w0),
                     (m10 - m01) / (4 * w0), w0], -1),
        torch.stack([x1, (m01 + m10) / (4 * x1), (m02 + m20) / (4 * x1),
                     (m21 - m12) / (4 * x1)], -1),
        torch.stack([(m01 + m10) / (4 * y2), y2, (m12 + m21) / (4 * y2),
                     (m02 - m20) / (4 * y2)], -1),
        torch.stack([(m02 + m20) / (4 * z3), (m12 + m21) / (4 * z3), z3,
                     (m10 - m01) / (4 * z3)], -1),
    ], -2)
    best = torch.argmax(qw, -1)      # first index among equal pivots
    q = torch.take_along_dim(
        cand, best[..., None, None].expand(best.shape + (1, 4)), -2)[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_rot(q):
    """Unit quaternion (x, y, z, w) -> rotation matrix."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    sf = 2.0 / torch.where(n < 1e-12, torch.ones_like(n), n)
    xx, yy, zz = x * x * sf, y * y * sf, z * z * sf
    xy, xz, yz = x * y * sf, x * z * sf, y * z * sf
    wx, wy, wz = w * x * sf, w * y * sf, w * z * sf
    return torch.stack([
        torch.stack([1.0 - yy - zz, xy - wz, xz + wy], -1),
        torch.stack([xy + wz, 1.0 - xx - zz, yz - wx], -1),
        torch.stack([xz - wy, yz + wx, 1.0 - xx - yy], -1),
    ], -2)


def orthonormalize(R, steps=2):
    """Pull a nearly orthogonal (..., 3, 3) matrix back to SO(3) on its
    device, without an SVD: Newton steps of the polar decomposition,
    R <- R (3 I - R^T R) / 2, which converge quadratically (an
    orthonormality error of 1e-3 is below float32 rounding after two).
    No host read, so it can be recorded into a CUDA graph."""
    eye3 = torch.eye(3, dtype=R.dtype, device=R.device)
    for _ in range(steps):
        R = 0.5 * (R @ (3.0 * eye3 - R.transpose(-1, -2) @ R))
    return R


def project_so3(R):
    """Nearest rotation matrix (Frobenius) via SVD — numpy, host-side.

    Float32 pose chaining accumulates orthonormality error; projecting at
    the pose-write boundaries (Frame.set_pose, BA write-back) keeps R^T a
    valid inverse. Works on (..., 3, 3) batches; a non-finite slot comes
    back NaN so the caller's isfinite write-back guards still skip it.
    """
    R = np.asarray(R, np.float64)
    finite = np.isfinite(R).all(axis=(-1, -2))
    R_safe = np.where(finite[..., None, None], np.nan_to_num(R), np.eye(3))
    U, _, Vt = np.linalg.svd(R_safe)
    det = np.linalg.det(U @ Vt)
    D = np.ones(R.shape[:-2] + (3,))
    D[..., 2] = np.sign(det)
    out = (U * D[..., None, :]) @ Vt
    out = np.where(finite[..., None, None], out, np.nan)
    return out.astype(np.float32)
