"""Multi-view geometry primitives: triangulation, epipolar tests, parallax.

Port of ar_orbslam2_tpu/core/geometry.py. Batch-first: correspondences
come in as (N, 2)/(N, 3) tensors and the whole batch is processed with
batched linear algebra (torch.linalg.solve / svd are plain library math
here, as they were XLA's in the JAX package).
"""
from __future__ import annotations

import torch


def triangulate_linear(R1, t1, R2, t2, xn1, xn2):
    """DLT triangulation of N correspondences in normalized coords.

    Inhomogeneous least squares A[:, :3] x = -A[:, 3] on the 4x3 DLT system
    with trace-relative Tikhonov damping: degenerate (zero-parallax) rows
    stay finite and fail the parallax/depth gates downstream. No
    eigen/SVD sign ambiguity arises on this path.
    """
    P1 = torch.cat([R1, t1[:, None]], 1)                 # (3,4)
    P2 = torch.cat([R2, t2[:, None]], 1)
    rows = []
    for P, xn in ((P1, xn1), (P2, xn2)):
        rows.append(xn[..., 0:1] * P[2] - P[0])          # (N,4)
        rows.append(xn[..., 1:2] * P[2] - P[1])
    A = torch.stack(rows, -2)                            # (N,4,4)
    M = A[..., :3]
    b = -A[..., 3]
    Mt = M.transpose(-1, -2)
    MtM = Mt @ M
    Mtb = (Mt @ b[..., None])[..., 0]
    tr = (MtM[..., 0, 0] + MtM[..., 1, 1] + MtM[..., 2, 2])[..., None, None]
    MtM = MtM + (1e-7 * tr + 1e-10) * torch.eye(3, dtype=A.dtype,
                                                 device=A.device)
    return torch.linalg.solve(MtM, Mtb[..., None])[..., 0]


def depth_in_view(R, t, xw):
    """z-coordinate of world points in a camera frame."""
    return (R @ xw[..., None])[..., 0][..., 2] + t[2]


def parallax_cos(c1, c2, xw):
    """Cosine of the ray angle between camera centers c1, c2 and points xw."""
    r1 = xw - c1
    r2 = xw - c2
    n1 = torch.linalg.norm(r1, dim=-1)
    n2 = torch.linalg.norm(r2, dim=-1)
    return (r1 * r2).sum(-1) / torch.clamp(n1 * n2, min=1e-12)


def camera_center(R, t):
    """World-frame optical center of a world->camera transform."""
    return -(R.transpose(-1, -2) @ t[..., None])[..., 0]


def essential_from_pose(R, t):
    """E = [t]x R for relative pose (view1 -> view2)."""
    tx, ty, tz = t[..., 0], t[..., 1], t[..., 2]
    z = torch.zeros_like(tx)
    Tx = torch.stack([torch.stack([z, -tz, ty], -1),
                      torch.stack([tz, z, -tx], -1),
                      torch.stack([-ty, tx, z], -1)], -2)
    return Tx @ R


def fundamental_from_pose(R12, t12, K1, K2):
    """F between two views given relative pose and intrinsics.
    Parity: ORBmatcher / LocalMapping ComputeF12."""
    E = essential_from_pose(R12, t12)
    return torch.linalg.inv(K2).T @ E @ torch.linalg.inv(K1)


def epipolar_sq_dist(F12, uv1, uv2):
    """Squared distance of uv2 to the epipolar line of uv1 (pixels^2).
    Parity: ORBmatcher::CheckDistEpipolarLine."""
    ones1 = torch.ones(uv1.shape[:-1] + (1,), dtype=uv1.dtype,
                       device=uv1.device)
    ones2 = torch.ones(uv2.shape[:-1] + (1,), dtype=uv2.dtype,
                       device=uv2.device)
    x1 = torch.cat([uv1, ones1], -1)
    line = x1 @ F12.T                                    # line in image 2
    num = (torch.cat([uv2, ones2], -1) * line).sum(-1)
    den = line[..., 0] ** 2 + line[..., 1] ** 2
    return num * num / torch.clamp(den, min=1e-12)


def decompose_essential(E):
    """E -> (R1, R2, t) candidate decomposition (4 hypotheses: (R1,±t),
    (R2,±t)). Parity: Initializer::DecomposeE.

    SVD sign ambiguity: U and Vt may come back with flipped columns/rows in
    either framework. R1/R2 are forced proper by the determinant flip, and
    t = U[:, 2] is only defined up to sign, which the caller covers by
    testing both ±t; the chosen hypothesis is therefore sign-independent.
    """
    U, _, Vt = torch.linalg.svd(E)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = R1 * torch.where(torch.linalg.det(R1) < 0, -1.0, 1.0).to(E.dtype)
    R2 = R2 * torch.where(torch.linalg.det(R2) < 0, -1.0, 1.0).to(E.dtype)
    t = U[..., :, 2]
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-12)
    return R1, R2, t
