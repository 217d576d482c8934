"""Shared building blocks of the Schur-complement BA engine.

Port of ar_orbslam2_tpu/estimation/ba_core.py: the residual/Jacobian math
and the landmark-marginalised (Schur) camera system. Observation layout is
grouped per landmark: obs_cam (P, OPP) camera index with -1 padding,
obs_uv (P, OPP, 2), ...

The JAX package turned every camera-indexed access into a matmul against a
one-hot (P, OPP, C) table, with bf16 operands for the S assembly (TPU
gathers serialize). Here camera access is an index gather and every
camera-indexed sum a ``core.sums.IndexSum`` in float32: the same math
without the one-hot table and without the bf16 rounding of S, and, like
the matmul, a sum in an order fixed by the inputs, so one problem gives
the same bits on every run.
"""
from __future__ import annotations

import torch

from ..core import lie
from ..core.sums import IndexSum


def ba_residuals(cam, R_all, t_all, X, oc, obs_uv, obs_uvr, stereo):
    """Per-observation residuals + Jacobians.

    Returns:
      r (P,OPP,3): [du, dv, du_right] (third row zero for mono obs).
      Jc (P,OPP,3,6): d r / d xi_cam (left-mult SE3 perturbation).
      Jpt (P,OPP,3,3): d r / d X.
      behind (P,OPP) bool: point behind the camera.
    """
    P, OPP = oc.shape
    Rg = R_all[oc]                                         # (P,OPP,3,3)
    tg = t_all[oc]
    xc = torch.einsum("poij,pj->poi", Rg, X) + tg
    z = torch.clamp(xc[..., 2], min=1e-6)
    u = cam.fx * xc[..., 0] / z + cam.cx
    v = cam.fy * xc[..., 1] / z + cam.cy
    r_uv = torch.stack([u - obs_uv[..., 0], v - obs_uv[..., 1]], -1)
    u_r = u - cam.bf / z
    r_r = torch.where(stereo, u_r - obs_uvr, torch.zeros_like(u_r))
    r = torch.cat([r_uv, r_r[..., None]], -1)
    x, y = xc[..., 0], xc[..., 1]
    iz = 1.0 / z
    iz2 = iz * iz
    zero = torch.zeros_like(z)
    Jp_row_u = torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], -1)
    Jp_row_v = torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], -1)
    Jp_row_r = Jp_row_u + torch.stack([zero, zero, cam.bf * iz2], -1)
    Jp_row_r = torch.where(stereo[..., None], Jp_row_r,
                           torch.zeros_like(Jp_row_r))
    Jproj = torch.stack([Jp_row_u, Jp_row_v, Jp_row_r], -2)  # (P,OPP,3,3)
    # d xc / d xi (camera, left perturbation) = [I | -hat(xc)]
    eye = torch.eye(3, dtype=X.dtype, device=X.device).expand(P, OPP, 3, 3)
    Jxi = torch.cat([eye, -lie.hat(xc)], -1)               # (P,OPP,3,6)
    Jc = Jproj @ Jxi                                       # (P,OPP,3,6)
    Jpt = Jproj @ Rg                                       # d xc / d X = R
    return r, Jc, Jpt, xc[..., 2] <= 0.0


def _inv3x3(A):
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    eps = torch.where(det >= 0, 1e-12, -1e-12)
    inv_det = 1.0 / torch.where(det.abs() > 1e-12, det, eps)
    adj = torch.stack([
        torch.stack([co00, co01, co02], -1),
        torch.stack([co10, co11, co12], -1),
        torch.stack([co20, co21, co22], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def schur_sums(oc, n_cam):
    """schur_blocks' two ordered sums for one problem's camera index oc
    (P,OPP): into the cameras, and into (landmark, camera) pairs. oc is
    the same in every LM iteration, so a BA plans them once."""
    P = oc.shape[0]
    pc = torch.arange(P, device=oc.device)[:, None] * n_cam + oc
    return IndexSum(oc.reshape(-1), n_cam), IndexSum(pc.reshape(-1),
                                                     P * n_cam)


def schur_blocks(r, Jc, Jpt, w, oc, n_cam, lam, sums=None):
    """Assemble the landmark-marginalised camera system.

    S = Hcc - sum_p U_p V_p^T with U_p[c] = sum_{o: oc=c} W_po Hpp_p^-1 and
    V_p[c] = sum_{o: oc=c} W_po, both built per landmark by an ordered sum.
    sums: schur_sums(oc, n_cam), made once per problem (None: made here).
    Returns dict(S (C,C,6,6), b_s (C,6), Hpp_inv, Wb, b_p) for the camera
    solve and the landmark back-substitution.
    """
    C = n_cam
    P, OPP = oc.shape
    dt, dev = r.dtype, r.device
    JcW = Jc * w[..., None, None]
    JptW = Jpt * w[..., None, None]
    Hpp = torch.einsum("pori,porj->pij", JptW, Jpt)        # (P,3,3)
    b_p = torch.einsum("pori,por->pi", JptW, r)            # (P,3)
    Wb = torch.einsum("pori,porj->poij", JcW, Jpt)         # (P,OPP,6,3)

    diag = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    Hpp_d = Hpp + lam * torch.diag_embed(diag) + 1e-6 * eye3
    Hpp_inv = _inv3x3(Hpp_d)
    Y = torch.einsum("poij,pjk->poik", Wb, Hpp_inv)        # (P,OPP,6,3)

    Houter = torch.einsum("pori,porj->poij", JcW, Jc)      # (P,OPP,6,6)
    Jr = torch.einsum("pori,por->poi", JcW, r)             # (P,OPP,6)
    Yb = torch.einsum("poik,pk->poi", Y, b_p)              # (P,OPP,6)

    # one sum per index: the camera's (Hcc, b_c, yb), and per landmark the
    # camera-aggregated factors (U, V)
    N = P * OPP
    cam_sum, pair_sum = sums or schur_sums(oc, C)
    cam_sums = cam_sum(torch.cat(
        [Houter.reshape(N, 36), Jr.reshape(N, 6), Yb.reshape(N, 6)], -1))
    Hcc = cam_sums[:, :36].reshape(C, 6, 6)
    b_c, yb = cam_sums[:, 36:42], cam_sums[:, 42:]
    UV = pair_sum(torch.cat([Y.reshape(N, 18), Wb.reshape(N, 18)], -1)
                  ).reshape(P, C, 2, 6, 3)
    U, V = UV[:, :, 0], UV[:, :, 1]
    S = -torch.einsum("pcik,pdjk->cdij", U, V)
    eye_c = torch.eye(C, dtype=dt, device=dev)
    S = S + eye_c[:, :, None, None] * Hcc[:, None, :, :]
    return dict(S=S, b_s=b_c - yb, Hpp_inv=Hpp_inv, Wb=Wb, b_p=b_p)


def solve_camera_system(S, b_s, cam_free, lam, cg_iters=48):
    """Solve the reduced camera system with Levenberg damping and Jacobi
    equilibration; fixed/padded cameras clamped to identity rows. Jacobi-
    preconditioned CG, the JAX package's solver step for step (LM is a
    damped outer iteration, so an inexact inner solve is fine).

    S (C,C,6,6), b_s (C,6), cam_free (C,) bool -> dx_c (C,6).
    """
    C = b_s.shape[0]
    Sd = S.permute(0, 2, 1, 3).reshape(6 * C, 6 * C)
    diag = torch.diagonal(Sd)
    Sd = Sd + torch.diag(lam * diag)
    free6 = cam_free.to(Sd.dtype).repeat_interleave(6)
    Sd = Sd * free6[:, None] * free6[None, :] + torch.diag(1.0 - free6)
    d = torch.sqrt(torch.clamp(torch.diagonal(Sd).abs(), min=1e-8))
    Sd = Sd / d[:, None] / d[None, :]
    rhs = (-b_s.reshape(-1) * free6) / d
    Minv = 1.0 / torch.clamp(torch.diagonal(Sd), min=1e-8)
    x = torch.zeros_like(rhs)
    r = rhs
    z = Minv * rhs
    p = z
    for _ in range(cg_iters):
        Sp = Sd @ p
        rz = torch.dot(r, z)
        alpha = rz / torch.clamp(torch.dot(p, Sp), min=1e-12)
        x = x + alpha * p
        r2 = r - alpha * Sp
        z2 = Minv * r2
        beta = torch.dot(r2, z2) / torch.clamp(rz, min=1e-12)
        r, z, p = r2, z2, z2 + beta * p
    return (x / d).reshape(C, 6)


def backsub_points(blocks, dx_c, oc):
    """Landmark update given camera step: dx_p = Hpp^-1 (-b_p - W^T dx_c)."""
    dxg = dx_c[oc]
    Wt_dxc = torch.einsum("poij,poi->pj", blocks["Wb"], dxg)
    return torch.einsum("pij,pj->pi", blocks["Hpp_inv"],
                        -blocks["b_p"] - Wt_dxc)
