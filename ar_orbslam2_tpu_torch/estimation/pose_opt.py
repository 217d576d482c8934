"""Motion-only bundle adjustment (pose-only Levenberg-Marquardt on SE3).

Port of ar_orbslam2_tpu/estimation/pose_opt.py (the reference's
Optimizer::PoseOptimization): dense per-point residual/Jacobian tensors,
Huber as IRLS weights, 4 rounds x 10 LM iterations with a chi2 inlier
re-classification per round.

The JAX package stops a round early with a device ``while_loop`` and runs
its 6x6 CG solve as a ``lax.scan``. Here both are fixed-count Python loops
that carry ``done`` as a tensor and mask every update once it is set: the
same result, with no host sync inside the loop.

Pose convention: Tcw with LEFT-multiplicative update T <- exp(xi) * T,
xi = (rho, omega).
"""
from __future__ import annotations

import torch

from ..core import lie
from ..core.robust import CHI2_2DOF, CHI2_3DOF, huber_weight

BEHIND_PENALTY = 1e6


def reproj_residual_jac(R, t, xw, cam):
    """Returns (xc, J_xc) where J_xc (N, 3, 6) = d(xc)/d(xi) for the left
    update xc' = exp(xi) applied to (R xw + t): J = [I | -hat(xc)]."""
    xc = (xw @ R.T) + t
    N = xw.shape[0]
    eye = torch.eye(3, dtype=xw.dtype, device=xw.device).expand(N, 3, 3)
    J = torch.cat([eye, -lie.hat(xc)], dim=-1)          # (N,3,6)
    return xc, J


def _solve6(H, b, n_iters=10):
    """6x6 SPD solve as Jacobi-preconditioned CG (exact in <= 6 steps in
    exact arithmetic), the JAX package's solver step for step."""
    Minv = 1.0 / torch.clamp(torch.diagonal(H), min=1e-12)
    x = torch.zeros_like(b)
    r = b
    z = Minv * b
    p = z
    for _ in range(n_iters):
        Hp = H @ p
        rz = torch.dot(r, z)
        alpha = rz / torch.clamp(torch.dot(p, Hp), min=1e-20)
        x = x + alpha * p
        r2 = r - alpha * Hp
        z2 = Minv * r2
        beta = torch.dot(r2, z2) / torch.clamp(rz, min=1e-20)
        r, z, p = r2, z2, z2 + beta * p
    return x


def _proj_jacobian(cam, xc):
    """d(u,v)/d(xc): (N, 2, 3)."""
    x, y = xc[..., 0], xc[..., 1]
    z = torch.clamp(xc[..., 2], min=1e-6)
    iz = 1.0 / z
    iz2 = iz * iz
    zero = torch.zeros_like(z)
    row_u = torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], -1)
    row_v = torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], -1)
    return torch.stack([row_u, row_v], -2)


def pose_optimization(R0, t0, xw, uv, octave, valid, cam,
                      uv_right=None, n_rounds=4, n_iters=10,
                      scale_factor=1.2, chi2_mono=CHI2_2DOF,
                      chi2_stereo=CHI2_3DOF):
    """Optimize Tcw from 3D-2D matches, with per-round outlier gating.

    Args:
      R0, t0: initial world->camera pose. xw: (N, 3) landmark positions.
      uv: (N, 2) observed keypoints. octave: (N,) pyramid level ->
      information 1/scale^(2*oct). valid: (N,) bool — real matches.
      uv_right: optional (N,) right-image u (NaN/neg for mono points).
    Returns:
      dict(R, t, inlier (N,) bool, n_inliers, chi2) — tensors.
    """
    dev, f32 = xw.device, torch.float32
    inv_sigma2 = scale_factor ** (-2.0 * octave.to(f32))
    if uv_right is not None:
        stereo_mask = (uv_right > 0) & valid
    else:
        uv_right = torch.zeros(uv.shape[0], dtype=uv.dtype, device=dev)
        stereo_mask = torch.zeros(uv.shape[0], dtype=torch.bool, device=dev)
    validf = valid.to(f32)

    def residuals(R, t):
        xc, J_xi = reproj_residual_jac(R, t, xw, cam)
        z = torch.clamp(xc[..., 2], min=1e-6)
        u = cam.fx * xc[..., 0] / z + cam.cx
        v = cam.fy * xc[..., 1] / z + cam.cy
        r_uv = torch.stack([u, v], -1) - uv              # (N,2)
        Jp = _proj_jacobian(cam, xc)                     # (N,2,3)
        J_uv = Jp @ J_xi                                 # (N,2,6)
        u_r = u - cam.bf / z                             # stereo residual
        r_r = torch.where(stereo_mask, u_r - uv_right, torch.zeros_like(u))
        J_r3 = Jp[:, 0, :] + torch.stack(
            [torch.zeros_like(z), torch.zeros_like(z), cam.bf / (z * z)], -1)
        J_r = (J_r3[:, None, :] @ J_xi)[:, 0, :]         # (N,6)
        J_r = torch.where(stereo_mask[:, None], J_r, torch.zeros_like(J_r))
        r = torch.cat([r_uv, r_r[:, None]], -1)          # (N,3)
        J = torch.cat([J_uv, J_r[:, None, :]], -2)       # (N,3,6)
        behind = xc[..., 2] <= 0.0
        return r, J, behind

    def edge_chi2(r):
        return (r * r).sum(-1) * inv_sigma2

    chi2_th = torch.where(stereo_mask, chi2_stereo, chi2_mono)
    eye6 = torch.eye(6, dtype=f32, device=dev)

    def run_round(R, t, inlier, rjac, use_huber):
        lam = torch.full((), 1e-3, dtype=f32, device=dev)  # no H2D sync
        done = torch.zeros((), dtype=torch.bool, device=dev)
        inl_f = inlier.to(f32)
        for _ in range(n_iters):
            r, J, behind = rjac
            c2 = edge_chi2(r)
            w_huber = huber_weight(c2, chi2_th) if use_huber \
                else torch.ones_like(c2)
            w = inv_sigma2 * w_huber * inl_f * validf * (~behind).to(f32)
            JW = J * w[:, None, None]
            Hmat = torch.einsum("nri,nrj->ij", JW, J)
            bvec = torch.einsum("nri,nr->i", JW, r)
            Hd = Hmat + lam * torch.diag(torch.diagonal(Hmat)) + 1e-8 * eye6
            dx = -_solve6(Hd, bvec)
            R_new, t_new = lie.se3_mul(*lie.se3_exp(dx), R, t)
            # accept if the total robust chi2 decreased; behind-camera
            # points are PENALIZED so a wild step reads as a cost increase
            rjac_new = residuals(R_new, t_new)
            r_new, _, behind_new = rjac_new
            mask = inl_f * validf
            cost_old = (torch.where(behind, BEHIND_PENALTY, c2 * w_huber)
                        * mask).sum()
            c2n = edge_chi2(r_new)
            w_hn = huber_weight(c2n, chi2_th) if use_huber \
                else torch.ones_like(c2n)
            cost_new = (torch.where(behind_new, BEHIND_PENALTY, c2n * w_hn)
                        * mask).sum()
            accept = cost_new < cost_old
            take = accept & ~done                 # frozen once converged
            R = torch.where(take, R_new, R)
            t = torch.where(take, t_new, t)
            rjac = tuple(torch.where(take, a, b)
                         for a, b in zip(rjac_new, rjac))
            lam_next = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                                   1e-9, 1e6)
            step_done = (accept & (dx.abs().max() < 1e-5)) \
                | (~accept & (lam_next >= 1e6))
            lam = torch.where(done, lam, lam_next)
            done = done | step_done
        # re-classify inliers at round end (reference: per-round chi2 gate)
        r, _, behind = rjac
        inlier = (edge_chi2(r) <= chi2_th) & ~behind & valid
        return R, t, inlier, rjac

    R, t = R0, t0
    inlier = valid
    rjac = residuals(R, t)
    for rnd in range(n_rounds):
        # reference drops the robust kernel after 2 rounds
        R, t, inlier, rjac = run_round(R, t, inlier, rjac, rnd < 2)

    r, _, _ = rjac
    c2 = torch.where(inlier, edge_chi2(r), torch.zeros_like(r[:, 0]))
    return dict(R=R, t=t, inlier=inlier,
                n_inliers=inlier.to(torch.int32).sum(), chi2=c2.sum())


def compact_rows(mask, M):
    """Fixed-size compaction of the True rows of a boolean mask.

    Returns (gather_idx (M,) in range, scatter_idx (M,) = row index for
    valid slots / N for padding, sel_valid (M,) bool). Rows keep their
    original order; rows beyond the first M set ones are dropped. The JAX
    package's ``.at[].set(mode="drop")`` becomes a scatter into a buffer one
    row longer (the sink row M), sliced off afterwards.
    """
    N = mask.shape[0]
    dev = mask.device
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    dest = torch.where(mask & (pos < M), pos, M)
    gather_idx = torch.zeros(M + 1, dtype=torch.int64, device=dev)
    gather_idx[dest] = torch.arange(N, dtype=torch.int64, device=dev)
    gather_idx = gather_idx[:M]
    count = mask.to(torch.int64).sum()
    sel_valid = torch.arange(M, device=dev) < count
    scatter_idx = torch.where(sel_valid, gather_idx, N)
    return gather_idx, scatter_idx, sel_valid


def pose_optimization_compact(R0, t0, xw, uv, octave, valid, cam, M,
                              uv_right=None, **kw):
    """pose_optimization over only the `valid` rows, compacted to a fixed
    size M first (the padded call sites carry mostly invalid rows). Returns
    the same dict with `inlier` scattered back to the full row space."""
    N = xw.shape[0]
    gi, si, sel = compact_rows(valid, M)
    res = pose_optimization(
        R0, t0, xw[gi], uv[gi], octave[gi], sel, cam,
        uv_right=None if uv_right is None else uv_right[gi], **kw)
    inlier = torch.zeros(N + 1, dtype=torch.bool, device=xw.device)
    inlier[si] = res["inlier"] & sel
    return dict(res, inlier=inlier[:N])
