"""Sim(3) estimation for loop closure — Horn's method, batched RANSAC.

Port of ar_orbslam2_tpu/estimation/sim3_solver.py (the redesign of
Sim3Solver, src/Sim3Solver.cc, and Optimizer::OptimizeSim3): a fixed batch
of Horn 3-point solves (one batched 4x4 ``eigh``) scored in one two-way
reprojection pass, then a Gauss-Newton loop on the 7-dof tangent with
bidirectional residuals. None of it was a hand kernel in the JAX package
(XLA code), so it is plain torch here: float32, no TF32, no host read.

The sample draw comes from an explicit ``torch.Generator`` on the inputs'
device, or from ``samples=`` (the two frameworks draw different numbers
from one seed, so a test hands both the same draw). The Jacobian of the
stacked residual is ``torch.func.jacfwd``, as ``jax.jacfwd`` in the JAX
package.
"""
from __future__ import annotations

import torch
from torch.func import jacfwd

from ..core import camera as cam_mod
from ..core import lie
from .pnp import draw_samples

CHI2_2DOF_99 = 9.210   # parity: Sim3Solver mvnMaxError (9.21 sigma^2)


def horn_sim3(p1, p2, fix_scale=False):
    """Closed-form similarity S12 (p1 ~ s R p2 + t) from paired 3D points.

    Parity: Sim3Solver::ComputeSim3 (Horn 1987, quaternion method).
    p1, p2: (..., N, 3); leading dimensions are a batch of samples.
    Returns (R (..., 3, 3), t (..., 3), s (...,)).
    """
    c1 = p1.mean(-2)
    c2 = p2.mean(-2)
    q1 = p1 - c1[..., None, :]
    q2 = p2 - c2[..., None, :]
    M = q2.transpose(-1, -2) @ q1                    # maps 2 -> 1
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], -2)
    _, V = torch.linalg.eigh(N)
    q = V[..., :, -1]                                # (w, x, y, z)
    R = lie.quat_to_rot(torch.cat([q[..., 1:], q[..., :1]], -1))
    if fix_scale:
        s = torch.ones_like(c1[..., 0])
    else:
        # s12 = <q1, R q2> / |q2|^2 (the reference's nom/den)
        rq2 = q2 @ R.transpose(-1, -2)
        s = (q1 * rq2).sum((-1, -2)) / torch.clamp(
            (q2 * q2).sum((-1, -2)), min=1e-12)
    t = c1 - s[..., None] * (R @ c2[..., None])[..., 0]
    return R, t, s


@torch.no_grad()
def sim3_ransac(cam, p1, p2, uv1, uv2, oct1, oct2, valid, generator=None,
                n_hyp=256, fix_scale=False, scale_factor=1.2, samples=None):
    """RANSAC Sim3 between two keyframes from matched landmark pairs.

    Args:
      p1/p2: (N,3) matched landmark positions in CAMERA coords of KF1/KF2.
      uv1/uv2: (N,2) observed keypoints in each image; oct1/oct2 levels.
      valid: (N,) bool real matches. `generator` on the inputs' device, or
      `samples` (n_hyp, 3) integer indices to use instead of a draw.
    Returns dict(R12, t12, s12, inlier (N,), n_inliers, ok) of tensors.
    """
    if samples is None:
        samples = draw_samples(valid, n_hyp, generator, size=3)
    samples = samples.long()
    Rs, ts, ss = horn_sim3(p1[samples], p2[samples], fix_scale=fix_scale)

    # two-way reprojection check (Sim3Solver::CheckInliers), (H, N)
    sig1 = scale_factor ** (2.0 * oct1.to(torch.float32))
    sig2 = scale_factor ** (2.0 * oct2.to(torch.float32))
    x1 = ss[:, None, None] * torch.einsum("hij,nj->hni", Rs, p2) \
        + ts[:, None, :]                             # p2 -> cam1: S12 p2
    e1 = ((cam_mod.project(cam, x1) - uv1) ** 2).sum(-1)
    # p1 -> cam2: S21 = (1/s) R^T (p1 - t)
    x2 = torch.einsum("hni,hij->hnj", p1[None] - ts[:, None, :], Rs) \
        / torch.clamp(ss, min=1e-12)[:, None, None]
    e2 = ((cam_mod.project(cam, x2) - uv2) ** 2).sum(-1)
    inls = (e1 < CHI2_2DOF_99 * sig1) & (e2 < CHI2_2DOF_99 * sig2) \
        & (x1[..., 2] > 0) & (x2[..., 2] > 0) & valid
    counts = inls.to(torch.int32).sum(-1)
    finite = (torch.isfinite(Rs).all(-1).all(-1) & torch.isfinite(ts).all(-1)
              & torch.isfinite(ss) & (ss > 1e-6))
    counts = torch.where(finite, counts, torch.full_like(counts, -1))
    best = torch.argmax(counts)
    return dict(R12=Rs[best], t12=ts[best], s12=ss[best], inlier=inls[best],
                n_inliers=counts[best], ok=counts[best] >= 6)


def optimize_sim3(cam, R0, t0, s0, p1, p2, uv1, uv2, oct1, oct2, valid,
                  n_iters=10, fix_scale=False, scale_factor=1.2,
                  chi2_th=10.0):
    """Gauss-Newton refinement of S12 with bidirectional residuals.

    Parity: Optimizer::OptimizeSim3 (EdgeSim3ProjectXYZ +
    EdgeInverseSim3ProjectXYZ, chi2 gate 10). Returns dict(R12, t12, s12,
    inlier, n_inliers) of tensors; no host read.
    """
    sig1 = scale_factor ** (-2.0 * oct1.to(torch.float32))
    sig2 = scale_factor ** (-2.0 * oct2.to(torch.float32))
    dev = p1.device
    eye7 = torch.eye(7, dtype=torch.float32, device=dev)

    S0 = (R0[None], t0[None], s0.reshape(1))

    def residuals(v):
        # a batch of one: under jacfwd's vmap a 0-dim float32 tensor
        # combined with a Python number gets a float64 tangent (torch
        # 2.13), so no 0-dim tensor enters the Lie functions
        Rc, tc, sc = lie.sim3_mul(*lie.sim3_exp(v[None]), *S0)
        x1 = sc[:, None] * (p2 @ Rc[0].T) + tc
        r1 = cam_mod.project(cam, x1) - uv1
        Ri, ti, si = lie.sim3_inv(Rc, tc, sc)
        x2 = si[:, None] * (p1 @ Ri[0].T) + ti
        r2 = cam_mod.project(cam, x2) - uv2
        return r1, r2, x1[..., 2], x2[..., 2]

    def stack_res(v):
        r1, r2, _, _ = residuals(v)
        return torch.cat([r1.reshape(-1), r2.reshape(-1)])

    def chi2(r1, r2):
        return (r1 * r1).sum(-1) * sig1, (r2 * r2).sum(-1) * sig2

    v = torch.zeros(7, dtype=torch.float32, device=dev)
    with torch.no_grad():
        r1, r2, _, _ = residuals(v)
        c1, c2 = chi2(r1, r2)
        inlier = (c1 < chi2_th) & (c2 < chi2_th) & valid
    for _ in range(n_iters):
        J = jacfwd(stack_res)(v)                      # (4N, 7)
        with torch.no_grad():
            r1, r2, z1, z2 = residuals(v)
            r = torch.cat([r1.reshape(-1), r2.reshape(-1)])
            w1 = torch.where(inlier & valid & (z1 > 0), sig1,
                             torch.zeros_like(sig1))
            w2 = torch.where(inlier & valid & (z2 > 0), sig2,
                             torch.zeros_like(sig2))
            w = torch.cat([w1.repeat_interleave(2), w2.repeat_interleave(2)])
            JW = J * w[:, None]
            Hm = JW.T @ J + 1e-6 * eye7
            b = JW.T @ r
            if fix_scale:       # the scale dof is the last coordinate
                mask = torch.ones(7, dtype=torch.float32, device=dev)
                mask[6] = 0.0
                Hm = Hm * mask[:, None] * mask[None, :] \
                    + (1.0 - mask)[:, None] * (1.0 - mask)[None, :]
                b = b * mask
            dv = -torch.linalg.solve_ex(Hm, b).result   # no host sync
            v = lie.sim3_log(*lie.sim3_mul(*lie.sim3_exp(dv[None]),
                                           *lie.sim3_exp(v[None])))[0]
            r1n, r2n, z1n, z2n = residuals(v)
            c1n, c2n = chi2(r1n, r2n)
            inlier = (c1n < chi2_th) & (c2n < chi2_th) & (z1n > 0) \
                & (z2n > 0)
    with torch.no_grad():
        R, t, s = lie.sim3_mul(*lie.sim3_exp(v[None]), *S0)
        inlier = inlier & valid
    return dict(R12=R[0], t12=t[0], s12=s[0], inlier=inlier,
                n_inliers=inlier.to(torch.int32).sum())
