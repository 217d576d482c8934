"""Bundle adjustment with dense-blocked Schur complement.

Port of ar_orbslam2_tpu/estimation/local_ba.py (the reference's
Optimizer::LocalBundleAdjustment): fixed-shape observation tables grouped
per landmark, batched Jacobians and Huber weights, closed-form 3x3
landmark inverses, a dense Schur-reduced camera system solved by
equilibrated CG, Levenberg damping with accept/reject.

The JAX package's early-exit ``while_loop`` per phase becomes a fixed
iteration count that carries ``done`` as a tensor and freezes the state
once it is set — the same result, with no host sync per iteration.
"""
from __future__ import annotations

import torch

from ..core import lie
from ..core.robust import CHI2_2DOF, CHI2_3DOF, huber_weight
from . import ba_core

BEHIND_PENALTY = 1e6


def bundle_adjust(cam_R, cam_t, cam_fixed, cam_valid,
                  pts, pt_valid,
                  obs_cam, obs_uv, obs_octave, obs_valid,
                  cam, obs_uvr=None,
                  n_iters_1=5, n_iters_2=10, scale_factor=1.2):
    """Levenberg-Marquardt BA over (cameras, landmarks).

    Args:
      cam_R (C,3,3), cam_t (C,3): world->camera poses.
      cam_fixed (C,) bool: poses held constant. cam_valid (C,) bool: padding.
      pts (P,3), pt_valid (P,): landmarks.
      obs_cam (P,OPP) int: camera index of each observation (-1 pad).
      obs_uv (P,OPP,2), obs_octave (P,OPP), obs_valid (P,OPP) bool.
      obs_uvr (P,OPP) or None: stereo right-u (<0 => mono observation).
      n_iters_1 / n_iters_2: LM iterations before / after the mid-way
        chi2 outlier strip (LocalBundleAdjustment's 5 + 10).
    Returns:
      dict(cam_R, cam_t, pts, obs_inlier (P,OPP) bool, cost).
    """
    C = cam_R.shape[0]
    P, OPP = obs_cam.shape
    dev, f32 = pts.device, torch.float32
    oc = torch.clamp(obs_cam.long(), min=0)
    inv_sigma2 = scale_factor ** (-2.0 * obs_octave.to(f32))
    if obs_uvr is None:
        obs_uvr = torch.full((P, OPP), -1.0, dtype=f32, device=dev)
    stereo = obs_uvr > 0
    chi2_th = torch.where(stereo, CHI2_3DOF, CHI2_2DOF)
    cam_valid_o = cam_valid[oc].to(f32)
    cam_fixed_o = cam_fixed[oc]
    obs_valid_f = obs_valid.to(f32)
    pt_valid_f = pt_valid.to(f32)[:, None]
    sums = ba_core.schur_sums(oc, C)

    def residuals(R_all, t_all, X):
        return ba_core.ba_residuals(cam, R_all, t_all, X, oc,
                                    obs_uv, obs_uvr, stereo)

    def edge_chi2(r):
        return (r * r).sum(-1) * inv_sigma2

    def lm_step(R_all, t_all, X, inlier, lam, rjac):
        r, Jc, Jpt, behind = rjac
        c2 = edge_chi2(r)
        w_h = huber_weight(c2, chi2_th)
        inl_f = inlier.to(f32)
        w = inv_sigma2 * w_h * inl_f * obs_valid_f * (~behind).to(f32) \
            * pt_valid_f * cam_valid_o
        # fixed cameras: their residuals constrain POINTS but produce no
        # camera gradient -> zero their Jc
        Jcz = torch.where(cam_fixed_o[..., None, None], torch.zeros_like(Jc),
                          Jc)
        blocks = ba_core.schur_blocks(r, Jcz, Jpt, w, oc, C, lam, sums)
        dx_c = ba_core.solve_camera_system(
            blocks["S"], blocks["b_s"], cam_valid & ~cam_fixed, lam)
        dx_p = ba_core.backsub_points(blocks, dx_c, oc)

        dR, dt = lie.se3_exp(dx_c)
        R_new, t_new = lie.se3_mul(dR, dt, R_all, t_all)
        R_new = torch.where(cam_fixed[:, None, None], R_all, R_new)
        t_new = torch.where(cam_fixed[:, None], t_all, t_new)
        X_new = torch.where(pt_valid[:, None], X + dx_p, X)

        # accept / reject on the robustified cost; behind-camera
        # observations are PENALIZED (a step that throws points behind the
        # cameras must read as a cost increase)
        mask = inl_f * obs_valid_f * pt_valid_f * cam_valid_o
        rjac_new = residuals(R_new, t_new, X_new)
        r2, _, _, behind2 = rjac_new
        c2n = edge_chi2(r2)
        w_hn = huber_weight(c2n, chi2_th)
        cost_old = (torch.where(behind, BEHIND_PENALTY, c2 * w_h)
                    * mask).sum()
        cost_new = (torch.where(behind2, BEHIND_PENALTY, c2n * w_hn)
                    * mask).sum()
        accept = cost_new < cost_old
        lam_next = torch.clamp(torch.where(accept, lam * 0.4, lam * 5.0),
                               1e-7, 1e4)
        # converged: an accepted step barely moved the robust cost
        done = accept & (cost_old - cost_new < 1e-5 * (cost_old + 1e-6))
        return (R_new, t_new, X_new, rjac_new), accept, lam_next, done

    def run_phase(R_all, t_all, X, inlier, lam, rjac, n_iters):
        done = torch.zeros((), dtype=torch.bool, device=dev)
        for _ in range(n_iters):
            new, accept, lam_next, step_done = lm_step(
                R_all, t_all, X, inlier, lam, rjac)
            take = accept & ~done                 # frozen once converged
            R_all = torch.where(take, new[0], R_all)
            t_all = torch.where(take, new[1], t_all)
            X = torch.where(take, new[2], X)
            rjac = tuple(torch.where(take, a, b)
                         for a, b in zip(new[3], rjac))
            lam = torch.where(done, lam, lam_next)
            done = done | step_done
        return R_all, t_all, X, lam, rjac

    lam = torch.full((), 1e-4, dtype=f32, device=dev)  # no H2D sync
    rjac = residuals(cam_R, cam_t, pts)
    R_all, t_all, X, lam, rjac = run_phase(cam_R, cam_t, pts, obs_valid,
                                           lam, rjac, n_iters_1)
    # mid-way outlier strip (LocalBundleAdjustment chi2 gate)
    r, _, _, behind = rjac
    inlier = (edge_chi2(r) <= chi2_th) & ~behind & obs_valid
    R_all, t_all, X, lam, rjac = run_phase(R_all, t_all, X, inlier,
                                           lam, rjac, n_iters_2)

    r, _, _, behind = rjac            # residuals at the final state
    c2 = edge_chi2(r)
    inlier = (c2 <= chi2_th) & ~behind & obs_valid
    cost = torch.where(inlier, c2, torch.zeros_like(c2)).sum()
    return dict(cam_R=R_all, cam_t=t_all, pts=X, obs_inlier=inlier,
                cost=cost)
