"""Distributed Schur-complement bundle adjustment on torch.distributed.

Port of ar_orbslam2_tpu/parallel/dist_ba.py. The landmark axis of the
camera-landmark system is sharded over the ranks of a process group (one
rank per process, SPMD: every rank runs the same calls in the same
order); each rank assembles the Schur contributions of its landmark slice
through the port's ba_core, the camera-reduced system is summed across
the ranks, every rank solves the small camera system itself (the same
inputs give it the same step), and the landmark back-substitution stays
on its rank. torch has no in-process multi-device collectives, so the
JAX package's mesh of devices becomes a group of processes.

Communication per LM iteration, counted in ``Mesh.calls``:
  dense  — one all_reduce of the (C,C,6,6) system and its (C,6) right-hand
           side packed together (the JAX ``psum`` of S and b_s), and one of
           the two costs, so 2; one more for the final cost;
  banded — one all_gather of every rank's (W,W,6,6) band and (W,6)
           right-hand side packed together, each placed at its rank's
           camera offset (the JAX ``assemble``), and one all_reduce of the
           two costs, so 2; the offsets are gathered once before the loop.
The volume is independent of the landmark count.

Usage: ``mesh = make_mesh()`` in every rank of an initialized group
(parallel/multihost.py starts one), ``shard_point_arrays`` for the
landmark-axis arrays, ``replicate`` for the camera arrays, then
``dist_bundle_adjust``; ``gather_points`` brings the landmark results back
to every rank.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..core import lie
from ..core.device import resolve_device
from ..core.robust import CHI2_2DOF, CHI2_3DOF, huber_weight
from ..estimation import ba_core


@dataclass
class Mesh:
    """One process group seen from this rank: its size, this rank's place
    in it and the device its tensors live on. ``calls`` counts the
    collectives issued through it."""
    group: object
    world_size: int
    rank: int
    device: torch.device
    backend: str
    calls: int = 0


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh over `group` (None: the default group). The device comes
    from core.device.resolve_device; on NCCL it is ``cuda:<local rank>``
    (LOCAL_RANK, else the rank modulo the visible cards). Raises when no
    group is initialized: there is no silent single-rank path."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group is initialized: start one "
            "(parallel.multihost.initialize_from_env / spawn_local) before "
            "asking for the distributed BA")
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    backend = dist.get_backend(group)
    if device is None and backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % max(torch.cuda.device_count(), 1)))
        device = f"cuda:{local}"
    return Mesh(group, world, rank, resolve_device(device), backend)


def _on_device(mesh, a):
    return torch.as_tensor(np.ascontiguousarray(a) if isinstance(
        a, np.ndarray) else a, device=mesh.device)


def shard_point_arrays(mesh, *arrays):
    """This rank's contiguous slice of the leading (landmark) axis of each
    array, on the mesh's device. P must be divisible by the world size
    (pad with pt_valid=False rows)."""
    out = []
    for a in arrays:
        P = a.shape[0]
        assert P % mesh.world_size == 0, \
            "pad landmark axis to a multiple of mesh size"
        n = P // mesh.world_size
        out.append(_on_device(mesh, a[mesh.rank * n:(mesh.rank + 1) * n]))
    return tuple(out)


def replicate(mesh, *arrays):
    """The camera arrays, whole, on the mesh's device."""
    return tuple(_on_device(mesh, a) for a in arrays)


def _all_reduce(mesh, x):
    """Sum `x` over the ranks, in place."""
    mesh.calls += 1
    dist.all_reduce(x, group=mesh.group)
    return x


def _all_gather(mesh, x):
    """(world_size, *x.shape): every rank's `x`, in rank order."""
    mesh.calls += 1
    out = torch.empty((mesh.world_size * x.numel(),), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x.reshape(-1).contiguous(),
                                group=mesh.group)
    return out.reshape(mesh.world_size, *x.shape)


def gather_points(mesh, x):
    """All ranks' landmark slices of `x`, concatenated in rank order: the
    full landmark axis on every rank (for the write-back)."""
    return _all_gather(mesh, x).reshape(-1, *x.shape[1:])


def _split(flat, *shapes):
    out, at = [], 0
    for shp in shapes:
        n = int(np.prod(shp))
        out.append(flat[at:at + n].reshape(shp))
        at += n
    return out


def _lm(mesh, cam_R, cam_t, cam_fixed, cam_valid, pts, pt_valid, obs_cam,
        obs_uv, obs_octave, obs_valid, cam, obs_uvr, n_iters, scale_factor,
        lo, W, camera_system):
    """The LM of both routes on this rank's landmark slice, whose
    observations index the camera window [lo, lo + W) (dense: the whole
    camera axis). `camera_system(S_w, b_w)` exchanges the window's Schur
    contribution and returns the full (C,C,6,6) system and (C,6)
    right-hand side, the same on every rank."""
    f32 = torch.float32
    P_loc, OPP = obs_cam.shape
    oc = torch.clamp(obs_cam.long(), min=0)
    if obs_uvr is None:
        obs_uvr = torch.full((P_loc, OPP), -1.0, dtype=f32, device=pts.device)
    stereo = obs_uvr > 0
    inv_sigma2 = scale_factor ** (-2.0 * obs_octave.to(f32))
    chi2_th = torch.where(stereo, CHI2_3DOF, CHI2_2DOF)
    cam_valid_o = cam_valid[lo:lo + W][oc].to(f32)
    cam_fixed_o = cam_fixed[lo:lo + W][oc]
    base = obs_valid.to(f32) * pt_valid.to(f32)[:, None] * cam_valid_o
    cam_free = cam_valid & ~cam_fixed

    def residuals(R_all, t_all, X):
        return ba_core.ba_residuals(cam, R_all[lo:lo + W], t_all[lo:lo + W],
                                    X, oc, obs_uv, obs_uvr, stereo)

    def edge_chi2(r):
        return (r * r).sum(-1) * inv_sigma2

    def lm_step(R_all, t_all, X, inlier, lam, rjac):
        r, Jc, Jpt, behind = rjac
        c2 = edge_chi2(r)
        w_h = huber_weight(c2, chi2_th)
        mask = inlier.to(f32) * base
        w = inv_sigma2 * w_h * mask * (~behind).to(f32)
        Jcz = torch.where(cam_fixed_o[..., None, None], torch.zeros_like(Jc),
                          Jc)
        blocks = ba_core.schur_blocks(r, Jcz, Jpt, w, oc, W, lam)
        S, b_s = camera_system(blocks["S"], blocks["b_s"])
        dx_c = ba_core.solve_camera_system(S, b_s, cam_free, lam)
        dx_p = ba_core.backsub_points(blocks, dx_c[lo:lo + W], oc)

        dR, dt = lie.se3_exp(dx_c)
        R_new, t_new = lie.se3_mul(dR, dt, R_all, t_all)
        R_new = torch.where(cam_fixed[:, None, None], R_all, R_new)
        t_new = torch.where(cam_fixed[:, None], t_all, t_new)
        X_new = torch.where(pt_valid[:, None], X + dx_p, X)

        rjac_new = residuals(R_new, t_new, X_new)
        r2, _, _, behind2 = rjac_new
        c2n = edge_chi2(r2)
        w_hn = huber_weight(c2n, chi2_th)
        costs = _all_reduce(mesh, torch.stack([
            (c2 * w_h * mask * (~behind).to(f32)).sum(),
            (c2n * w_hn * mask * (~behind2).to(f32)).sum()]))
        accept = costs[1] < costs[0]
        R_all = torch.where(accept, R_new, R_all)
        t_all = torch.where(accept, t_new, t_all)
        X = torch.where(accept, X_new, X)
        rjac = tuple(torch.where(accept, a, b) for a, b in zip(rjac_new,
                                                               rjac))
        lam = torch.clamp(torch.where(accept, lam * 0.4, lam * 5.0),
                          1e-7, 1e4)
        return R_all, t_all, X, lam, rjac

    lam = torch.full((), 1e-4, dtype=f32, device=pts.device)
    R_all, t_all, X = cam_R, cam_t, pts
    rjac = residuals(R_all, t_all, X)
    inlier = obs_valid
    n1 = max(n_iters // 3, 1)
    for i in range(n_iters):
        if i == n1:         # mid-way outlier strip (LocalBundleAdjustment)
            r, _, _, behind = rjac
            inlier = (edge_chi2(r) <= chi2_th) & ~behind & obs_valid
        R_all, t_all, X, lam, rjac = lm_step(R_all, t_all, X, inlier, lam,
                                             rjac)
    r, _, _, behind = rjac
    c2 = edge_chi2(r)
    inlier = (c2 <= chi2_th) & ~behind & obs_valid
    cost = _all_reduce(mesh, torch.where(inlier, c2,
                                         torch.zeros_like(c2)).sum())
    return dict(cam_R=R_all, cam_t=t_all, pts=X, obs_inlier=inlier,
                cost=cost)


def dist_bundle_adjust(mesh, cam_R, cam_t, cam_fixed, cam_valid,
                       pts, pt_valid,
                       obs_cam, obs_uv, obs_octave, obs_valid,
                       cam, obs_uvr=None,
                       n_iters=10, scale_factor=1.2):
    """LM bundle adjustment with the landmark axis sharded over `mesh`.

    Same problem layout as estimation.local_ba.bundle_adjust; the landmark
    arrays are this rank's slice (shard_point_arrays), the camera arrays
    whole (replicate). Returns dict(cam_R, cam_t, pts (this rank's slice),
    obs_inlier (this rank's slice), cost (summed over the ranks)).
    """
    C = cam_R.shape[0]

    def camera_system(S, b_s):
        flat = _all_reduce(mesh, torch.cat([S.reshape(-1), b_s.reshape(-1)]))
        return _split(flat, (C, C, 6, 6), (C, 6))
    return _lm(mesh, cam_R, cam_t, cam_fixed, cam_valid, pts, pt_valid,
               obs_cam, obs_uv, obs_octave, obs_valid, cam, obs_uvr,
               n_iters, scale_factor, 0, C, camera_system)


def dist_bundle_adjust_banded(mesh, cam_R, cam_t, cam_fixed, cam_valid,
                              pts, pt_valid,
                              obs_cam, obs_uv, obs_octave, obs_valid,
                              cam, band_off, band_w, obs_uvr=None,
                              n_iters=10, scale_factor=1.2):
    """Landmark-sharded BA with a BANDED (compressed) camera exchange.

    Requires the covisibility-partitioned layout (partition.banded_layout,
    mapping.global_ba.gather_global_partitioned): the camera axis is in
    covisibility-BFS order and this rank's landmark slice only observes
    cameras inside its band [band_off, band_off + band_w). Each rank
    assembles its Schur contribution in band-local coordinates, a (6W)^2
    system instead of (6C)^2, and the per-iteration exchange is an
    all_gather of the bands (world_size * ((6W)^2 + 6W) floats) plus the
    cost all_reduce, sublinear in C for a fixed window width W.

    band_off: this rank's band start, an int or a one-element array
    (shard_point_arrays of the per-rank offsets). band_w: the common band
    width; obs_cam holds band-local indices in [0, W). cam_R / cam_t / ...
    are in the permuted camera order; the caller un-permutes results.
    """
    C = cam_R.shape[0]
    W = int(band_w)
    off = torch.as_tensor(band_off, device=mesh.device).reshape(
        -1)[:1].to(torch.int64)
    offs = [int(o) for o in _all_gather(mesh, off).reshape(-1).tolist()]
    lo = offs[mesh.rank]

    def camera_system(S_w, b_w):
        bands = _all_gather(mesh, torch.cat([S_w.reshape(-1),
                                             b_w.reshape(-1)]))
        S = torch.zeros((C, C, 6, 6), dtype=S_w.dtype, device=S_w.device)
        b_s = torch.zeros((C, 6), dtype=b_w.dtype, device=b_w.device)
        for o, flat in zip(offs, bands):
            S_i, b_i = _split(flat, (W, W, 6, 6), (W, 6))
            S[o:o + W, o:o + W] += S_i
            b_s[o:o + W] += b_i
        return S, b_s
    return _lm(mesh, cam_R, cam_t, cam_fixed, cam_valid, pts, pt_valid,
               obs_cam, obs_uv, obs_octave, obs_valid, cam, obs_uvr,
               n_iters, scale_factor, lo, W, camera_system)
