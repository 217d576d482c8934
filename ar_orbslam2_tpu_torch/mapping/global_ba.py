"""Full-map bundle adjustment: gather + run.

Port of ar_orbslam2_tpu/mapping/global_ba.py (parity:
Optimizer::GlobalBundleAdjustemnt, src/Optimizer.cc, sic, and
LoopClosing::RunGlobalBundleAdjustment): optimize every keyframe pose and
landmark against all observations, through the same Schur LM as local BA
(estimation/local_ba.bundle_adjust). Shapes are padded to power-of-two
buckets, as in the JAX package.

Three routes, as in the JAX package: one device
(estimation/local_ba.bundle_adjust), the landmark-sharded distributed BA
over the ranks of a torch.distributed group (``distributed``,
parallel/dist_ba.py) and its covisibility-banded camera exchange
(``banded``, on gather_global_partitioned's layout). ``distributed=None``
means distributed when an initialized group has more than one rank, as in
the JAX package. Every rank of the group runs the same call (SPMD) and
writes the full result back into its own store; unlike the JAX package's
devices, the ranks are processes, so a caller that acts for its own rank
alone (the loop closer, the background BA) passes ``distributed=False``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve_device
from ..core.lie import project_so3
from ..estimation.local_ba import bundle_adjust
from ..parallel import dist_ba
from ..parallel.partition import banded_layout

_KEYS = ("cam_R", "cam_t", "cam_fixed", "cam_valid", "pts", "pt_valid",
         "obs_cam", "obs_uv", "obs_oct", "obs_valid", "obs_uvr")


def _bucket(n, lo=16):
    b = lo
    while b < n:
        b *= 2
    return b


def gather_global(store, obs_bucket=None):
    """Pack the whole map into the fixed-shape BA problem.

    obs_bucket: cap on the observation axis. Default None = the store's
    full max_obs: global BA must see ALL observations (the late cross-loop
    re-observations are what it exists to optimize)."""
    s = store
    kf_ids = s.keyframe_ids()
    mp_ids = s.map_point_ids()
    C = _bucket(len(kf_ids))
    P = _bucket(len(mp_ids), lo=256)
    O = s.cfg.max_obs

    kf_arr = np.full(C, -1, np.int64)
    kf_arr[:len(kf_ids)] = kf_ids
    sel = np.maximum(kf_arr, 0)
    cam_R = s.kf_R[sel].copy()
    cam_t = s.kf_t[sel].copy()
    cam_valid = kf_arr >= 0
    cam_fixed = ~cam_valid
    cam_fixed[np.nonzero(kf_arr == 0)[0]] = True      # gauge: KF0 fixed

    mp_arr = np.full(P, -1, np.int64)
    mp_arr[:len(mp_ids)] = mp_ids
    selp = np.maximum(mp_arr, 0)
    pts = s.mp_pos[selp].copy()
    pt_valid = mp_arr >= 0

    slot_of = np.full(s.cfg.max_keyframes, -1, np.int64)
    slot_of[kf_ids] = np.arange(len(kf_ids))
    if obs_bucket is not None:
        O = min(O, obs_bucket)
    okf = s.mp_obs_kf[selp, :O]
    oft = np.maximum(s.mp_obs_feat[selp, :O], 0)
    obs_cam = np.where(okf >= 0, slot_of[np.maximum(okf, 0)], -1)
    obs_valid = (obs_cam >= 0) & pt_valid[:, None]
    obs_uv = s.kf_uv[np.maximum(okf, 0), oft]
    obs_oct = s.kf_octave[np.maximum(okf, 0), oft]
    obs_uvr = np.where(okf >= 0, s.kf_uvr[np.maximum(okf, 0), oft],
                       -1.0).astype(np.float32)
    return dict(kf_arr=kf_arr, mp_arr=mp_arr, n_kf=len(kf_ids),
                n_mp=len(mp_ids), cam_R=cam_R, cam_t=cam_t,
                cam_fixed=cam_fixed, cam_valid=cam_valid, pts=pts,
                pt_valid=pt_valid, obs_cam=obs_cam.astype(np.int32),
                obs_uv=obs_uv, obs_oct=obs_oct, obs_valid=obs_valid,
                obs_uvr=obs_uvr, obs_kf=okf)


def gather_global_partitioned(store, n_shards):
    """gather_global in the covisibility-partitioned BANDED layout
    (parallel/partition.banded_layout): camera axis permuted to
    covisibility-BFS order, landmark axis grouped into n_shards equal-size
    blocks whose camera footprints are contiguous bands, observations in
    BAND-LOCAL camera indices. Feeds dist_ba.dist_bundle_adjust_banded,
    whose per-iteration exchange is n_shards*(6W)^2 instead of (6C)^2.

    Returns None when the map is empty. The caller decides whether the
    exchange is economical (n_shards * W^2 < C^2); the banded path stays
    exact either way."""
    s = store
    lay = banded_layout(s, n_shards)
    if lay is None:
        return None
    kf_order = lay["kf_order"]
    n_kf = len(kf_order)
    C = _bucket(n_kf)
    W = min(lay["band_w"], C)
    O = s.cfg.max_obs

    cam_R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    cam_t = np.zeros((C, 3), np.float32)
    cam_R[:n_kf] = s.kf_R[kf_order]
    cam_t[:n_kf] = s.kf_t[kf_order]
    cam_valid = np.zeros(C, bool)
    cam_valid[:n_kf] = True
    cam_fixed = ~cam_valid
    cam_fixed[np.nonzero(kf_order == 0)[0]] = True    # gauge: KF0 fixed

    pos_of = np.full(s.cfg.max_keyframes, -1, np.int64)
    pos_of[kf_order] = np.arange(n_kf)

    shard_mp = lay["shard_mp"]                        # (n_shards, P_s)
    band_off = lay["band_off"].astype(np.int32)       # (n_shards,)
    mp_arr = shard_mp.reshape(-1)
    selp = np.maximum(mp_arr, 0)
    pts = s.mp_pos[selp].copy()
    pt_valid = mp_arr >= 0

    okf = s.mp_obs_kf[selp, :O]
    oft = np.maximum(s.mp_obs_feat[selp, :O], 0)
    pos = np.where(okf >= 0, pos_of[np.maximum(okf, 0)], -1)
    # band-local camera indices (per shard)
    off_row = np.repeat(band_off, shard_mp.shape[1])[:, None]
    obs_cam = np.where(pos >= 0, pos - off_row, -1).astype(np.int32)
    obs_valid = (pos >= 0) & pt_valid[:, None] \
        & (obs_cam >= 0) & (obs_cam < W)
    obs_cam = np.where(obs_valid, obs_cam, -1)
    obs_uv = s.kf_uv[np.maximum(okf, 0), oft]
    obs_oct = s.kf_octave[np.maximum(okf, 0), oft]
    obs_uvr = np.where(okf >= 0, s.kf_uvr[np.maximum(okf, 0), oft],
                       -1.0).astype(np.float32)
    return dict(kf_order=kf_order, mp_arr=mp_arr, n_kf=n_kf,
                cam_R=cam_R, cam_t=cam_t, cam_fixed=cam_fixed,
                cam_valid=cam_valid, pts=pts, pt_valid=pt_valid,
                obs_cam=obs_cam, obs_uv=obs_uv, obs_oct=obs_oct,
                obs_valid=obs_valid, obs_uvr=obs_uvr,
                band_off=band_off, band_w=W)


def _world_size():
    """Ranks of the initialized default group; 1 without one."""
    return dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1


_PT_KEYS = ("pts", "pt_valid", "obs_cam", "obs_uv", "obs_oct", "obs_valid",
            "obs_uvr")
_CAM_KEYS = ("cam_R", "cam_t", "cam_fixed", "cam_valid")


def dispatch_global_ba(g, cam, n_iters=20, distributed=None, gp=None,
                       device=None):
    """Upload a gathered problem and run the full-map BA on the current
    stream. Returns the result tensors (no host read), the landmark axis
    whole on every rank.

    distributed=None auto-routes: with an initialized group of more than
    one rank (and P divisible by it) the landmark axis is sharded over the
    ranks (parallel/dist_ba.py); otherwise one device runs
    estimation/local_ba.bundle_adjust. gp: a partitioned layout
    (gather_global_partitioned) with one shard per rank selects the BANDED
    camera exchange. device: None means the card (core.device); on NCCL
    the rank's own card."""
    world = _world_size()
    P = g["pts"].shape[0]
    use_dist = distributed if distributed is not None \
        else (world > 1 and P % world == 0)
    if use_dist:
        mesh = dist_ba.make_mesh(device=device)
        banded = gp is not None and gp["pts"].shape[0] % world == 0 \
            and len(gp["band_off"]) == world
        src = gp if banded else g
        pts, pt_valid, obs_cam, obs_uv, obs_oct, obs_valid, obs_uvr = \
            dist_ba.shard_point_arrays(mesh, *(src[k] for k in _PT_KEYS))
        cams = dist_ba.replicate(mesh, *(src[k] for k in _CAM_KEYS))
        if banded:
            (band_off,) = dist_ba.shard_point_arrays(mesh, gp["band_off"])
            res = dist_ba.dist_bundle_adjust_banded(
                mesh, *cams, pts, pt_valid, obs_cam, obs_uv, obs_oct,
                obs_valid, cam, band_off=band_off, band_w=gp["band_w"],
                obs_uvr=obs_uvr, n_iters=n_iters)
        else:
            res = dist_ba.dist_bundle_adjust(
                mesh, *cams, pts, pt_valid, obs_cam, obs_uv, obs_oct,
                obs_valid, cam, obs_uvr=obs_uvr, n_iters=n_iters)
        res["pts"] = dist_ba.gather_points(mesh, res["pts"])
        res["obs_inlier"] = dist_ba.gather_points(mesh, res["obs_inlier"])
        return res
    device = resolve_device(device)
    d = {k: torch.as_tensor(np.ascontiguousarray(g[k]), device=device)
         for k in _KEYS}
    return bundle_adjust(
        d["cam_R"], d["cam_t"], d["cam_fixed"], d["cam_valid"],
        d["pts"], d["pt_valid"], d["obs_cam"], d["obs_uv"],
        d["obs_oct"], d["obs_valid"], cam, obs_uvr=d["obs_uvr"],
        n_iters_1=n_iters // 2, n_iters_2=n_iters - n_iters // 2)


def read_result(res):
    """The BA result on the host: (cam_R projected on SO(3), cam_t, pts,
    cost)."""
    return (project_so3(res["cam_R"].cpu().numpy()),
            res["cam_t"].cpu().numpy(), res["pts"].cpu().numpy(),
            float(res["cost"].cpu()))


def _write_back(store, kf_ids, seq, mp_ids, cam_R, cam_t, pts):
    """Poses and landmarks into the store, under its lock: a keyframe
    slot reused since the gather keeps its new keyframe's pose, and
    non-finite results are skipped."""
    s = store
    nk = len(kf_ids)
    with s.lock:
        ok_R = (np.isfinite(cam_R[:nk]).all((-1, -2))
                & (s.kf_seq[kf_ids] == seq))
        s.kf_R[kf_ids[ok_R]] = cam_R[:nk][ok_R]
        s.kf_t[kf_ids[ok_R]] = cam_t[:nk][ok_R]
        live = mp_ids >= 0
        ok_p = live & np.isfinite(pts[:len(mp_ids)]).all(-1)
        s.mp_pos[mp_ids[ok_p]] = pts[:len(mp_ids)][ok_p]
        s.bump()   # poses/landmarks moved -> invalidate device caches


def global_bundle_adjustment(store, cam, n_iters=20, distributed=None,
                             banded=None, device=None):
    """Run full BA and write the results back into the store (under its
    lock; a keyframe slot reused since the gather keeps its new keyframe's
    pose). Returns the final cost.

    distributed: None = distributed when an initialized group has more
    than one rank. banded: None = auto (the covisibility-banded exchange
    when the layout is local enough to beat the dense all_reduce:
    n_ranks * W^2 < C^2, on more than one rank); True/False forces it
    (True also on one rank). device: None means the card; on NCCL the
    rank's own card."""
    world = _world_size()
    use_dist = distributed if distributed is not None else world > 1
    gp = None
    if use_dist and banded is not False and (world > 1 or banded):
        gp = gather_global_partitioned(store, world)
        if gp is None and banded is True:
            raise ValueError("banded layout unavailable for this map")
        if gp is not None and banded is None:
            C = gp["cam_R"].shape[0]
            W = gp["band_w"]
            if world * W * W >= C * C:
                gp = None      # dense all_reduce cheaper on this small map
    s = store
    if gp is not None:
        seq = s.kf_seq[gp["kf_order"]].copy()
        cam_R, cam_t, pts, cost = read_result(dispatch_global_ba(
            gp, cam, n_iters=n_iters, distributed=use_dist, gp=gp,
            device=device))
        _write_back(s, gp["kf_order"], seq, gp["mp_arr"], cam_R, cam_t, pts)
        return cost
    g = gather_global(store)
    nk, nm = g["n_kf"], g["n_mp"]
    seq = s.kf_seq[g["kf_arr"][:nk]].copy()
    cam_R, cam_t, pts, cost = read_result(dispatch_global_ba(
        g, cam, n_iters=n_iters, distributed=use_dist, device=device))
    _write_back(s, g["kf_arr"][:nk], seq, g["mp_arr"][:nm], cam_R, cam_t,
                pts)
    return cost
