"""Full-map bundle adjustment: gather + run.

Port of ar_orbslam2_tpu/mapping/global_ba.py (parity:
Optimizer::GlobalBundleAdjustemnt, src/Optimizer.cc, sic, and
LoopClosing::RunGlobalBundleAdjustment): optimize every keyframe pose and
landmark against all observations, through the same Schur LM as local BA
(estimation/local_ba.bundle_adjust). Shapes are padded to power-of-two
buckets, as in the JAX package.

Only the single-device route is ported. The JAX package's landmark-sharded
(``distributed``) and covisibility-banded (``banded``) routes run on a
device mesh (parallel/dist_ba.py); asking for either raises
NotImplementedError, and ``distributed=None`` means one device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.lie import project_so3
from ..estimation.local_ba import bundle_adjust

_UNPORTED = ("is not ported to ar_orbslam2_tpu_torch yet (ROADMAP.md, "
             "'Modules still to port', item 6: parallel/)")
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


def dispatch_global_ba(g, cam, n_iters=20, distributed=None, gp=None,
                       device=None):
    """Upload a gathered problem to `device` and run the full-map BA on
    the current stream. Returns the result tensors (no host read).

    distributed=True and a partitioned layout `gp` are the JAX package's
    multi-device routes and raise NotImplementedError."""
    if distributed:
        raise NotImplementedError(f"distributed global BA {_UNPORTED}")
    if gp is not None:
        raise NotImplementedError(f"banded global BA {_UNPORTED}")
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


def global_bundle_adjustment(store, cam, n_iters=20, distributed=None,
                             banded=None, device=None):
    """Run full BA on `device` and write the results back into the store
    (under its lock; a keyframe slot reused since the gather keeps its new
    keyframe's pose). Returns the final cost."""
    if distributed or banded:
        raise NotImplementedError(
            f"{'distributed' if distributed else 'banded'} global BA "
            f"{_UNPORTED}")
    s = store
    g = gather_global(store)
    seq = s.kf_seq[g["kf_arr"][:g["n_kf"]]].copy()
    cam_R, cam_t, pts, cost = read_result(
        dispatch_global_ba(g, cam, n_iters=n_iters, device=device))
    nk, nm = g["n_kf"], g["n_mp"]
    kf_ids = g["kf_arr"][:nk]
    with s.lock:
        ok_R = (np.isfinite(cam_R[:nk]).all((-1, -2))
                & (s.kf_seq[kf_ids] == seq))
        s.kf_R[kf_ids[ok_R]] = cam_R[:nk][ok_R]
        s.kf_t[kf_ids[ok_R]] = cam_t[:nk][ok_R]
        mp_ids = g["mp_arr"][:nm]
        ok_p = np.isfinite(pts[:nm]).all(-1)
        s.mp_pos[mp_ids[ok_p]] = pts[:nm][ok_p]
        s.bump()   # poses/landmarks moved -> invalidate device caches
    return cost
