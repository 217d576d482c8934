"""Local mapping stage — the reference's mapping thread as a pipeline stage.

Port of ar_orbslam2_tpu/mapping/local_mapping.py (LocalMapping,
src/LocalMapping.cc), synchronous. Hot math (epipolar search,
triangulation gates, fuse matching, local BA) runs as torch on the
system's device; bookkeeping (observation tables, covisibility, culling)
is vectorized numpy on the host MapStore.

Step order mirrors LocalMapping::Run: ProcessNewKeyFrame -> MapPointCulling
-> CreateNewMapPoints -> SearchInNeighbors (fuse) -> LocalBundleAdjustment
-> KeyFrameCulling. The JAX package's ``lax.scan`` over neighbours is a
loop here, the one over fuse targets a single batched search launch; each
stage uploads its inputs once and reads its results back once.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.lie import project_so3
from ..estimation.local_ba import bundle_adjust
from ..matching import matcher
from ..ops import hamming as H
from . import triangulation as tri


def _to_device(tree, device):
    """Upload a (nested) dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.ascontiguousarray(tree), device=device)


def _triangulate_neighbors(cam, d, scale_factor=1.2):
    """Epipolar search + gated triangulation of the new KF against every
    neighbor. d: uploaded inputs (nbs stacked (N, ...)).
    Returns (idx (N,P), xw (N,P,3), good (N,P))."""
    signs1 = H.signs_from_packed(d["signs1"])
    nbs = d["nbs"]
    idx_l, xw_l, good_l = [], [], []
    for i in range(nbs["R"].shape[0]):
        idx, _ = tri.epipolar_search(
            cam, d["R1"], d["t1"], nbs["R"][i], nbs["t"][i],
            d["uv1"], signs1, d["oct1"], d["free1"],
            nbs["uv"][i], H.signs_from_packed(nbs["desc"][i]), nbs["oct"][i],
            nbs["free"][i], angles1=d["ang1"], angles2=nbs["ang"][i],
            scale_factor=scale_factor)
        out = tri.triangulate_candidates(
            cam, d["R1"], d["t1"], nbs["R"][i], nbs["t"][i],
            d["uv1"], d["oct1"], nbs["uv"][i], nbs["oct"][i], idx,
            scale_factor=scale_factor)
        idx_l.append(idx)
        xw_l.append(out["xw"])
        good_l.append(out["good"] & nbs["valid"][i])
    return torch.stack(idx_l), torch.stack(xw_l), torch.stack(good_l)


def _fuse_targets(cam, b, tgts, scale_factor=1.2, n_levels=8, radius=3.0):
    """ORBmatcher::Fuse of one landmark bundle into every target keyframe:
    the bundle is projected into all T targets at once and the T windowed
    searches are ONE launch (the JAX package's single ``lax.scan``
    dispatch). Descriptors stay packed; the search unpacks (plain version)
    or reads them as words (kernel).
    Returns idx (T, L) — matched keypoint per landmark per target."""
    idx, _, _ = matcher.search_local_points(
        cam, tgts["R"], tgts["t"], b["pos"], b["desc"],
        b["normal"], b["dmin"], b["dmax"], b["valid"],
        tgts["uv"], tgts["desc"], tgts["oct"], tgts["kp_valid"],
        th_radius=radius, th=H.TH_LOW, nn_ratio=1.0,
        n_levels=n_levels, scale_factor=scale_factor)
    return torch.where(tgts["valid"][:, None], idx, -1)


def _bundle_upload(b):
    """gather_map_points bundle -> upload form (descriptors stay packed)."""
    return dict(pos=b["pos"], desc=np.asarray(b["desc"], np.uint8),
                normal=b["normal"], dmin=b["dmin"], dmax=b["dmax"],
                valid=b["valid"])


@dataclass(frozen=True)
class LocalMapperConfig:
    n_triangulation_neighbors: int = 10   # mono: 20 in ref; 10 keeps it tight
    n_fuse_neighbors: int = 10            # first-order fuse targets
    ba_max_local_kf: int = 12             # local (optimized) keyframes
    ba_max_fixed_kf: int = 12             # boundary (fixed) keyframes
    ba_max_points: int = 2048             # padded landmark axis of local BA
    ba_obs_bucket: int = 16               # fixed observation-axis width
    ba_iters_1: int = 5
    ba_iters_2: int = 10
    scale_factor: float = 1.2
    n_levels: int = 8
    cull_found_ratio: float = 0.25        # MapPointCulling gate
    kf_cull_redundancy: float = 0.9       # KeyFrameCulling gate


class LocalMapper:
    """Per-keyframe mapping stage over a MapStore."""

    def __init__(self, store, cam, cfg: LocalMapperConfig = LocalMapperConfig(),
                 device=None):
        self.store = store
        self.cam = cam
        self.cfg = cfg
        self.device = resolve_device(device)
        # recently created landmarks: mp_id -> creation number (kf_seq) of
        # the keyframe that made them (its id until a slot is reused)
        self.recent: dict[int, int] = {}
        self.last_stats: dict = {}   # per-KF diagnostics (culled/created)

    # ------------------------------------------------------------------
    def process_keyframe(self, kf: int, do_ba: bool = True,
                         do_culling: bool = True):
        """Full mapping step for a freshly inserted keyframe. Per-stage
        wall times land in last_stats."""
        stats = dict(kf=kf)

        def _t(name, fn, *a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            stats[f"t_{name}_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
            return out

        _t("process", self._process_new_keyframe, kf)
        stats["n_culled"] = _t("cull_mp", self.cull_map_points, kf) \
            if do_culling else 0
        stats["n_new"] = n_new = _t("triangulate",
                                    self.create_new_map_points, kf)
        _t("fuse", self.search_in_neighbors, kf)
        if do_ba and self.store.n_keyframes() > 2:
            _t("local_ba", self.local_bundle_adjustment, kf)
        if do_culling:
            _t("cull_kf", self.cull_keyframes, kf)
        self.last_stats = stats
        return n_new

    # ------------------------------------------------------------------
    def _process_new_keyframe(self, kf: int):
        """Parity: LocalMapping::ProcessNewKeyFrame — refresh landmark
        derived state for tracked bindings, rebuild covisibility."""
        s = self.store
        mps = s.kf_mp[kf]
        mps = np.unique(mps[mps >= 0])
        if len(mps):
            s.compute_distinctive_descriptors(mps)
            s.update_normal_and_depth(mps)
        s.update_connections(kf)

    # ------------------------------------------------------------------
    def cull_map_points(self, kf: int):
        """Parity: LocalMapping::MapPointCulling — recent landmarks must
        keep a >=0.25 found ratio and gain >=3 observers within 2 KFs."""
        s = self.store
        dead, graduated = [], []
        now = int(s.kf_seq[kf])
        for mp, born in self.recent.items():
            if not s.mp_valid[mp]:
                dead.append(mp)
                continue
            found_ratio = s.mp_found[mp] / max(int(s.mp_visible[mp]), 1)
            age = now - born
            if found_ratio < self.cfg.cull_found_ratio:
                s.erase_map_point(mp)
                dead.append(mp)
            elif age >= 2 and s.mp_nobs[mp] <= 2:
                s.erase_map_point(mp)
                dead.append(mp)
            elif age >= 3:
                graduated.append(mp)
        n_culled = sum(1 for m in dead if not self.store.mp_valid[m])
        for mp in dead + graduated:
            self.recent.pop(mp, None)
        return n_culled

    # ------------------------------------------------------------------
    def create_new_map_points(self, kf: int) -> int:
        """Parity: LocalMapping::CreateNewMapPoints — triangulate against
        the best covisible neighbors with epipolar search + gates. The
        sequential "feature already bound" discipline of the reference's
        neighbor loop is applied on the host by processing results in
        covisibility order and skipping bound features."""
        s, cam, cfg = self.store, self.cam, self.cfg
        N = cfg.n_triangulation_neighbors
        neighbors = [int(k) for k in s.covisible_keyframes(kf, n_best=N)]
        if not neighbors:
            return 0
        R1, t1 = s.kf_R[kf], s.kf_t[kf]
        median_depth = s.median_scene_depth(kf)
        c1 = -(R1.T @ t1)
        # mono gate: baseline must be significant vs scene depth
        keep = []
        for nb in neighbors:
            c2 = -(s.kf_R[nb].T @ s.kf_t[nb])
            baseline = float(np.linalg.norm(c2 - c1))
            if median_depth > 0 and baseline / median_depth < 0.01:
                continue
            keep.append(nb)
        if not keep:
            return 0
        nb_arr = np.asarray(keep, np.int64)
        nbs = dict(R=s.kf_R[nb_arr], t=s.kf_t[nb_arr],
                   uv=s.kf_uv[nb_arr], desc=s.kf_desc[nb_arr],
                   oct=s.kf_octave[nb_arr], ang=s.kf_angle[nb_arr],
                   free=s.kf_kp_valid[nb_arr] & (s.kf_mp[nb_arr] < 0),
                   valid=np.ones(len(keep), bool))
        host_in = dict(R1=R1, t1=t1, uv1=s.kf_uv[kf],
                       signs1=s.kf_desc[kf],
                       oct1=s.kf_octave[kf], ang1=s.kf_angle[kf],
                       free1=s.kf_kp_valid[kf] & (s.kf_mp[kf] < 0),
                       nbs=nbs)
        d = _to_device(host_in, self.device)
        idx, xw, good = (v.cpu().numpy() for v in _triangulate_neighbors(
            cam, d, scale_factor=cfg.scale_factor))

        n_created = 0
        all_ids = []
        with s.lock:
            for i, nb in enumerate(keep):
                g = good[i]
                if not g.any():
                    continue
                feats1 = np.nonzero(g)[0]
                # sequential parity: skip features bound by an earlier
                # neighbor
                feats1 = feats1[s.kf_mp[kf, feats1] < 0]
                if len(feats1) == 0:
                    continue
                feats2 = idx[i][feats1]
                ids = s.add_map_points(xw[i][feats1],
                                       s.kf_desc[kf, feats1], first_kf=kf)
                s.add_observations(ids, kf, feats1)
                s.add_observations(ids, nb, feats2)
                self.recent.update((int(m), int(s.kf_seq[kf])) for m in ids)
                all_ids.append(ids)
                n_created += len(ids)
            if n_created:
                ids = np.concatenate(all_ids)
                s.compute_distinctive_descriptors(ids)
                s.update_normal_and_depth(ids)
                s.update_connections(kf)
        return n_created

    # ------------------------------------------------------------------
    def search_in_neighbors(self, kf: int):
        """Parity: LocalMapping::SearchInNeighbors — two-pass landmark
        fusion with first- and second-order covisible neighbors."""
        s, cfg = self.store, self.cfg
        first = [int(k) for k in
                 s.covisible_keyframes(kf, n_best=cfg.n_fuse_neighbors)]
        targets = list(first)
        seen = set(first) | {kf}
        for nb in first:
            for nb2 in s.covisible_keyframes(nb, n_best=5):
                nb2 = int(nb2)
                if nb2 not in seen:
                    targets.append(nb2)
                    seen.add(nb2)
        if not targets:
            return
        targets = targets[:cfg.n_fuse_neighbors + 5]
        own = s.kf_mp[kf]
        own = np.unique(own[own >= 0])
        own = own[s.mp_valid[own]]
        fuse_mps = s.kf_mp[np.asarray(targets, np.int64)]
        fuse_mps = np.unique(fuse_mps[fuse_mps >= 0])
        fuse_mps = fuse_mps[s.mp_valid[fuse_mps]]

        def kf_stack(arr):
            return dict(R=s.kf_R[arr], t=s.kf_t[arr], uv=s.kf_uv[arr],
                        desc=s.kf_desc[arr], oct=s.kf_octave[arr],
                        kp_valid=s.kf_kp_valid[arr],
                        valid=np.ones(len(arr), bool))

        pad = cfg.ba_max_points
        b1 = s.gather_map_points(own, pad_to=pad)
        b2 = s.gather_map_points(fuse_mps, pad_to=pad)
        d = _to_device(dict(
            tgts=kf_stack(np.asarray(targets, np.int64)),
            cur=kf_stack(np.asarray([kf], np.int64)),
            b1=_bundle_upload(b1), b2=_bundle_upload(b2)), self.device)
        cam, sf, nl = self.cam, cfg.scale_factor, cfg.n_levels
        # pass 1: current KF's landmarks into each target
        idx1 = _fuse_targets(cam, d["b1"], d["tgts"], scale_factor=sf,
                             n_levels=nl)
        # pass 2: all targets' landmarks into the current KF
        idx2 = _fuse_targets(cam, d["b2"], d["cur"], scale_factor=sf,
                             n_levels=nl)
        idx1, idx2 = idx1.cpu().numpy(), idx2.cpu().numpy()
        ids1 = np.asarray(b1["ids"])
        ids2 = np.asarray(b2["ids"])
        for i, t in enumerate(targets):
            self._apply_fuse(ids1, idx1[i], t)
        self._apply_fuse(ids2, idx2[0], kf)
        # refresh derived state of current KF's landmarks + connectivity
        own = s.kf_mp[kf]
        own = np.unique(own[own >= 0])
        if len(own):
            s.compute_distinctive_descriptors(own)
            s.update_normal_and_depth(own)
        s.update_connections(kf)

    def _apply_fuse(self, ids, idx, target_kf: int):
        """Host merge step of ORBmatcher::Fuse for one target keyframe:
        bind each matched landmark to the keypoint, or merge with the
        existing binding (keep the landmark with more observers). Free
        keypoints bind in one batched add_observations; only genuine merges
        walk the per-landmark replace path."""
        s = self.store
        with s.lock:
            rows = np.nonzero(idx >= 0)[0]
            if len(rows) == 0:
                return
            mp = ids[rows]
            live = (mp >= 0) & s.mp_valid[np.maximum(mp, 0)]
            rows, mp = rows[live], mp[live]
            feat = idx[rows].astype(np.int64)
            bound = s.kf_mp[target_kf, feat]
            same = bound == mp
            mp, feat, bound = mp[~same], feat[~same], bound[~same]
            has_bound = (bound >= 0) & s.mp_valid[np.maximum(bound, 0)]
            # free keypoints: first landmark per keypoint wins
            f_feat = feat[~has_bound]
            f_mp = mp[~has_bound]
            if len(f_feat):
                uniq, first = np.unique(f_feat, return_index=True)
                s.add_observations(f_mp[first], target_kf, uniq)
            # occupied keypoints: merge, keep the landmark with more observers
            for m, b in zip(mp[has_bound], bound[has_bound]):
                m, b = int(m), int(b)
                if not (s.mp_valid[m] and s.mp_valid[b]) or m == b:
                    continue
                if s.mp_nobs[b] >= s.mp_nobs[m]:
                    s.replace_map_point(m, b)
                else:
                    s.replace_map_point(b, m)

    # ------------------------------------------------------------------
    def gather_local_window(self, kf: int):
        """Build the fixed-shape local-BA problem around kf.

        Local (optimized) KFs = kf + best covisible; fixed KFs = other
        observers of local landmarks (parity: Optimizer::
        LocalBundleAdjustment's lLocalKeyFrames / lFixedCameras).
        """
        s, cfg = self.store, self.cfg
        local = [kf] + [int(k) for k in s.covisible_keyframes(
            kf, n_best=cfg.ba_max_local_kf - 1)]
        mp_ids = s.local_map_points(np.asarray(local, np.int64))
        if len(mp_ids) > cfg.ba_max_points:
            mp_ids = mp_ids[:cfg.ba_max_points]
        local_set = set(local)
        # fixed cameras: observers of local points outside the local set
        obs_kf = s.mp_obs_kf[mp_ids]
        outside = np.unique(obs_kf[obs_kf >= 0])
        fixed = [int(k) for k in outside if int(k) not in local_set]
        fixed = fixed[:cfg.ba_max_fixed_kf]
        window = local + fixed
        n_local = len(local)

        C = cfg.ba_max_local_kf + cfg.ba_max_fixed_kf
        P, O = cfg.ba_max_points, s.cfg.max_obs
        kf_arr = np.full(C, -1, np.int64)
        kf_arr[:len(window)] = window
        sel = np.maximum(kf_arr, 0)
        cam_R = s.kf_R[sel].copy()
        cam_t = s.kf_t[sel].copy()
        cam_valid = kf_arr >= 0
        cam_fixed = np.ones(C, bool)
        cam_fixed[:n_local] = False
        # gauge: keyframe 0 stays fixed
        for i, k in enumerate(window[:n_local]):
            if k <= 0:
                cam_fixed[i] = True

        mp_arr = np.full(P, -1, np.int64)
        mp_arr[:len(mp_ids)] = mp_ids
        selp = np.maximum(mp_arr, 0)
        pts = s.mp_pos[selp].copy()
        pt_valid = mp_arr >= 0

        # observation KF ids -> window slots, trimmed to a FIXED width
        # (observation slots are prefix-compacted)
        slot_of = np.full(s.cfg.max_keyframes, -1, np.int64)
        slot_of[np.asarray(window, np.int64)] = np.arange(len(window))
        O = min(O, cfg.ba_obs_bucket)
        okf = s.mp_obs_kf[selp, :O]                 # (P, O)
        oft = np.maximum(s.mp_obs_feat[selp, :O], 0)
        obs_cam = np.where(okf >= 0, slot_of[np.maximum(okf, 0)], -1)
        obs_valid = (obs_cam >= 0) & pt_valid[:, None]
        obs_uv = s.kf_uv[np.maximum(okf, 0), oft]
        obs_oct = s.kf_octave[np.maximum(okf, 0), oft]
        obs_uvr = np.where(okf >= 0, s.kf_uvr[np.maximum(okf, 0), oft],
                           -1.0).astype(np.float32)
        return dict(window=window, n_local=n_local, mp_ids=mp_ids,
                    cam_R=cam_R, cam_t=cam_t, cam_fixed=cam_fixed,
                    cam_valid=cam_valid, pts=pts, pt_valid=pt_valid,
                    obs_cam=obs_cam.astype(np.int32), obs_uv=obs_uv,
                    obs_oct=obs_oct, obs_valid=obs_valid, obs_uvr=obs_uvr,
                    obs_kf=okf, obs_feat=np.where(okf >= 0, oft, -1))

    def local_bundle_adjustment(self, kf: int):
        """Parity: Optimizer::LocalBundleAdjustment — 5+10 LM iterations
        with a mid-way chi2 outlier strip; outlier observations erased."""
        w = self.gather_local_window(kf)
        s = self.store
        keys = ("cam_R", "cam_t", "cam_fixed", "cam_valid", "pts",
                "pt_valid", "obs_cam", "obs_uv", "obs_oct", "obs_valid",
                "obs_uvr")
        d = _to_device({k: w[k] for k in keys}, self.device)
        res = bundle_adjust(
            d["cam_R"], d["cam_t"], d["cam_fixed"], d["cam_valid"],
            d["pts"], d["pt_valid"], d["obs_cam"], d["obs_uv"],
            d["obs_oct"], d["obs_valid"],
            self.cam, obs_uvr=d["obs_uvr"],
            n_iters_1=self.cfg.ba_iters_1,
            n_iters_2=self.cfg.ba_iters_2)
        cam_R = project_so3(res["cam_R"].cpu().numpy())
        cam_t = res["cam_t"].cpu().numpy()
        pts = res["pts"].cpu().numpy()
        inl = res["obs_inlier"].cpu().numpy()
        # write back optimized local poses + landmark positions (skip any
        # diverged slot — project_so3 marks non-finite rotations NaN)
        with s.lock:
            for i in range(w["n_local"]):
                k = w["window"][i]
                if not w["cam_fixed"][i] and np.isfinite(cam_R[i]).all() \
                        and np.isfinite(cam_t[i]).all():
                    s.kf_R[k] = cam_R[i]
                    s.kf_t[k] = cam_t[i]
            n_mp = len(w["mp_ids"])
            finite = np.isfinite(pts[:n_mp]).all(-1)
            s.mp_pos[w["mp_ids"][finite]] = pts[:n_mp][finite]
            s.bump()   # poses/landmarks moved -> invalidate bundle caches
            # erase outlier observations (parity: the post-BA erase loop)
            bad = w["obs_valid"] & ~inl
            rows, cols = np.nonzero(bad)
            for r, c in zip(rows, cols):
                mp = int(w["mp_ids"][r]) if r < n_mp else -1
                okf = int(w["obs_kf"][r, c])
                if mp >= 0 and okf >= 0 and s.mp_valid[mp]:
                    s.erase_observation(mp, okf)
            if len(rows):
                s.update_connections(kf)

    # ------------------------------------------------------------------
    def cull_keyframes(self, kf: int):
        """Parity: LocalMapping::KeyFrameCulling — erase local KFs whose
        landmarks are >=90% seen by >=3 other KFs at same/finer scale."""
        s, cfg = self.store, self.cfg
        newest = s.n_kf_created - 1
        for cand in [int(k) for k in s.covisible_keyframes(kf)]:
            if cand == 0 or cand == kf:
                continue
            # never cull the freshest keyframes: their triangulated points
            # carry the only forward coverage (by creation number: the JAX
            # package's id test, which a reused slot would defeat)
            if s.kf_seq[cand] >= newest - 2:
                continue
            feats = np.nonzero(s.kf_mp[cand] >= 0)[0]
            if len(feats) == 0:
                continue
            mps = s.kf_mp[cand, feats]
            live = s.mp_valid[mps]
            fl, ml = feats[live], mps[live]
            n_redundant = 0
            if len(fl):
                lvl = s.kf_octave[cand, fl]                    # (F,)
                okf = s.mp_obs_kf[ml]                          # (F, O)
                oft = s.mp_obs_feat[ml]
                others = (okf >= 0) & (okf != cand)
                finer = s.kf_octave[np.maximum(okf, 0),
                                    np.maximum(oft, 0)] <= lvl[:, None] + 1
                n_redundant = int(((others & finer).sum(1) >= 3).sum())
            if n_redundant >= cfg.kf_cull_redundancy * len(feats):
                s.erase_keyframe(cand)
