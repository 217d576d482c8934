"""Tracking front end — the per-frame state machine.

Port of the per-frame path of ar_orbslam2_tpu/system/tracking.py (the
reference's Tracking::Track): the state machine (NOT_INITIALIZED -> OK ->
LOST) and the keyframe decision live on the host; every numeric stage —
projective search, motion-only BA, local-map search — is a torch function
on the system's device, read back once per stage.

Per frame: predict pose (velocity model) -> SearchByProjection vs the last
frame's landmarks -> PoseOptimization (reference-KF brute-force fallback)
-> TrackLocalMap (covisibility expansion + SearchLocalPoints +
PoseOptimization) -> inlier gates -> keyframe decision -> LocalMapper.

Not ported in this slice: the fused/chunked device path, the async mapper,
relocalization, loop closing, localization mode and stereo/RGB-D (see
ROADMAP.md). Without a relocalizer a failed frame goes LOST, as it does in
the JAX package with relocalization disabled.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..estimation.initializer import initialize_two_view
from ..estimation.pose_opt import pose_optimization_compact
from ..matching import matcher
from ..ops import hamming as H
from .frame import Frame

NOT_INITIALIZED = "NOT_INITIALIZED"
OK = "OK"
LOST = "LOST"


@dataclass(frozen=True)
class TrackingConfig:
    max_kp: int = 1024              # padded features per frame
    n_local_mp: int = 4096          # padded local-map landmark bundle
    n_local_kf: int = 16            # covisibility expansion size
    min_init_matches: int = 100     # mono init gate (ref: 100)
    min_track_matches: int = 20     # SearchByProjection gate (ref: 20)
    min_inliers_track: int = 10     # PoseOptimization gate (ref: 10)
    min_inliers_local: int = 30     # TrackLocalMap gate (ref: 30)
    min_inliers_reloc: int = 50     # gate right after relocalization
    max_frames_between_kf: int = 30  # ref: mMaxFrames = fps
    min_frames_between_kf: int = 0   # ref: mMinFrames (mapper-idle analog)
    kf_ref_ratio: float = 0.9       # need-KF: tracked < 0.9 * ref matches
    min_matches_new_kf: int = 15
    scale_factor: float = 1.2
    n_levels: int = 8
    reset_if_lost_before_kfs: int = 5


# ---------------------------------------------------------------------------
# per-frame device stages
# ---------------------------------------------------------------------------
def _match_and_optimize(cam, R0, t0, lm_pos, idx, kp_uv, kp_oct, M):
    """Motion-only BA over the matched rows of a search result. Returns
    (R, t, n_inliers, n_matches, kp_match (N_lm,) -1 where not inlier,
    inlier (N_lm,))."""
    matched = idx >= 0
    j = torch.clamp(idx, min=0).long()
    res = pose_optimization_compact(R0, t0, lm_pos, kp_uv[j], kp_oct[j],
                                    matched, cam, M)
    inlier = res["inlier"] & matched
    return (res["R"], res["t"], inlier.to(torch.int32).sum(),
            matched.to(torch.int32).sum(),
            torch.where(inlier, idx, torch.full_like(idx, -1)), inlier)


def _motion_track(cam, R_pred, t_pred, lm_pos, lm_desc, lm_oct, lm_valid,
                  kp_uv, kp_desc, kp_oct, kp_valid):
    """SearchByProjection(last frame) + motion-only BA. Returns
    (R, t, n_inliers, n_matches, kp_match (N_lm,) int32)."""
    idx, _ = matcher.search_by_projection_frame(
        cam, R_pred, t_pred, lm_pos, lm_desc, lm_oct, lm_valid,
        kp_uv, kp_desc, kp_oct, kp_valid)
    return _match_and_optimize(cam, R_pred, t_pred, lm_pos, idx, kp_uv,
                               kp_oct, 512)[:5]


def _bow_track(cam, R0, t0, lm_pos, lm_signs, lm_valid, kp_uv, kp_signs,
               kp_oct, kp_valid):
    """TrackReferenceKeyFrame analog: unwindowed descriptor search against
    the reference KF's landmarks (replaces SearchByBoW) + motion-only BA."""
    idx, _ = matcher.search_brute_force(lm_signs, lm_valid, kp_signs,
                                        kp_valid, th=H.TH_LOW, nn_ratio=0.75)
    return _match_and_optimize(cam, R0, t0, lm_pos, idx, kp_uv, kp_oct,
                               1024)[:5]


def _local_map_track(cam, R0, t0, mp_pos, mp_desc, mp_normal, mp_dmin,
                     mp_dmax, mp_valid, kp_uv, kp_desc, kp_oct, kp_valid,
                     scale_factor=1.2, n_levels=8):
    """SearchLocalPoints + final PoseOptimization. Returns
    (R, t, n_inliers, kp_match (N_mp,), visible (N_mp,), inlier (N_mp,))."""
    idx, visible, _ = matcher.search_local_points(
        cam, R0, t0, mp_pos, mp_desc, mp_normal, mp_dmin, mp_dmax,
        mp_valid, kp_uv, kp_desc, kp_oct, kp_valid,
        n_levels=n_levels, scale_factor=scale_factor)
    R, t, n_inl, _, kp_match, inlier = _match_and_optimize(
        cam, R0, t0, mp_pos, idx, kp_uv, kp_oct, 1024)
    return R, t, n_inl, kp_match, visible, inlier


def _init_match(uv1, desc1, valid1, angles1, uv2, desc2, valid2, angles2):
    return matcher.search_for_initialization(
        uv1, desc1, valid1, uv2, desc2, valid2,
        angles1=angles1, angles2=angles2)


def _host(*tensors):
    """One batched device->host readback."""
    return [t.cpu().numpy() for t in tensors]


def _compose(Ra, ta, Rb, tb):
    """(Ra, ta) ∘ (Rb, tb) on host float32: first apply b, then a."""
    return (Ra @ Rb).astype(np.float32), (Ra @ tb + ta).astype(np.float32)


def _inverse(R, t):
    Rt = R.T
    return Rt, -(Rt @ t)


class Tracking:
    """Host state machine driving the per-frame device stages."""

    def __init__(self, store, local_mapper, cam,
                 cfg: TrackingConfig = TrackingConfig(), device="cpu",
                 seed=0):
        self.store = store
        self.mapper = local_mapper
        self.cam = cam
        self.cfg = cfg
        self.device = torch.device(device)
        self.seed = seed                    # RANSAC draw of each init attempt
        self.state = NOT_INITIALIZED
        self.last_frame: Frame | None = None
        self.velocity = None                # (R, t) of T_cur * T_last^-1
        self.ref_kf = -1
        self.last_kf_frame_id = -1
        self.last_reloc_frame_id = -1_000_000
        self.init_frame: Frame | None = None
        self.metrics: list[dict] = []
        self.n_resets = 0
        self._dbg: dict = {}     # per-frame stage diagnostics -> metrics
        # device-resident local-map bundle, cached on (map version, KF set)
        self._local_bundle_cache: tuple | None = None

    def _t(self, a):
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    # ------------------------------------------------------------------
    def track(self, frame: Frame) -> dict:
        """Process one frame; returns a metrics dict incl. pose if OK."""
        if self.state == NOT_INITIALIZED:
            ok = self._initialize_monocular(frame)
            rec = self._record(frame, ok_flag=ok, n_inliers=0)
            self.last_frame = frame
            return rec

        # parity: Tracking::CheckReplacedInLastFrame — fusion replaces
        # landmarks; the last frame's bindings follow the forwarding chain
        if self.last_frame is not None:
            lf = self.last_frame
            lf.mp = self.store.resolve_replacements(lf.mp)

        n_inliers = 0
        ok = False
        if self.state == OK:
            ok, n_inliers = self._track_from_last(frame)
        if not ok:
            # relocalization is not ported: the frame is lost
            n_inliers = 0
        if ok:
            ok, n_inliers = self._track_local_map(frame, n_inliers)

        if ok:
            self.state = OK
            last = self.last_frame
            if last is not None and last.R is not None:
                self.velocity = _compose(frame.R, frame.t,
                                         *_inverse(last.R, last.t))
            if self._need_new_keyframe(frame, n_inliers):
                self._create_keyframe(frame)
        else:
            self.state = LOST
            self.velocity = None
            # reset-if-lost-early (Tracking::Track "lost soon after init")
            if self.store.n_keyframes() <= self.cfg.reset_if_lost_before_kfs:
                self.reset()
        rec = self._record(frame, ok_flag=ok, n_inliers=n_inliers)
        self.last_frame = frame
        return rec

    # ------------------------------------------------------------------
    def _record(self, frame, ok_flag, n_inliers):
        rec = dict(frame_id=frame.frame_id, timestamp=frame.timestamp,
                   state=self.state, ok=bool(ok_flag),
                   n_inliers=int(n_inliers),
                   n_kf=self.store.n_keyframes(),
                   n_mp=self.store.n_map_points(),
                   **self._dbg)
        self._dbg = {}
        if frame.R is not None:
            rec["R"] = frame.R.copy()
            rec["t"] = frame.t.copy()
            # pose relative to the reference KF at track time, so the final
            # trajectory benefits from later BA refinement of the KF
            # (parity: mlRelativeFramePoses in SaveTrajectoryTUM)
            ref = self.ref_kf
            rec["ref_kf"] = ref
            if ref >= 0:
                with self.store.lock:
                    R_rw = self.store.kf_R[ref].copy()
                    t_rw = self.store.kf_t[ref].copy()
                R_cr = frame.R @ R_rw.T
                rec["R_cr"] = R_cr
                rec["t_cr"] = frame.t - R_cr @ t_rw
                # anchor the frame to its reference KF so UpdateLastFrame
                # can re-compose against the KF's post-BA pose
                frame.ref_kf = ref
                frame.R_cr = R_cr
                frame.t_cr = rec["t_cr"]
        self.metrics.append(rec)
        return rec

    def _update_last_frame(self):
        """Parity: Tracking::UpdateLastFrame — re-anchor the last frame's
        pose to its reference keyframe's CURRENT pose before motion
        prediction (local BA moves keyframes between frames)."""
        last = self.last_frame
        ref = getattr(last, "ref_kf", -1)
        if last is None or ref < 0 or not self.store.kf_valid[ref]:
            return
        R_cw = last.R_cr @ self.store.kf_R[ref]
        t_cw = last.R_cr @ self.store.kf_t[ref] + last.t_cr
        last.set_pose(R_cw, t_cw)

    # ------------------------------------------------------------------
    # monocular initialization (Tracking::MonocularInitialization)
    # ------------------------------------------------------------------
    def _initialize_monocular(self, frame: Frame) -> bool:
        if self.init_frame is None or \
                self.init_frame.n_kp < self.cfg.min_init_matches:
            self.init_frame = frame
            return False
        f0 = self.init_frame
        idx, _ = _init_match(
            f0.dev("uv"), f0.dev("desc_packed"), f0.dev("valid"),
            f0.dev("angle"), frame.dev("uv"), frame.dev("desc_packed"),
            frame.dev("valid"), frame.dev("angle"))
        idx = idx.cpu().numpy()
        n_matches = int((idx >= 0).sum())
        if n_matches < self.cfg.min_init_matches:
            self.init_frame = frame
            return False
        rows = np.nonzero(idx >= 0)[0]
        # pad the match set to the fixed feature capacity (fixed shapes)
        P = self.cfg.max_kp
        n = min(len(rows), P)
        feats0 = np.zeros(P, np.int64)
        feats1 = np.zeros(P, np.int64)
        uv1 = np.zeros((P, 2), np.float32)
        uv2 = np.zeros((P, 2), np.float32)
        valid = np.zeros(P, bool)
        feats0[:n] = rows[:n]
        feats1[:n] = idx[rows[:n]]
        uv1[:n] = f0.uv[feats0[:n]]
        uv2[:n] = frame.uv[feats1[:n]]
        valid[:n] = True
        # the same draw on every attempt, as the JAX package's fixed key
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        out = initialize_two_view(self._t(uv1), self._t(uv2), self._t(valid),
                                  self.cam.K, generator=gen)
        if out is None:
            return False
        good = out["good"] & valid
        self._create_initial_map(f0, frame, feats0, feats1, out["R21"],
                                 out["t21"], out["xw"], good)
        return True

    def _create_initial_map(self, f0, f1, feats0, feats1, R21, t21, xw, good):
        """Parity: Tracking::CreateInitialMapMonocular — two KFs, landmarks,
        BA over the 2-view map, median-depth scale normalization."""
        s = self.store
        kf0 = s.add_keyframe(np.eye(3, dtype=np.float32),
                             np.zeros(3, np.float32),
                             f0.uv, f0.desc_packed, f0.octave, f0.valid,
                             timestamp=f0.timestamp, frame_id=f0.frame_id,
                             angle=f0.angle)
        kf1 = s.add_keyframe(R21, t21, f1.uv, f1.desc_packed, f1.octave,
                             f1.valid, timestamp=f1.timestamp,
                             frame_id=f1.frame_id, angle=f1.angle)
        g = np.nonzero(np.asarray(good))[0]
        ids = s.add_map_points(np.asarray(xw)[g],
                               f1.desc_packed[feats1[g]], first_kf=kf0)
        s.add_observations(ids, kf0, feats0[g])
        s.add_observations(ids, kf1, feats1[g])
        s.compute_distinctive_descriptors(ids)
        s.update_normal_and_depth(ids)
        s.update_connections(kf0)
        s.update_connections(kf1)
        # BA over the 2-view map (ref: GlobalBundleAdjustemnt(20))
        self.mapper.local_bundle_adjustment(kf1)
        # scale so median scene depth = 1 (mono gauge)
        depth = s.median_scene_depth(kf0)
        if depth <= 0 or s.mp_nobs[ids].max(initial=0) < 2:
            self.reset()
            return
        s.kf_t[kf1] /= depth
        live = ids[s.mp_valid[ids]]
        s.mp_pos[live] /= depth
        s.update_normal_and_depth(live)
        f0.set_pose(s.kf_R[kf0], s.kf_t[kf0])
        f1.set_pose(s.kf_R[kf1], s.kf_t[kf1])
        f1.mp[:] = -1
        f1.mp[feats1[g]] = np.where(s.mp_valid[ids], ids, -1)
        self.ref_kf = kf1
        self.last_kf_frame_id = f1.frame_id
        self.state = OK
        self.init_frame = None

    # ------------------------------------------------------------------
    # frame-to-frame tracking
    # ------------------------------------------------------------------
    def _gather_frame_landmarks(self, frame: Frame):
        """Fixed-shape bundle of the landmarks bound to a frame: (pos,
        packed desc, octave, live) on the device + host landmark ids."""
        s = self.store
        mp = frame.mp
        map_live = (mp >= 0) & s.mp_valid[np.maximum(mp, 0)]
        sel = np.where(map_live, mp, 0)
        return (self._t(s.mp_pos[sel]), self._t(s.mp_desc[sel]),
                self._t(frame.octave), self._t(map_live),
                np.where(map_live, mp, -1))

    def _track_from_last(self, frame: Frame):
        """TrackWithMotionModel with TrackReferenceKeyFrame fallback."""
        cfg = self.cfg
        self._update_last_frame()
        last = self.last_frame
        if (self.velocity is not None and last is not None
                and last.R is not None and (last.mp >= 0).any()):
            R_pred, t_pred = _compose(*self.velocity, last.R, last.t)
            pos, desc, oct_, live, mp_ids = self._gather_frame_landmarks(last)
            R, t, n_inl, n_match, kp_match = _host(*_motion_track(
                self.cam, self._t(R_pred), self._t(t_pred), pos, desc, oct_,
                live, frame.dev("uv"), frame.dev("desc_packed"),
                frame.dev("octave"), frame.dev("valid")))
            n_inl, n_match = int(n_inl), int(n_match)
            self._dbg["motion_matches"] = n_match
            self._dbg["motion_inliers"] = n_inl
            if n_match >= cfg.min_track_matches and \
                    n_inl >= cfg.min_inliers_track:
                frame.set_pose(R, t)
                self._bind(frame, mp_ids, kp_match)
                return True, n_inl
        return self._track_reference_kf(frame)

    def _track_reference_kf(self, frame: Frame):
        cfg, s = self.cfg, self.store
        if self.ref_kf < 0 or not s.kf_valid[self.ref_kf]:
            return False, 0
        kf = self.ref_kf
        mp = s.kf_mp[kf]
        live = (mp >= 0) & s.mp_valid[np.maximum(mp, 0)]
        sel = np.where(live, mp, 0)
        signs = H.to_signs(H.unpack_bits(s.mp_desc[sel]), device=self.device)
        last = self.last_frame
        use_last = last is not None and last.R is not None
        R0 = last.R if use_last else s.kf_R[kf]
        t0 = last.t if use_last else s.kf_t[kf]
        R, t, n_inl, n_match, kp_match = _host(*_bow_track(
            self.cam, self._t(R0), self._t(t0), self._t(s.mp_pos[sel]),
            signs, self._t(live), frame.dev("uv"), frame.signs,
            frame.dev("octave"), frame.dev("valid")))
        n_inl = int(n_inl)
        if int(n_match) < 15 or n_inl < cfg.min_inliers_track:
            return False, 0
        frame.set_pose(R, t)
        self._bind(frame, np.where(live, mp, -1), kp_match)
        return True, n_inl

    def _bind(self, frame: Frame, mp_ids, kp_match):
        """Write landmark->keypoint matches into the frame (per-kp mp)."""
        frame.mp[:] = -1
        rows = np.nonzero((kp_match >= 0) & (mp_ids >= 0))[0]
        frame.mp[kp_match[rows]] = mp_ids[rows]

    # ------------------------------------------------------------------
    # local map tracking
    # ------------------------------------------------------------------
    def _local_keyframes(self, frame: Frame):
        """K1 = KFs observing the frame's landmarks (vote), + covisible
        expansion (parity: Tracking::UpdateLocalKeyFrames)."""
        s = self.store
        mp = frame.mp[frame.mp >= 0]
        mp = mp[s.mp_valid[mp]]
        if len(mp) == 0:
            return np.asarray([self.ref_kf] if self.ref_kf >= 0 else [],
                              np.int64)
        okf = s.mp_obs_kf[mp]
        okf = okf[okf >= 0]
        votes = np.bincount(okf, minlength=s.cfg.max_keyframes)
        k1 = np.nonzero(votes)[0]
        k1 = k1[s.kf_valid[k1]]
        order = np.argsort(-votes[k1], kind="stable")
        k1 = k1[order][:self.cfg.n_local_kf]
        # ref kf := max-vote keyframe
        if len(k1):
            self.ref_kf = int(k1[0])
        out = list(k1)
        seen = set(out)
        for k in k1:
            for nb in s.covisible_keyframes(int(k), n_best=5):
                if int(nb) not in seen and len(out) < 2 * self.cfg.n_local_kf:
                    out.append(int(nb))
                    seen.add(int(nb))
        return np.asarray(out, np.int64)

    def _gather_local_bundle(self, local_kf):
        """Device-resident landmark bundle for the local-KF set; cached on
        (map version, KF set) so steady-state frames skip the host gather
        and upload."""
        s, cfg = self.store, self.cfg
        key = (s.version, frozenset(int(k) for k in local_kf))
        hit = self._local_bundle_cache
        if hit is not None and hit[0] == key:
            return hit[1]
        mp_ids = s.local_map_points(local_kf)
        bundle = s.gather_map_points(mp_ids, pad_to=cfg.n_local_mp)
        dev = dict(ids=np.asarray(bundle["ids"]))
        for k in ("pos", "desc", "normal", "dmin", "dmax", "valid"):
            dev[k] = self._t(bundle[k])
        self._local_bundle_cache = (key, dev)
        return dev

    def _track_local_map(self, frame: Frame, n_inliers_in):
        cfg, s = self.cfg, self.store
        local_kf = self._local_keyframes(frame)
        if len(local_kf) == 0:
            return False, 0
        b = self._gather_local_bundle(local_kf)
        R, t, n_inl, kp_match, visible, inlier = _host(*_local_map_track(
            self.cam, self._t(frame.R), self._t(frame.t), b["pos"],
            b["desc"], b["normal"], b["dmin"], b["dmax"], b["valid"],
            frame.dev("uv"), frame.dev("desc_packed"), frame.dev("octave"),
            frame.dev("valid"), scale_factor=cfg.scale_factor,
            n_levels=cfg.n_levels))
        n_inl = int(n_inl)
        ids = b["ids"]
        vis = visible & (ids >= 0)
        inl = inlier & vis
        self._dbg["local_n_mp"] = int((ids >= 0).sum())
        self._dbg["local_visible"] = int(vis.sum())
        self._dbg["local_inliers"] = n_inl
        self._dbg["n_local_kf"] = len(local_kf)
        # visibility / found counters (MapPoint::IncreaseVisible/Found)
        s.mp_visible[ids[vis]] += 1
        s.mp_found[ids[inl]] += 1
        gate = cfg.min_inliers_reloc if (
            frame.frame_id - self.last_reloc_frame_id
            < cfg.max_frames_between_kf) else cfg.min_inliers_local
        if n_inl < gate:
            return False, n_inl
        frame.set_pose(R, t)
        self._bind(frame, ids, kp_match)
        return True, n_inl

    # ------------------------------------------------------------------
    # keyframe decision + creation
    # ------------------------------------------------------------------
    def _need_new_keyframe(self, frame: Frame, n_inliers) -> bool:
        """Parity: Tracking::NeedNewKeyFrame (monocular): a time trigger
        (c1a/c1b) AND the tracked-vs-reference condition c2."""
        cfg, s = self.cfg, self.store
        if frame.frame_id - self.last_reloc_frame_id \
                < cfg.max_frames_between_kf \
                and s.n_keyframes() > cfg.max_frames_between_kf:
            return False
        if self.ref_kf < 0:
            return False
        min_obs = 3 if s.n_keyframes() > 2 else 2
        ref_mp = s.kf_mp[self.ref_kf]
        ref_mp = ref_mp[ref_mp >= 0]
        n_ref = int((s.mp_nobs[ref_mp] >= min_obs).sum()) if len(ref_mp) else 0
        fid = frame.frame_id
        c1a = fid >= self.last_kf_frame_id + cfg.max_frames_between_kf
        c1b = fid >= self.last_kf_frame_id + cfg.min_frames_between_kf
        c2 = (n_inliers < cfg.kf_ref_ratio * n_ref
              and n_inliers > cfg.min_matches_new_kf)
        return bool((c1a or c1b) and c2)

    def _insert_keyframe(self, frame: Frame) -> int:
        """Store-side keyframe insertion (CreateNewKeyFrame's store part)."""
        s = self.store
        with s.lock:
            kf = s.add_keyframe(frame.R, frame.t, frame.uv,
                                frame.desc_packed, frame.octave,
                                frame.valid, timestamp=frame.timestamp,
                                frame_id=frame.frame_id, angle=frame.angle)
            feats = np.nonzero(frame.mp >= 0)[0]
            mps = frame.mp[feats]
            live = s.mp_valid[mps]
            s.add_observations(mps[live], kf, feats[live])
            self.ref_kf = kf
            self.last_kf_frame_id = frame.frame_id
        self._dbg["new_kf"] = kf
        return kf

    def _create_keyframe(self, frame: Frame):
        kf = self._insert_keyframe(frame)
        self._dbg["n_new_mp"] = self.mapper.process_keyframe(kf)
        # the frame IS this keyframe: adopt its post-BA pose, so the
        # frame->refKF anchor computed in _record is consistent
        if self.store.kf_valid[kf]:
            frame.set_pose(self.store.kf_R[kf], self.store.kf_t[kf])
        self._dbg.update({k: v for k, v in self.mapper.last_stats.items()
                          if k.startswith("t_")})

    # ------------------------------------------------------------------
    def reset(self):
        """Parity: Tracking::Reset — clear map + state, restart init."""
        s = self.store
        s.__init__(s.cfg)
        self.mapper.recent.clear()
        self._local_bundle_cache = None
        self.state = NOT_INITIALIZED
        self.velocity = None
        self.ref_kf = -1
        self.init_frame = None
        self.last_kf_frame_id = -1
        self.n_resets += 1
