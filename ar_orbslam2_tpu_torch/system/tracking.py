"""Tracking front end — the per-frame state machine.

Port of ar_orbslam2_tpu/system/tracking.py (the reference's
Tracking::Track): the state machine (NOT_INITIALIZED -> OK -> LOST) and the
keyframe decision live on the host; every numeric stage — projective
search, motion-only BA, local-map search — is a torch function on the
system's device. The per-frame path reads back once per stage; the fused
path (system/fused.py) reads back one record per frame, or per chunk.

Per frame: predict pose (velocity model) -> SearchByProjection vs the last
frame's landmarks -> PoseOptimization (reference-KF brute-force fallback)
-> TrackLocalMap (covisibility expansion + SearchLocalPoints +
PoseOptimization) -> inlier gates -> keyframe decision -> LocalMapper.

Fused paths: ``track_fused`` (one frame), ``track_fused_chunk`` (a chunk,
synchronous mapping) and ``track_fused_chunk_async`` (records of a chunk
collected by the pipelined caller, mapping on the worker thread: soft and
hard keyframe tiers, peak-frame choice, the LOST-vs-rescue branch).

A frame that cannot be tracked, and every frame while LOST, goes to the
relocalizer (estimation/relocalization.py) when the system has one; the
fused paths hand such a frame to the per-frame path, and once it has
relocalized the callers rebuild the fused state from it through the same
static buffers (no new graph capture). Each keyframe goes to the loop
closer (loop/loop_closing.py), or without one into the relocalizer's
place-recognition database, on the thread that finishes its mapping; the
two share one database.

Depth sensors (stereo, RGB-D): a frame with at least 100 keypoints of
known depth initializes the map from that one frame at metric scale
(``_initialize_stereo``); the keyframe decision adds the close-point
census, and every keyframe seeds landmarks from its depth
(``_create_depth_points``). Localization mode (``only_tracking``) freezes
the map: no keyframe is inserted, no reset follows an early loss, and when
fewer than 10 map points stay matched the frame is tracked on temporal
points unprojected from the last frame's depth (the ``vo`` regime, the
reference's mbVO), with a relocalization attempt every frame until the map
is found again.

Without a relocalizer a failed frame goes LOST, as it does in the JAX
package with relocalization disabled.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core.device import resolve_device
from ..estimation.initializer import initialize_two_view
from ..estimation.pose_opt import pose_optimization_compact
from ..matching import matcher
from ..ops import hamming as H
from .frame import Frame

NOT_INITIALIZED = "NOT_INITIALIZED"
OK = "OK"
LOST = "LOST"
# per-frame decay of the inlier peak that the pipelined path's hard-decline
# rescue compares with. The JAX package decays it 5% a frame; a camera that
# turns faster than the mapping worker maps loses inliers a few percent a
# frame, the peak keeps pace and the rescue never fires, so tracking runs
# down to LOST (PERF.md §6: the room loop). 1% a frame keeps the
# reference level near the recent peak.
INLIER_PEAK_DECAY = 0.99


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
    # stereo/RGB-D: create landmarks from keypoints closer than this depth
    # at every new keyframe (meters; 0 = disabled/monocular). Parity:
    # mThDepth = ThDepth * baseline (Tracking ctor); SlamSystem sets it
    depth_threshold_m: float = 0.0
    # always seed at least this many closest depth points per new KF
    min_depth_points: int = 100


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


@torch.no_grad()
def _bound_pose_opt(cam, R0, t0, xw, uv, oct_, valid):
    """Motion-only BA on FIXED keypoint->landmark bindings (no search).
    Used to re-align a deferred keyframe's pose to the live map: its
    chi2-inlier associations are trusted, only the landmark positions
    may have moved under the concurrent mapper BA."""
    res = pose_optimization_compact(R0, t0, xw, uv, oct_, valid, cam,
                                    uv.shape[0])
    inl = res["inlier"] & valid
    return res["R"], res["t"], inl.to(torch.int32).sum(), inl


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


class _FrameShim:
    """Lightweight stand-in for a Frame in fused-mode metrics records —
    carries exactly what _record/_need_new_keyframe touch, so ordinary
    frames never materialize their device arrays."""

    def __init__(self, frame_id, timestamp, R, t):
        self.frame_id = frame_id
        self.timestamp = timestamp
        self.R = R
        self.t = t
        self.ref_kf = -1
        self.ref_seq = None
        self.R_cr = None
        self.t_cr = None


class Tracking:
    """Host state machine driving the per-frame device stages."""

    def __init__(self, store, local_mapper, cam,
                 cfg: TrackingConfig = TrackingConfig(), device=None,
                 seed=0, relocalizer=None, loop_closer=None):
        self.store = store
        self.mapper = local_mapper
        self.cam = cam
        self.cfg = cfg
        self.device = resolve_device(device)
        self.seed = seed                    # RANSAC draw of each init attempt
        self.relocalizer = relocalizer      # set by SlamSystem
        self.loop_closer = loop_closer
        self.fused = None                   # FusedFrontend (image mono path)
        self.async_mapper = None            # AsyncMapper (mapping thread)
        self.only_tracking = False          # localization mode
        # localization-mode VO regime (parity: Tracking::mbVO): True while
        # tracking rides temporal depth points instead of the map;
        # relocalization is attempted every frame until the map is back
        self.vo = False
        self.state = NOT_INITIALIZED
        self.last_frame: Frame | None = None
        self.velocity = None                # (R, t) of T_cur * T_last^-1
        self.ref_kf = -1
        self.last_kf_frame_id = -1
        self.last_reloc_frame_id = -1_000_000
        self.init_frame: Frame | None = None
        self.metrics: list[dict] = []
        self.last_rel = None      # (R_cr, t_cr, ref_kf, ref_seq), last OK frame
        self._inl_peak = 0.0      # max inliers SINCE LAST KF (c2_live ref)
        self._inl_decay = 0.0     # decaying peak, survives KF inserts
        #                           (hard-decline barrier reference)
        self._low_streak = 0      # consecutive sub-threshold frames
        self._fused_prev_pose = None
        self._dbg_submit_ms = None
        # set once the worker has mapped the last SOFT keyframe (insert,
        # triangulation, fusion, local BA); the pipelined caller waits on
        # it before it dispatches the next chunk
        self.kf_mapped: threading.Event | None = None
        self.n_resets = 0
        self.n_rescue_dropped = 0  # rescue keyframes that did not hold
        self._dbg: dict = {}     # per-frame stage diagnostics -> metrics
        # device-resident local-map bundle, cached on (map version, KF set)
        self._local_bundle_cache: tuple | None = None

    def _t(self, a):
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    # ------------------------------------------------------------------
    def track(self, frame: Frame) -> dict:
        """Process one frame; returns a metrics dict incl. pose if OK."""
        if self.state == NOT_INITIALIZED:
            if frame.depth is not None and \
                    int((frame.depth > 0).sum()) >= 100:
                ok = self._initialize_stereo(frame)
            else:
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
        vo_tracked = False
        if self.state == OK:
            ok, n_inliers = self._track_from_last(frame)
            if self.only_tracking and ok:
                # mbVO: fewer than 10 map-point inliers means the frame
                # rides temporal/VO points, not the map
                mp = frame.mp
                n_map = int(((mp >= 0)
                             & self.store.mp_valid[np.maximum(mp, 0)]).sum())
                self.vo = n_map < 10
                vo_tracked = self.vo
        if self.only_tracking and self.vo:
            # VO regime: attempt relocalization EVERY frame; a success
            # re-acquires the map (parity: the bOKReloc branch)
            ok_r, n_r = self._relocalize(frame)
            if ok_r:
                self.vo = False
                vo_tracked = False
                ok, n_inliers = ok_r, n_r
                self.last_reloc_frame_id = frame.frame_id
        if self.state == LOST or not ok:
            ok, n_inliers = self._relocalize(frame)
            if ok:
                self.last_reloc_frame_id = frame.frame_id
                self.vo = False
                vo_tracked = False
        if ok and not vo_tracked:
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
            # is a mapping-mode recovery: in localization mode the frozen
            # map must survive
            if not self.only_tracking and self.store.n_keyframes() \
                    <= self.cfg.reset_if_lost_before_kfs:
                self.reset()
        rec = self._record(frame, ok_flag=ok, n_inliers=n_inliers)
        self.last_frame = frame
        return rec

    # ------------------------------------------------------------------
    # fused device-resident steady-state path (system/fused.py)
    # ------------------------------------------------------------------
    def _gate(self, frame_id) -> int:
        cfg = self.cfg
        return cfg.min_inliers_reloc if (
            frame_id - self.last_reloc_frame_id
            < cfg.max_frames_between_kf) else cfg.min_inliers_local

    def _rebuild_on_keyframe(self, kf):
        """Fresh device bundle anchored at keyframe `kf`. The rebuild
        deliberately DROPS the velocity model: have_vel=False routes the
        next frame through the brute-force fallback — a full
        re-acquisition against the fresh bundle that resets any
        accumulated windowed-search drift."""
        s = self.store
        self.fused.rebuild(kf, s.kf_mp[kf], s.kf_R[kf], s.kf_t[kf])
        self._fused_prev_pose = (s.kf_R[kf].copy(), s.kf_t[kf].copy())

    def track_fused(self, image_u8, timestamp, frame_id) -> dict:
        """One OK-state frame via the fused megastep: one frame step on the
        device, one record readback. Falls back to the per-frame path
        (materializing the frame once, in one batched readback) on
        tracking failure or keyframe events."""
        fe = self.fused
        t0 = time.perf_counter()
        dev = fe.step(fe.extract(image_u8))
        t_step = time.perf_counter() - t0
        n_inl = int(dev["n_inliers"])
        ok = bool(dev["pre_ok"]) and n_inl >= self._gate(frame_id)
        self._dbg.update(
            motion_matches=int(dev["motion_matches"]),
            motion_inliers=int(dev["motion_inliers"]),
            fb_used=bool(dev["fb_ok"] and not dev["motion_ok"]),
            local_inliers=n_inl, local_visible=int(dev["n_visible"]),
            fused=True, t_track_ms=round(t_step * 1e3, 2))
        if not ok:
            # one batched readback -> per-frame LOST/relocalization handling
            frame = fe.materialize_frame(timestamp, frame_id)
            fe.invalidate()
            self.state = LOST
            self.velocity = None
            return self.track(frame)

        self.state = OK
        R, t = dev["R"], dev["t"]
        if self._fused_prev_pose is not None:
            R_l, t_l = self._fused_prev_pose
            Rv = R @ R_l.T
            self.velocity = (Rv, t - Rv @ t_l)
        self._fused_prev_pose = (R, t)

        shim = _FrameShim(frame_id, timestamp, R, t)
        if self._need_new_keyframe(shim, n_inl):
            t1 = time.perf_counter()
            frame = fe.materialize_frame(timestamp, frame_id)
            self._create_keyframe(frame)
            # post-BA pose of the new KF anchors the next frame
            self._rebuild_on_keyframe(self.ref_kf)
            self.last_frame = frame
            shim.R, shim.t = frame.R, frame.t
            self._dbg["t_kf_ms"] = round(
                (time.perf_counter() - t1) * 1e3, 2)
        return self._record(shim, ok_flag=True, n_inliers=n_inl)

    def _record_chunk_frame(self, recs, c, fid, timestamp, ms_per_frame):
        """Record frame c of a chunk's stacked records. Returns
        (shim, n_inliers)."""
        n_inl = int(recs["n_inliers"][c])
        R = np.asarray(recs["R"][c])
        t = np.asarray(recs["t"][c])
        shim = _FrameShim(fid, timestamp, R, t)
        self._dbg = dict(
            motion_matches=int(recs["motion_matches"][c]),
            motion_inliers=int(recs["motion_inliers"][c]),
            fb_used=bool(recs["fb_ok"][c] and not recs["motion_ok"][c]),
            local_inliers=n_inl,
            local_visible=int(recs["n_visible"][c]),
            fused=True, chunked=True,
            t_track_ms=round(ms_per_frame, 2))
        self._record(shim, ok_flag=True, n_inliers=n_inl)
        self._fused_prev_pose = (R, t)
        return shim, n_inl

    def _chunk_velocity(self, recs, consumed):
        if consumed >= 2:
            R1, t1 = self._fused_prev_pose
            R0 = np.asarray(recs["R"][consumed - 2])
            t0 = np.asarray(recs["t"][consumed - 2])
            Rv = R1 @ R0.T
            self.velocity = (Rv, t1 - Rv @ t0)

    def track_fused_chunk(self, images, timestamps, base_frame_id) -> int:
        """Throughput mode: one dispatch for a whole image chunk.

        Per-frame gates and the keyframe decision are applied AFTER the
        chunk from the stacked records (the reference's asynchronous
        mapper has the same map-update latency). Returns the number of
        frames consumed from the chunk start; on a mid-chunk tracking
        failure the remaining frames are left for the caller's per-frame
        path and the state machine goes LOST.
        """
        fe = self.fused
        C = len(images)
        t0 = time.perf_counter()
        recs = fe.step_chunk(images)
        ms_per_frame = (time.perf_counter() - t0) * 1e3 / C

        consumed = 0
        kf_at = -1
        for c in range(C):
            fid = base_frame_id + c
            ok = bool(recs["pre_ok"][c]) and \
                int(recs["n_inliers"][c]) >= self._gate(fid)
            if not ok:
                break
            shim, n_inl = self._record_chunk_frame(
                recs, c, fid, timestamps[c], ms_per_frame)
            consumed += 1
            # parity: keyframes are only accepted while the mapping stage
            # is idle (LocalMapping::SetAcceptKeyFrames)
            accept_kf = not self.only_tracking and (
                self.async_mapper is None or not self.async_mapper.busy())
            if accept_kf and self._need_new_keyframe(shim, n_inl):
                # adaptive consumption: stop HERE, promote THIS frame to
                # a keyframe from its on-device snapshot; the rest of the
                # chunk re-enters against the updated map
                kf_at = c
                break

        self._chunk_velocity(recs, consumed)

        if kf_at < 0 and consumed < C:
            # mid-chunk failure: frames before it are committed, the rest
            # re-enter through the per-frame path; next frame relocalizes
            fe.invalidate()
            self.state = LOST
            self.velocity = None
            return consumed

        if kf_at >= 0:
            t1 = time.perf_counter()
            frame = fe.materialize_chunk_frame(
                kf_at, timestamps[kf_at], base_frame_id + kf_at)
            if self.async_mapper is not None:
                # insert the keyframe synchronously (cheap store writes),
                # hand the mapping stage to the worker, and KEEP TRACKING
                # on the current device bundle; the bundle refreshes at
                # a later chunk boundary once the mapper is idle
                kf = self._insert_keyframe(frame)
                self.async_mapper.submit(kf, self.store.kf_seq[kf])
                self.last_frame = frame
            else:
                self._create_keyframe(frame)
                self._rebuild_on_keyframe(self.ref_kf)
                self.last_frame = frame
            if self.metrics:
                self.metrics[-1]["t_kf_ms"] = round(
                    (time.perf_counter() - t1) * 1e3, 2)
        return consumed

    def track_fused_chunk_async(self, recs, timestamps, base_frame_id,
                                ms_per_frame=0.0) -> int:
        """Pipelined-mode record processing for an ALREADY-collected chunk
        (async mapping): the caller dispatched the next chunk before
        collecting this one, so a keyframe event does NOT stop the chunk —
        the remaining frames rode the same bundle (exactly the
        reference's tracking/mapping thread latency). The FIRST keyframe
        candidate (mapper idle) is materialized from the on-device
        snapshot, inserted, and handed to the mapping worker.

        Keyframe handling has two tiers:
          * SOFT trigger (NeedNewKeyFrame fires while inliers are still
            healthy): the whole event runs on the worker; ``kf_mapped``
            is set once its local mapping is done, and the pipelined
            caller waits for it before it dispatches the next chunk,
            against a bundle refreshed from that map.
          * HARD decline (inliers fall below 0.45x the decayed peak — the
            scene is outrunning the frozen bundle): the chunk BREAKS at
            that frame, the KF is inserted, triangulate + fuse run to
            completion (barrier), and the bundle is rebuilt before
            chunking resumes.

        Returns the number of frames consumed; < C means the caller must
        discard any prefetched chunk and re-enter at that index (state
        stays OK after a hard-KF barrier; LOST on a tracking failure).
        """
        fe, cfg = self.fused, self.cfg
        C = len(timestamps)
        consumed = 0
        kf_list: list[int] = []
        vref = None      # virtual n_ref after an in-chunk KF decision
        hard = False
        kf_fid_before = self.last_kf_frame_id
        for c in range(C):
            fid = base_frame_id + c
            ok = bool(recs["pre_ok"][c]) and \
                int(recs["n_inliers"][c]) >= self._gate(fid)
            if not ok:
                break
            shim, n_inl = self._record_chunk_frame(
                recs, c, fid, timestamps[c], ms_per_frame)
            consumed += 1
            # keyframe cadence must match the per-frame path. After an
            # in-chunk decision the store's n_ref is stale, so later
            # frames compare against the VIRTUAL reference count — the
            # inlier count at the last decision.
            accept_kf = not self.only_tracking and (
                self.async_mapper is None
                or self.async_mapper.queue_idle())
            if vref is None:
                need = self._need_new_keyframe(shim, n_inl)
            else:
                need = (n_inl < cfg.kf_ref_ratio * vref
                        and n_inl > cfg.min_matches_new_kf)
            if accept_kf and need and len(kf_list) < 1:
                kf_list.append(c)
                vref = n_inl
                self.last_kf_frame_id = fid
            # hard decline: break the chunk and rebuild behind a mapping
            # barrier. Reference level = the DECAYING peak (_inl_decay),
            # which survives worker-side KF inserts. Two guards keep it a
            # LOSS RESCUE, not a churn source: the absolute 4x-gate cap
            # and a 2-frame streak.
            low = (not self.only_tracking and self.store.n_keyframes() > 2
                   and self._inl_decay >= 4 * cfg.min_inliers_local
                   and n_inl < 0.45 * self._inl_decay
                   and n_inl < 4 * cfg.min_inliers_local)
            self._low_streak = self._low_streak + 1 if low else 0
            if low and self._low_streak >= 2:
                hard = True
                if not kf_list or kf_list[-1] != c:
                    kf_list.append(c)
                    self.last_kf_frame_id = fid
                break

        self._chunk_velocity(recs, consumed)

        if consumed < C and not hard:
            # A frozen-bundle outrun can kill pre_ok within ONE chunk. If
            # the scene was healthy a few frames ago this is an outrun,
            # not a visual loss: run the hard-KF rescue (peak-frame KF +
            # mapping barrier + bundle rebuild) and re-enter against the
            # extended map instead of going LOST.
            if (not self.only_tracking and self.store.n_keyframes() > 2
                    and consumed > 0
                    and self._inl_decay >= 4 * cfg.min_inliers_local):
                hard = True
                if not kf_list or kf_list[-1] != consumed - 1:
                    kf_list.append(consumed - 1)
            else:
                fe.invalidate()
                self.state = LOST
                self.velocity = None
                return consumed

        if kf_list:
            t1 = time.perf_counter()
            # anchor snapshot for re-anchoring the new KF's pose from the
            # bundle-snapshot frame into the CURRENT map frame (async BA
            # may have moved the anchor): T_new = T_rel * T_anchor_now
            if fe.rec_anchor is not None:
                anchor_info = fe.rec_anchor
            else:
                anchor_info = (fe.anchor_kf, fe.anchor_R, fe.anchor_t,
                               fe.anchor_seq)
            # on a hard break insert the HEALTHIEST frame since the last
            # KF decision, not the collapse frame: the peak frame holds
            # nearly the same forward coverage with a sound pose; the
            # break frame itself re-enters the per-frame path against the
            # rebuilt bundle (caller re-enters at `consumed`).
            if hard:
                lo = kf_list[0] + 1 if len(kf_list) > 1 else 0
                inl_win = np.asarray(recs["n_inliers"][lo:consumed])
                kf_at = (lo + int(np.argmax(inl_win))) if len(inl_win) \
                    else kf_list[-1]
            else:
                kf_at = kf_list[0]
            am = self.async_mapper
            if am is not None and not hard:
                # SOFT keyframe: the ENTIRE event (snapshot readback +
                # insert + mapping) runs on the worker — the materialize
                # readback queues behind the chunk in flight, and the
                # tracking thread must not block on it
                snaps, done = fe._chunk_snaps, fe._chunk_done
                # ids table matching THIS chunk's snapshots (a pipelined
                # refresh may have swapped the live bundle_ids since)
                ids = fe.rec_ids if fe.rec_ids is not None \
                    else fe.bundle_ids
                ts_kf = timestamps[kf_at]
                fid_kf = base_frame_id + kf_at
                t_sub = time.perf_counter()
                mapped = self.kf_mapped = threading.Event()
                am.submit_task(lambda: self._deferred_kf_event(
                    snaps, kf_at, ts_kf, fid_kf, ids, anchor_info, done,
                    kf_fid_before, mapped))
                self._dbg_submit_ms = round(
                    (time.perf_counter() - t_sub) * 1e3, 2)
            else:
                if am is not None and hard:
                    # barrier FIRST: the live re-track below must see
                    # the worker's completed map writes
                    am.join()
                frame = fe.materialize_chunk_frame(
                    kf_at, timestamps[kf_at], base_frame_id + kf_at)
                self._reanchor_frame(frame, anchor_info)
                if hard and self._refresh_kf_pose(frame) \
                        < cfg.min_inliers_local:
                    # The frame's own bindings do not hold its pose on the
                    # live map (a loop correction moved the map under the
                    # chunk). The JAX package inserts the keyframe anyway
                    # (tracking.py:619-626), at a pose that can be
                    # decimetres off; the port drops it, as a deferred
                    # insert is dropped, and re-acquires against a bundle
                    # rebuilt on the reference keyframe.
                    self.last_kf_frame_id = kf_fid_before
                    self.n_rescue_dropped += 1
                    with self.store.lock:
                        self._rebuild_on_keyframe(self.ref_kf)
                    return consumed
                kf = self._insert_keyframe(frame)
                if am is not None and hard:
                    # run ONLY the coverage-critical stages (triangulate
                    # + fuse) here; local BA goes back to the worker —
                    # the next chunk needs new LANDMARKS, not BA polish
                    self.mapper.process_keyframe(kf, do_ba=False)
                    seq = int(self.store.kf_seq[kf])
                    am.submit_task(lambda: self._finish_kf_async(kf, seq))
                elif am is not None:
                    am.submit(kf, self.store.kf_seq[kf])
                else:
                    self.mapper.process_keyframe(kf)
                self.last_frame = frame
                if hard and self.store.kf_valid[kf]:
                    # the next chunk must see the extended map; no
                    # velocity -> brute-force re-acquisition (drift reset)
                    with self.store.lock:
                        self._rebuild_on_keyframe(kf)
            if self.metrics:
                self.metrics[-1]["t_kf_ms"] = round(
                    (time.perf_counter() - t1) * 1e3, 2)
                self.metrics[-1]["kf_hard"] = hard
                if self._dbg_submit_ms is not None:
                    self.metrics[-1]["t_kf_submit_ms"] = self._dbg_submit_ms
                    self._dbg_submit_ms = None
        return consumed

    def _refresh_kf_pose(self, frame) -> int:
        """Re-optimize a deferred/hard keyframe's pose against the LIVE
        positions of its own bindings before insertion.

        The pipelined snapshot's pose was tracked against a bundle up to
        two chunks stale; the rigid reanchor corrects the ANCHOR's
        motion but not the non-rigid part of the mapper's BA updates.
        This trusts the snapshot's chi2-inlier associations and re-runs
        motion-only BA with the landmark positions read from the store
        NOW (under the store lock: the mapping worker writes them).
        Outlier bindings are pruned; the pose is updated only when enough
        inliers survive. Returns the surviving inlier count."""
        s = self.store
        mp = frame.mp
        bound = mp >= 0
        if int(bound.sum()) < 10:
            return 0
        with s.lock:
            xw = np.where(bound[:, None], s.mp_pos[np.maximum(mp, 0)],
                          0.0).astype(np.float32)
        R, t, n_inl, inl = _host(*_bound_pose_opt(
            self.cam, self._t(frame.R), self._t(frame.t), self._t(xw),
            frame.dev("uv"), frame.dev("octave"), self._t(bound)))
        n_inl = int(n_inl)
        if n_inl >= self.cfg.min_inliers_local:
            frame.set_pose(R, t)
            frame.mp[:] = np.where(inl, mp, -1)
        return n_inl

    def _reanchor_frame(self, frame, anchor_info):
        """Rigidly move a snapshot-frame pose into the current map frame.
        anchor_info: (anchor keyframe, its R and t at the snapshot, its
        creation number: an anchor whose slot was reused since is
        skipped)."""
        anchor, a_R, a_t, seq = anchor_info
        if self.store.slot_is(anchor, seq):
            R_cr = frame.R @ a_R.T
            t_cr = frame.t - R_cr @ a_t
            with self.store.lock:
                frame.set_pose(
                    R_cr @ self.store.kf_R[anchor],
                    R_cr @ self.store.kf_t[anchor] + t_cr)

    def _finish_kf_async(self, kf, seq):
        """Worker-side tail of a HARD keyframe event: the BA + loop
        stages deferred out of the barrier (skipped if the keyframe's slot
        was culled and reused meanwhile). Returns None so the worker does
        not run process_keyframe again."""
        if self.store.kf_seq[kf] != seq:
            return None
        if self.store.kf_valid[kf]:
            self.mapper.local_bundle_adjustment(kf)
            self.mapper.cull_keyframes(kf)
        self._close_loops(kf)
        return None

    def _deferred_kf_event(self, snaps, j, timestamp, frame_id, bundle_ids,
                           anchor_info, done, kf_fid_before, mapped):
        """Worker-side SOFT keyframe event: the insert, then the keyframe's
        local mapping (triangulation, fusion, local BA, culling); `mapped`
        is set after it, before the loop closer takes the keyframe, so the
        tracker can refresh its bundle from a map that holds the keyframe
        without waiting for loop closing. Returns None: the worker has
        nothing left to run for it."""
        kf = None
        try:
            kf = self._deferred_kf_insert(snaps, j, timestamp, frame_id,
                                          bundle_ids, anchor_info, done=done,
                                          kf_fid_before=kf_fid_before)
            if kf is not None:
                self.mapper.process_keyframe(kf)
        finally:
            mapped.set()
        if kf is not None:
            self._close_loops(kf)
        return None

    def wait_for_keyframe_mapping(self):
        """Block until the worker has mapped the last soft keyframe (no-op
        when none is pending); raises if the worker died first (it skips
        the work queued after an error)."""
        mapped, self.kf_mapped = self.kf_mapped, None
        am = self.async_mapper
        while mapped is not None and not mapped.wait(0.05):
            if am.error is not None:
                raise RuntimeError("async mapper died") from am.error

    def _deferred_kf_insert(self, snaps, j, timestamp, frame_id,
                            bundle_ids, anchor_info, done=None,
                            kf_fid_before=None):
        """Worker-side half of a SOFT keyframe event (see submit_task).

        last_frame is published under store.lock together with the
        ref_kf/last_kf_frame_id writes inside _insert_keyframe, so the
        tracking thread's rebuild gating never observes a torn
        (new ref_kf, old last_frame) pair."""
        frame = self.fused.materialize_from(snaps, j, timestamp, frame_id,
                                            bundle_ids, done=done)
        self._reanchor_frame(frame, anchor_info)
        # Re-align the pose to the LIVE map before insertion (parity: the
        # reference's tracking thread always optimizes against the current
        # map under mMutexMapUpdate). A candidate whose bindings cannot
        # re-converge on the live map is dropped: mid-collapse garbage is
        # exactly what the decline/hard triggers will replace with a fresh
        # candidate.
        if self._refresh_kf_pose(frame) < self.cfg.min_inliers_local:
            # the decision stamped last_kf_frame_id for a keyframe that
            # will not exist: give the time trigger its old base back
            with self.store.lock:
                if kf_fid_before is not None \
                        and self.last_kf_frame_id == frame_id:
                    self.last_kf_frame_id = kf_fid_before
            return None
        with self.store.lock:       # RLock: one atomic publish with the
            kf = self._insert_keyframe(frame, record_dbg=False)
            self.last_frame = frame  # ref_kf/last_kf_frame_id writes
        return kf

    # ------------------------------------------------------------------
    def _record(self, frame, ok_flag, n_inliers):
        rec = dict(frame_id=frame.frame_id, timestamp=frame.timestamp,
                   state=self.state, ok=bool(ok_flag),
                   n_inliers=int(n_inliers),
                   n_kf=self.store.n_keyframes(),
                   n_mp=self.store.n_map_points(),
                   **self._dbg)
        # max inlier count SINCE THE LAST KEYFRAME INSERT — the live
        # "reference matches" level the KF triggers compare against
        # (reset to 0 by _insert_keyframe / on tracking failure); the
        # decaying peak survives KF inserts (a mid-collapse insert must
        # not blind the hard-decline barrier)
        if ok_flag:
            self._inl_peak = max(self._inl_peak, float(n_inliers))
            self._inl_decay = max(self._inl_decay * INLIER_PEAK_DECAY,
                                  float(n_inliers))
        else:
            self._inl_peak = 0.0
            self._inl_decay = 0.0
        self._dbg = {}
        if frame.R is not None:
            rec["R"] = frame.R.copy()
            rec["t"] = frame.t.copy()
            # pose relative to the reference KF at track time, so the final
            # trajectory benefits from later BA refinement of the KF
            # (parity: mlRelativeFramePoses in SaveTrajectoryTUM). Fused
            # frames anchor to the BUNDLE's anchor KF at its SNAPSHOT
            # pose: the tracked pose lives in the snapshot's map frame,
            # and async BA may have moved the KF since.
            fe = self.fused
            use_snap = (rec.get("fused") and fe is not None
                        and fe.state is not None and fe.anchor_kf >= 0)
            ref = self.ref_kf
            if use_snap:
                # chunked records use the anchor captured at the chunk's
                # DISPATCH (a pipelined device-side refresh may have
                # swapped the live anchor since)
                if fe.rec_anchor is not None:
                    ref, R_rw, t_rw, ref_seq = fe.rec_anchor
                else:
                    ref, ref_seq = fe.anchor_kf, fe.anchor_seq
                    R_rw, t_rw = fe.anchor_R, fe.anchor_t
            elif ref >= 0:
                with self.store.lock:   # vs async mapper write-backs
                    R_rw = self.store.kf_R[ref].copy()
                    t_rw = self.store.kf_t[ref].copy()
                    ref_seq = int(self.store.kf_seq[ref])
            rec["ref_kf"] = ref
            if ref >= 0:
                # the anchor's creation number: export and UpdateLastFrame
                # tell a reused slot from the anchor by it
                rec["ref_seq"] = ref_seq
                frame.ref_seq = ref_seq
                R_cr = frame.R @ R_rw.T
                rec["R_cr"] = R_cr
                rec["t_cr"] = frame.t - R_cr @ t_rw
                # last frame's KF-relative pose: lets the fused bundle
                # refresh RE-ANCHOR the tracked pose to the post-BA map
                self.last_rel = (R_cr, rec["t_cr"], ref, ref_seq)
                # anchor the frame to its reference KF so UpdateLastFrame
                # can re-compose against the KF's post-BA pose
                frame.ref_kf = ref
                frame.R_cr = R_cr
                frame.t_cr = rec["t_cr"]
        self.metrics.append(rec)
        return rec

    def _anchor_live(self, frame) -> bool:
        """Whether the frame's reference keyframe slot still holds the
        keyframe the frame was anchored to (not culled and reused)."""
        return self.store.slot_is(frame.ref_kf, frame.ref_seq)

    def _update_last_frame(self):
        """Parity: Tracking::UpdateLastFrame — re-anchor the last frame's
        pose to its reference keyframe's CURRENT pose before motion
        prediction (local BA moves keyframes between frames)."""
        last = self.last_frame
        ref = getattr(last, "ref_kf", -1)
        if last is None or ref < 0 or not self._anchor_live(last):
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
        self._register_kf_in_db(kf0)
        self._register_kf_in_db(kf1)

    def _unproject(self, frame: Frame, feats):
        """World positions of keypoints `feats` from their measured depth
        (host float32, the JAX package's arithmetic)."""
        cam = self.cam
        z = frame.depth[feats]
        x = (frame.uv[feats, 0] - cam.cx) * z / cam.fx
        y = (frame.uv[feats, 1] - cam.cy) * z / cam.fy
        xc = np.stack([x, y, z], -1).astype(np.float32)
        return (xc - frame.t) @ frame.R

    def _initialize_stereo(self, frame: Frame) -> bool:
        """Parity: Tracking::StereoInitialization (JAX tracking.py:921-949)
        — unproject keypoints with known depth into landmarks, one
        keyframe at the identity, state OK. The map is written under the
        store lock (the JAX function writes without it)."""
        s = self.store
        frame.set_pose(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        with s.lock:
            kf = s.add_keyframe(frame.R, frame.t, frame.uv,
                                frame.desc_packed, frame.octave, frame.valid,
                                timestamp=frame.timestamp,
                                frame_id=frame.frame_id, angle=frame.angle,
                                uvr=frame.uvr, depth=frame.depth)
            feats = np.nonzero(frame.valid & (frame.depth > 0))[0]
            xw = self._unproject(frame, feats)
            ids = s.add_map_points(xw, frame.desc_packed[feats], first_kf=kf)
            s.add_observations(ids, kf, feats)
            s.compute_distinctive_descriptors(ids)
            s.update_normal_and_depth(ids)
            s.update_connections(kf)
            frame.mp[feats] = ids
            self.ref_kf = kf
            self.last_kf_frame_id = frame.frame_id
        self.state = OK
        self._register_kf_in_db(kf)
        return True

    # ------------------------------------------------------------------
    # frame-to-frame tracking
    # ------------------------------------------------------------------
    def _gather_frame_landmarks(self, frame: Frame):
        """Fixed-shape bundle of the landmarks bound to a frame: (pos,
        packed desc, octave, live) on the device + host landmark ids.

        In localization mode with a depth sensor, keypoints WITHOUT a map
        binding but with measured depth become temporal "visual odometry"
        points (parity: the temporal MapPoints of Tracking::UpdateLastFrame,
        JAX tracking.py:952-982), so the motion search can ride
        frame-to-frame geometry off the map. Their descriptors are the
        frame's own, packed (the search kernel reads the packed form)."""
        s = self.store
        mp = frame.mp
        map_live = (mp >= 0) & s.mp_valid[np.maximum(mp, 0)]
        sel = np.where(map_live, mp, 0)
        pos = s.mp_pos[sel]
        desc = s.mp_desc[sel]
        live = map_live
        if self.only_tracking and frame.depth is not None \
                and frame.R is not None:
            vo = (~map_live) & frame.valid & (frame.depth > 0)
            if vo.any():
                pos[vo] = self._unproject(frame, vo)
                desc[vo] = frame.desc_packed[vo]
                live = map_live | vo
        return (self._t(pos), self._t(desc), self._t(frame.octave),
                self._t(live), np.where(map_live, mp, -1))

    def _track_from_last(self, frame: Frame):
        """TrackWithMotionModel with TrackReferenceKeyFrame fallback."""
        cfg = self.cfg
        self._update_last_frame()
        last = self.last_frame
        # in localization mode a depth frame carries its own temporal points
        can_vo = (self.only_tracking and last is not None
                  and last.depth is not None)
        if (self.velocity is not None and last is not None
                and last.R is not None and ((last.mp >= 0).any() or can_vo)):
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
        """Parity: Tracking::NeedNewKeyFrame (JAX tracking.py:1142-1197): a
        time trigger (c1a/c1b) AND the tracked-vs-reference condition c2.
        For depth sensors the close-point census (bNeedToInsertClose)
        drives the cadence, with the reference's 0.75 ratio and the c1c
        trigger."""
        cfg, s = self.cfg, self.store
        if self.only_tracking:
            return False
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
        ratio = cfg.kf_ref_ratio
        need_close = False
        depth_sensor = (getattr(frame, "depth", None) is not None
                        and cfg.depth_threshold_m > 0)
        if depth_sensor:
            close = (frame.valid & (frame.depth > 0)
                     & (frame.depth < cfg.depth_threshold_m))
            tracked = frame.mp >= 0
            n_tc = int((close & tracked).sum())
            n_ntc = int((close & ~tracked).sum())
            need_close = n_tc < 100 and n_ntc > 70
            ratio = 0.75
        fid = frame.frame_id
        c1a = fid >= self.last_kf_frame_id + cfg.max_frames_between_kf
        c1b = fid >= self.last_kf_frame_id + cfg.min_frames_between_kf
        c1c = depth_sensor and (n_inliers < 0.25 * n_ref or need_close)
        c2 = ((n_inliers < ratio * n_ref or need_close)
              and n_inliers > cfg.min_matches_new_kf)
        if isinstance(frame, _FrameShim):
            # Fused path: ref_kf is PINNED to the last-created KF between
            # keyframe events (the per-frame path re-elects it per frame to
            # the max-covisible KF), so raw n_ref is unrepresentative in
            # both directions. The honest reference level is the MAX INLIER
            # COUNT SINCE THE LAST KF INSERT (self._inl_peak): c2's 0.9
            # ratio against it fires 10% into a decline, while the pose is
            # still healthy. The 4x-min floor keeps Poisson noise under the
            # 10% threshold; below it only the time trigger fires.
            c2_live = (self._inl_peak >= 4 * cfg.min_inliers_local
                       and n_inliers < ratio * self._inl_peak
                       and n_inliers > cfg.min_matches_new_kf)
            return bool((c1a and c2) or c2_live)
        return bool((c1a or c1b or c1c) and c2)

    def _insert_keyframe(self, frame: Frame, record_dbg: bool = True) -> int:
        """Store-side keyframe insertion (cheap, synchronous): the part of
        CreateNewKeyFrame that must happen on the inserting thread."""
        s = self.store
        with s.lock:
            kf = s.add_keyframe(frame.R, frame.t, frame.uv,
                                frame.desc_packed, frame.octave,
                                frame.valid, timestamp=frame.timestamp,
                                frame_id=frame.frame_id, angle=frame.angle,
                                uvr=frame.uvr, depth=frame.depth)
            feats = np.nonzero(frame.mp >= 0)[0]
            mps = frame.mp[feats]
            live = s.mp_valid[mps]
            s.add_observations(mps[live], kf, feats[live])
            if frame.depth is not None and self.cfg.depth_threshold_m > 0:
                self._create_depth_points(frame, kf, record_dbg)
            # publish ref_kf/last_kf_frame_id INSIDE the store lock: the
            # deferred (worker-thread) insert otherwise exposes a torn
            # trio to the tracking thread's rebuild/cadence reads
            self.ref_kf = kf
            self.last_kf_frame_id = frame.frame_id
            # new reference window for the live KF triggers
            self._inl_peak = 0.0
        if record_dbg:      # worker-thread inserts must not touch _dbg
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
        t0 = time.perf_counter()
        self._close_loops(kf)
        self._dbg["t_loop_ms"] = round((time.perf_counter() - t0) * 1e3, 1)

    def _create_depth_points(self, frame: Frame, kf: int,
                             record_dbg: bool = True) -> int:
        """Stereo/RGB-D landmark seeding at a new keyframe (JAX
        tracking.py:1247-1288). Parity: Tracking::CreateNewKeyFrame's
        stereo branch: sort keypoints by measured depth and unproject every
        one closer than ThDepth·baseline (plus at least the 100 closest)
        that is not already bound to a surviving landmark. The new points
        join the mapper's recent set (MapPointCulling). Caller holds
        store.lock."""
        s, cfg = self.store, self.cfg
        z = frame.depth
        cand = np.nonzero(frame.valid & (z > 0))[0]
        if len(cand) == 0:
            return 0
        bound = frame.mp[cand]
        has_mp = (bound >= 0) & s.mp_valid[np.maximum(bound, 0)] \
            & (s.mp_nobs[np.maximum(bound, 0)] >= 1)
        cand = cand[~has_mp]
        if len(cand) == 0:
            return 0
        cand = cand[np.argsort(z[cand], kind="stable")]
        keep = z[cand] < cfg.depth_threshold_m
        keep[:cfg.min_depth_points] = True
        cand = cand[keep]
        if len(cand) == 0:
            return 0
        xw = self._unproject(frame, cand)
        ids = s.add_map_points(xw, frame.desc_packed[cand], first_kf=kf)
        s.add_observations(ids, kf, cand)
        frame.mp[cand] = ids
        s.compute_distinctive_descriptors(ids)
        s.update_normal_and_depth(ids)
        seq = int(s.kf_seq[kf])
        self.mapper.recent.update((int(m), seq) for m in ids)
        if record_dbg:      # worker-thread inserts must not touch _dbg
            self._dbg["n_depth_mp"] = len(ids)
        return len(ids)

    def _close_loops(self, kf: int):
        """A finished keyframe goes to the loop closer, or without one into
        the relocalizer's database."""
        if self.loop_closer is not None:
            self.loop_closer.insert_keyframe(kf)
        else:
            self._register_kf_in_db(kf)

    def _register_kf_in_db(self, kf: int):
        """Add a keyframe to the place-recognition database without running
        loop detection (the map's first keyframes)."""
        if self.loop_closer is not None:
            self.loop_closer.kfdb.add(kf)
        elif self.relocalizer is not None and \
                self.relocalizer.kfdb is not None:
            self.relocalizer.kfdb.add(kf)

    # ------------------------------------------------------------------
    def _relocalize(self, frame: Frame):
        if self.relocalizer is None:
            return False, 0
        out = self.relocalizer.relocalize(frame)
        self._dbg["reloc"] = dict(self.relocalizer.last_stats)
        if out is None:
            return False, 0
        return True, out

    # ------------------------------------------------------------------
    def reset(self):
        """Parity: Tracking::Reset — clear map + state, restart init."""
        if self.async_mapper is not None:      # drain in-flight mapping
            try:
                self.async_mapper.join()
            except RuntimeError:
                pass
        s = self.store
        s.__init__(s.cfg)
        self.mapper.recent.clear()
        self._local_bundle_cache = None
        if self.fused is not None:      # drop device state (map is gone)
            self.fused.state = None
            self.fused.version = -1
        self._fused_prev_pose = None
        self.last_rel = None
        self._inl_peak = 0.0
        self._inl_decay = 0.0
        self._low_streak = 0
        self.state = NOT_INITIALIZED
        self.velocity = None
        self.vo = False
        self.ref_kf = -1
        self.init_frame = None
        self.last_kf_frame_id = -1
        self.n_resets += 1
        if self.loop_closer is not None:
            self.loop_closer.reset()
