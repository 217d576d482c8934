"""Relocalization — recover a LOST tracker against the keyframe database.

Port of ar_orbslam2_tpu/estimation/relocalization.py (the redesign of
Tracking::Relocalization, src/Tracking.cc): candidates from place
recognition, per-candidate descriptor matching (dense Hamming instead of
SearchByBoW), batched DLT-PnP RANSAC (replaces PnPsolver's EPnP RANSAC),
motion-only BA refine, then a projection top-up against the candidate's
covisible landmark neighborhood — the windowed Hamming search kernel at
n_local_mp landmarks x max_kp keypoints — and a final >= 50-inlier
acceptance gate: the reference's thresholds.

The structure is the reference's: the host walks the candidates and reads
one small result back per stage to decide whether to go on (a LOST frame is
rare; nothing here is captured into a graph). Each read is ONE transfer
(`_read`), counted in ``last_stats["syncs"]`` with the stage times of the
attempt. When the database returns no candidate the newest keyframes (by
creation number, ``kf_seq``) are tried instead, as the reference does.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core.device import resolve_device
from ..matching import matcher
from ..ops import hamming as H
from .pnp import pnp_ransac
from .pose_opt import pose_optimization


def _read(*tensors):
    """Several small device results in ONE device->host transfer (values
    are integers below 2**24 or float32, so a float32 carrier is exact).
    Returns numpy arrays of the tensors' own dtypes and shapes."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    host = flat.cpu().numpy()
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        a = host[at:at + n].reshape(tuple(t.shape))
        out.append(a.astype(np.bool_ if t.dtype == torch.bool else
                            np.float32 if t.dtype.is_floating_point else
                            np.int64))
        at += n
    return out


class Relocalizer:
    def __init__(self, store, mapper, cam, tcfg, kfdb=None,
                 max_candidates: int = 5, device=None):
        self.store = store
        self.mapper = mapper
        self.cam = cam
        self.tcfg = tcfg
        self.kfdb = kfdb            # KeyFrameDatabase; set by SlamSystem
        self.max_candidates = max_candidates
        self.device = resolve_device(mapper.device if device is None
                                     else device)
        self._gen = torch.Generator(device=self.device).manual_seed(7)
        # tests hand both packages one draw: callable(valid) -> samples
        self.draw = None
        self.n_success = 0
        self.last_stats: dict = {}

    def _t(self, a):
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def _candidates(self, frame, stats):
        if self.kfdb is not None:
            t0 = time.perf_counter()
            _, bow = self.kfdb.vocab.transform(frame.signs,
                                               frame.dev("valid"))
            bow, = _read(bow)
            t1 = time.perf_counter()
            cands = self.kfdb.detect_relocalization_candidates(bow)
            stats["syncs"] += 2         # the bow vector, the scores
            stats["t_bow_ms"] = (t1 - t0) * 1e3
            stats["t_candidates_ms"] = (time.perf_counter() - t1) * 1e3
            if cands:
                return cands[:self.max_candidates]
        # fallback: most recent keyframes
        s = self.store
        ids = s.keyframe_ids()
        ids = ids[np.argsort(-s.kf_seq[ids], kind="stable")]
        return [int(k) for k in ids[:self.max_candidates]]

    def relocalize(self, frame):
        """Try to estimate the frame pose from scratch. Returns inlier
        count on success (binding frame.mp + pose), else None."""
        s, cam, cfg = self.store, self.cam, self.tcfg
        t_start = time.perf_counter()
        stats = dict(syncs=0, tried=0, matches=0, pnp_inliers=0,
                     refine_inliers=0, final_inliers=0, kf=-1,
                     t_bow_ms=0.0, t_candidates_ms=0.0, t_match_ms=0.0,
                     t_pnp_ms=0.0, t_pose_opt_ms=0.0, t_topup_ms=0.0)
        self.last_stats = stats
        result = None
        cands = self._candidates(frame, stats)
        stats["candidates"] = list(cands)
        for kf in cands:
            with s.lock:            # vs the mapping worker's write-backs
                if not s.kf_valid[kf]:
                    continue
                mp = s.kf_mp[kf].copy()
                live = (mp >= 0) & s.mp_valid[np.maximum(mp, 0)]
                if live.sum() < 15:
                    continue
                sel = np.where(live, mp, 0)
                lm_desc = s.mp_desc[sel]
                lm_pos = s.mp_pos[sel]
            stats["tried"] += 1
            t0 = time.perf_counter()
            lm_signs = H.signs_from_packed(self._t(lm_desc))
            idx, _ = matcher.search_brute_force(
                lm_signs, self._t(live), frame.signs, frame.dev("valid"),
                th=H.TH_LOW, nn_ratio=0.75)
            idx, = _read(idx)
            stats["syncs"] += 1
            stats["t_match_ms"] += (time.perf_counter() - t0) * 1e3
            rows = np.nonzero(idx >= 0)[0]
            stats["matches"] = len(rows)
            if len(rows) < 15:
                continue
            xw = lm_pos[rows]
            uv = frame.uv[idx[rows]]
            octv = frame.octave[idx[rows]]
            pad = cfg.max_kp
            xw_p = np.zeros((pad, 3), np.float32)
            uv_p = np.zeros((pad, 2), np.float32)
            oct_p = np.zeros(pad, np.int32)
            val_p = np.zeros(pad, bool)
            n = min(len(rows), pad)
            xw_p[:n], uv_p[:n], oct_p[:n], val_p[:n] = \
                xw[:n], uv[:n], octv[:n], True
            t0 = time.perf_counter()
            xw_d, uv_d, oct_d, val_d = (self._t(xw_p), self._t(uv_p),
                                        self._t(oct_p), self._t(val_p))
            samples = None if self.draw is None else self.draw(val_p)
            out = pnp_ransac(xw_d, uv_d, oct_d, val_d, cam,
                             generator=self._gen, samples=samples)
            ok, n_pnp = _read(out["ok"], out["n_inliers"])
            stats["syncs"] += 1
            stats["t_pnp_ms"] += (time.perf_counter() - t0) * 1e3
            stats["pnp_inliers"] = int(n_pnp)
            if not bool(ok):
                continue
            t0 = time.perf_counter()
            res = pose_optimization(out["R"], out["t"], xw_d, uv_d, oct_d,
                                    val_d & out["inlier"], cam)
            n_ref, R, t = _read(res["n_inliers"], res["R"], res["t"])
            stats["syncs"] += 1
            stats["t_pose_opt_ms"] += (time.perf_counter() - t0) * 1e3
            stats["refine_inliers"] = int(n_ref)
            if int(n_ref) < 10:
                continue
            # projection top-up against the candidate's local landmarks
            frame.set_pose(R, t)
            t0 = time.perf_counter()
            n_inl = self._projection_topup(frame, kf)
            stats["syncs"] += 1
            stats["t_topup_ms"] += (time.perf_counter() - t0) * 1e3
            stats["final_inliers"] = n_inl
            stats["kf"] = int(kf)
            if n_inl >= cfg.min_inliers_reloc:
                self.n_success += 1
                result = n_inl
                break
        stats["ok"] = result is not None
        stats["t_total_ms"] = (time.perf_counter() - t_start) * 1e3
        return result

    def _projection_topup(self, frame, kf):
        """SearchByProjection over the candidate KF's covisible landmark
        set + final pose optimization (the reference's 'not enough inliers
        -> search more points' loop collapsed into one dense pass)."""
        s, cam, cfg = self.store, self.cam, self.tcfg
        with s.lock:
            kfs = np.concatenate([[kf], s.covisible_keyframes(kf, n_best=10)])
            mp_ids = s.local_map_points(kfs.astype(np.int64))
            bundle = s.gather_map_points(mp_ids, pad_to=cfg.n_local_mp)
        pos = self._t(bundle["pos"])
        R0, t0 = self._t(frame.R), self._t(frame.t)
        kp_uv, kp_oct = frame.dev("uv"), frame.dev("octave")
        idx, visible, _ = matcher.search_local_points(
            cam, R0, t0, pos, self._t(np.asarray(bundle["desc"], np.uint8)),
            self._t(bundle["normal"]), self._t(bundle["dmin"]),
            self._t(bundle["dmax"]), self._t(bundle["valid"]),
            kp_uv, frame.dev("desc_packed"), kp_oct, frame.dev("valid"),
            th_radius=10.0, th=H.TH_HIGH, nn_ratio=1.0,
            n_levels=cfg.n_levels, scale_factor=cfg.scale_factor)
        matched = idx >= 0
        j = torch.clamp(idx, min=0).long()
        res = pose_optimization(R0, t0, pos, kp_uv[j], kp_oct[j], matched,
                                cam)
        inlier, kp_match, R, t = _read(res["inlier"] & matched, idx,
                                       res["R"], res["t"])
        ids = np.asarray(bundle["ids"])
        frame.set_pose(R, t)
        frame.mp[:] = -1
        rows = np.nonzero(inlier & (ids >= 0))[0]
        frame.mp[kp_match[rows]] = ids[rows]
        return int(inlier.sum())
