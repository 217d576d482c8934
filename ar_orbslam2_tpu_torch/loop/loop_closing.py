"""Loop closing — detection, Sim3 estimation, correction, global BA.

Port of ar_orbslam2_tpu/loop/loop_closing.py (the redesign of LoopClosing,
src/LoopClosing.cc): the loop thread is a stage run per keyframe. DetectLoop
(database query + covisibility-consistency over consecutive keyframes),
ComputeSim3 (descriptor match -> batched Horn RANSAC -> SearchBySim3 top-up
-> Sim3 Gauss-Newton -> projection top-up with the >= 40 gate), CorrectLoop
(Sim3 propagation over the current covisible group, landmark fusion,
essential-graph optimization, background global BA).

Every numeric stage is a torch function on the loop closer's device; the
host walks the candidates and reads one small result back per stage, as the
relocalizer does. The two windowed searches go through the hand kernel
(ops/cuda_hamming.py via matcher.windowed_match): SearchBySim3's two
directions have the same shapes and are ONE batched launch, the projection
top-up is one launch at max_loop_points landmarks x max_kp keypoints. The
brute-force match is a float32 matmul + top-2, as in the JAX package.

The RANSAC draw comes from a ``torch.Generator`` (seed 11, as the JAX
package's key); tests hand both packages one draw through ``draw``. Stage
times of each attempt land in ``stats_log``.
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core import camera as cam_mod
from ..core import lie
from ..core.device import resolve_device
from ..estimation.pose_graph import optimize_essential_graph
from ..estimation.sim3_solver import optimize_sim3, sim3_ransac
from ..mapping.background_gba import BackgroundGBA
from ..mapping.global_ba import global_bundle_adjustment
from ..matching import matcher
from ..ops import hamming as H
from .place_recognition import KeyFrameDatabase


@dataclass(frozen=True)
class LoopCloserConfig:
    consistency_threshold: int = 3      # mnCovisibilityConsistencyTh
    min_bow_matches: int = 20           # SearchByBoW gate in ComputeSim3
    min_sim3_inliers: int = 20          # OptimizeSim3 gate
    min_total_matches: int = 40         # projection top-up gate
    min_kf_gap: int = 10                # KFs since last loop before retry
    covis_edge_min_weight: int = 100    # essential-graph covisibility edges
    # one-time online k-medians codebook training once this many KFs
    # exist (LOOP_RECALL.md; 0 = keep the random codebook forever)
    vocab_train_at: int = 24
    fix_scale: bool = False             # True for stereo/RGB-D
    run_global_ba: bool = True
    # background GBA with abort + spanning-tree propagation (parity:
    # RunGlobalBundleAdjustment thread / mbStopGBA); False = inline
    background_gba: bool = True
    max_loop_points: int = 4096
    sim3_pad: int = 512                 # fixed correspondence capacity
    scale_factor: float = 1.2           # ORB pyramid scale


def _in_image(cam, uv, z):
    return ((z > 0.1) & (uv[..., 0] >= 0) & (uv[..., 0] < cam.width)
            & (uv[..., 1] >= 0) & (uv[..., 1] < cam.height))


def search_by_sim3(cam, R12, t12, s12, b1, b2, scale_factor=1.2):
    """Both directions of ORBmatcher::SearchBySim3: project each
    keyframe's landmarks into the other with the S12 estimate and
    window-search at radius 7.5 * scale^octave, octave +-1. b1/b2: device
    bundles (xc, desc packed, octave, live, uv). The two searches are one
    batched launch. Returns (m12 (P,), m21 (P,)), -1 for no match."""
    x2 = ((b1["xc"] - t12) @ R12) / torch.clamp(s12, min=1e-12)   # S21
    x1 = s12 * (b2["xc"] @ R12.T) + t12                             # S12
    uv_hat = torch.stack([cam_mod.project(cam, x2), cam_mod.project(cam, x1)])
    z_hat = torch.stack([x2[..., 2], x1[..., 2]])
    q_oct = torch.stack([b1["octave"], b2["octave"]]).to(torch.int32)
    q_live = torch.stack([b1["live"], b2["live"]])
    vis = q_live & _in_image(cam, uv_hat, z_hat)
    radius = 7.5 * scale_factor ** q_oct.to(torch.float32)
    m, _ = matcher.windowed_match(
        uv_hat, torch.stack([b1["desc"], b2["desc"]]), vis, radius,
        torch.stack([b2["uv"], b1["uv"]]), torch.stack([b2["desc"],
                                                        b1["desc"]]),
        torch.stack([b2["octave"], b1["octave"]]),
        torch.stack([b2["live"], b1["live"]]),
        octave_lo=q_oct - 1, octave_hi=q_oct + 1, th=H.TH_HIGH,
        nn_ratio=1.0, mutual=False)
    return m[0], m[1]


class LoopCloser:
    def __init__(self, store, mapper, cam,
                 cfg: LoopCloserConfig = LoopCloserConfig(), kfdb=None,
                 device=None):
        self.store = store
        self.mapper = mapper
        self.cam = cam
        self.cfg = cfg
        self.device = resolve_device(mapper.device if device is None
                                     else device)
        self.kfdb = kfdb or KeyFrameDatabase(store, device=self.device)
        # the last loop keyframe and the consistency groups are kept as
        # creation numbers (kf_seq: the ids until a keyframe slot is
        # reused), so a reused slot neither shortens the gap nor joins a
        # group it never belonged to
        self.last_loop_kf = -self.cfg.min_kf_gap
        self.consistent_groups: list[tuple[set, int]] = []
        self.loops: list[dict] = []
        self._gen = torch.Generator(device=self.device).manual_seed(11)
        # tests hand both packages one draw: callable(valid) -> samples
        self.draw = None
        self.gba = BackgroundGBA(store, cam, device=self.device)
        self.stats_log: list[dict] = []     # stage times per loop attempt
        self._loop_match = None

    def reset(self):
        """Empty the shared database in place (the relocalizer keeps using
        the same object) and forget the consistency groups."""
        self.kfdb.reset()
        self.consistent_groups = []
        self.last_loop_kf = -self.cfg.min_kf_gap
        self.gba.abort()

    def _t(self, a):
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    # ------------------------------------------------------------------
    def precompile(self):
        """Warm every stage on dummy inputs of the real shapes, on the
        calling thread and its current stream: CUDA modules, cuBLAS and
        cuSOLVER handles and the forward-mode Jacobians are set up before
        the first real loop, which then pays none of it mid-run."""
        cfg, cam, dev = self.cfg, self.cam, self.device
        P = self.store.cfg.max_kp
        f32, i32 = torch.float32, torch.int32
        desc = torch.zeros((P, H.DESC_BYTES), dtype=torch.uint8, device=dev)
        live = torch.zeros(P, dtype=torch.bool, device=dev)
        matcher.search_brute_force(H.signs_from_packed(desc), live,
                                   H.signs_from_packed(desc), live,
                                   th=H.TH_LOW, nn_ratio=0.75)
        Np = cfg.sim3_pad
        z3 = torch.zeros((Np, 3), dtype=f32, device=dev)
        z2 = torch.zeros((Np, 2), dtype=f32, device=dev)
        zo = torch.zeros(Np, dtype=i32, device=dev)
        zv = torch.zeros(Np, dtype=torch.bool, device=dev)
        r = sim3_ransac(cam, z3, z3, z2, z2, zo, zo, zv,
                        generator=self._gen, fix_scale=cfg.fix_scale,
                        scale_factor=cfg.scale_factor)
        b = dict(xc=torch.zeros((P, 3), dtype=f32, device=dev), desc=desc,
                 octave=torch.zeros(P, dtype=i32, device=dev), live=live,
                 uv=torch.zeros((P, 2), dtype=f32, device=dev))
        search_by_sim3(cam, r["R12"], r["t12"], r["s12"], b, b,
                       scale_factor=cfg.scale_factor)
        optimize_sim3(cam, r["R12"], r["t12"], r["s12"], z3, z3, z2, z2,
                      zo, zo, zv, fix_scale=cfg.fix_scale,
                      scale_factor=cfg.scale_factor)
        L = cfg.max_loop_points
        matcher.search_local_points(
            cam, torch.eye(3, device=dev), torch.zeros(3, device=dev),
            torch.zeros((L, 3), dtype=f32, device=dev),
            torch.zeros((L, H.DESC_BYTES), dtype=torch.uint8, device=dev),
            torch.zeros((L, 3), dtype=f32, device=dev),
            torch.zeros(L, dtype=f32, device=dev),
            torch.ones(L, dtype=f32, device=dev),
            torch.zeros(L, dtype=torch.bool, device=dev),
            b["uv"], desc, b["octave"], live,
            th_radius=10.0, th=H.TH_LOW, nn_ratio=1.0)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()

    # ------------------------------------------------------------------
    def insert_keyframe(self, kf: int) -> bool:
        """Run the loop pipeline for a new keyframe. Returns True if a
        loop was closed."""
        self.kfdb.add(kf)
        if self.cfg.vocab_train_at:
            self.kfdb.maybe_retrain(min_kfs=self.cfg.vocab_train_at)
        # harvest a finished background GBA (no-op while still running)
        self.gba.poll()
        seq = int(self.store.kf_seq[kf])
        if seq - self.last_loop_kf < self.cfg.min_kf_gap:
            return False
        t0 = time.perf_counter()
        cands = self._detect_loop(kf)
        t_detect = (time.perf_counter() - t0) * 1e3
        for cand in cands:
            stats = dict(kf=int(kf), cand=int(cand), t_detect_ms=t_detect)
            self.stats_log.append(stats)
            sim3 = self._compute_sim3(kf, cand, stats)
            if sim3 is None:
                continue
            self._correct_loop(kf, cand, sim3, stats)
            self.last_loop_kf = seq
            self.consistent_groups = []
            return True
        return False

    # ------------------------------------------------------------------
    def _detect_loop(self, kf: int):
        """Parity: LoopClosing::DetectLoop — candidates must be re-detected
        in consecutive keyframes with covisibility-group overlap."""
        s, cfg = self.store, self.cfg
        raw = self.kfdb.detect_loop_candidates(kf)
        if not raw:
            self.consistent_groups = []
            return []
        enough = []
        new_groups: list[tuple[set, int]] = []
        for cand in raw:
            group = {int(s.kf_seq[g]) for g in
                     [cand, *s.covisible_keyframes(cand, n_best=10)]}
            best_consistency = 0
            for prev_group, count in self.consistent_groups:
                if group & prev_group:
                    best_consistency = max(best_consistency, count + 1)
            new_groups.append((group, best_consistency))
            if best_consistency >= cfg.consistency_threshold - 1:
                enough.append(cand)
        self.consistent_groups = new_groups
        return enough

    # ------------------------------------------------------------------
    def _kf_landmark_bundle(self, kf: int):
        """Features of kf that carry landmarks: positions in kf camera
        coords + packed descriptors + uv + octave, per feature slot (host
        arrays, read under the store lock)."""
        s = self.store
        with s.lock:
            mp = s.kf_mp[kf].copy()
            live = (mp >= 0) & s.mp_valid[np.maximum(mp, 0)]
            sel = np.where(live, mp, 0)
            xw = s.mp_pos[sel]
            xc = (xw @ s.kf_R[kf].T + s.kf_t[kf]).astype(np.float32)
            return dict(mp=np.where(live, mp, -1), live=live, xw=xw, xc=xc,
                        desc=s.mp_desc[sel].copy(), uv=s.kf_uv[kf].copy(),
                        octave=s.kf_octave[kf].copy())

    def _device_bundle(self, b):
        return {k: self._t(b[k]) for k in ("xc", "desc", "octave", "live",
                                           "uv")}

    def _pad_sim3_pairs(self, b1, b2, pairs):
        """Fixed-shape (sim3_pad) correspondence tensors from slot pairs."""
        Np = self.cfg.sim3_pad
        n = min(len(pairs), Np)
        if len(pairs) > Np:
            print(f"[loop] sim3 correspondence set truncated "
                  f"{len(pairs)} -> {Np} (cfg.sim3_pad)", file=sys.stderr)
        i = np.zeros(Np, np.int64)
        j = np.zeros(Np, np.int64)
        valid = np.zeros(Np, bool)
        i[:n], j[:n] = pairs[:n, 0], pairs[:n, 1]
        valid[:n] = True
        return (b1["xc"][i], b2["xc"][j], b1["uv"][i], b2["uv"][j],
                b1["octave"][i], b2["octave"][j], valid)

    def _search_by_sim3(self, d1, d2, pairs, ransac):
        """SearchBySim3 top-up: grow the correspondence set by two-way
        projection with the RANSAC S12, keeping matches that agree in both
        directions (parity: the match12/match21 mutual check)."""
        m12, m21 = search_by_sim3(self.cam, ransac["R12"], ransac["t12"],
                                  ransac["s12"], d1, d2,
                                  scale_factor=self.cfg.scale_factor)
        m = torch.stack([m12, m21]).cpu().numpy()
        m12, m21 = m[0], m[1]
        i = np.nonzero(m12 >= 0)[0]
        j = m12[i]
        agree = m21[j] == i
        new_pairs = np.stack([i[agree], j[agree]], 1)
        # skip already-matched features on BOTH sides (the reference marks
        # vbAlreadyMatched1/2 from the existing match set)
        used1 = {int(q[0]) for q in pairs}
        used2 = {int(q[1]) for q in pairs}
        fresh = [p for p in new_pairs
                 if int(p[0]) not in used1 and int(p[1]) not in used2]
        if fresh:
            pairs = np.concatenate([pairs, np.asarray(fresh)], 0)
        return pairs

    def _ransac(self, padded):
        cfg = self.cfg
        p1, p2, uv1, uv2, o1, o2, valid = (self._t(a) for a in padded)
        samples = None if self.draw is None else self._t(
            self.draw(padded[-1]))
        return sim3_ransac(self.cam, p1, p2, uv1, uv2, o1, o2, valid,
                           generator=self._gen, fix_scale=cfg.fix_scale,
                           scale_factor=cfg.scale_factor, samples=samples)

    def _compute_sim3(self, kf: int, cand: int, stats=None):
        """Parity: LoopClosing::ComputeSim3 for one candidate. Returns
        dict(R12, t12, s12, n_inliers, n_total) or None."""
        cfg, cam = self.cfg, self.cam
        stats = {} if stats is None else stats
        clock = time.perf_counter
        b1 = self._kf_landmark_bundle(kf)       # current
        b2 = self._kf_landmark_bundle(cand)     # loop candidate
        d1, d2 = self._device_bundle(b1), self._device_bundle(b2)
        t0 = clock()
        idx, _ = matcher.search_brute_force(
            H.signs_from_packed(d1["desc"]), d1["live"],
            H.signs_from_packed(d2["desc"]), d2["live"],
            th=H.TH_LOW, nn_ratio=0.75)
        idx = idx.cpu().numpy()
        stats["t_bf_match_ms"] = (clock() - t0) * 1e3
        rows = np.nonzero(idx >= 0)[0]
        stats["bf_matches"] = len(rows)
        if len(rows) < cfg.min_bow_matches:
            return None
        pairs = np.stack([rows, idx[rows]], 1)
        t0 = clock()
        ransac = self._ransac(self._pad_sim3_pairs(b1, b2, pairs))
        ok, n_ransac = (int(v) for v in torch.stack(
            [ransac["ok"].long(), ransac["n_inliers"].long()]).cpu())
        stats["t_ransac_ms"] = (clock() - t0) * 1e3
        stats["ransac_inliers"] = n_ransac
        if not ok:
            return None
        # SearchBySim3 match top-up between RANSAC and the GN refinement
        t0 = clock()
        pairs = self._search_by_sim3(d1, d2, pairs, ransac)
        stats["t_search_by_sim3_ms"] = (clock() - t0) * 1e3
        stats["pairs"] = len(pairs)
        t0 = clock()
        p1, p2, uv1, uv2, o1, o2, valid = (
            self._t(a) for a in self._pad_sim3_pairs(b1, b2, pairs))
        ref = optimize_sim3(cam, ransac["R12"], ransac["t12"],
                            ransac["s12"], p1, p2, uv1, uv2, o1, o2,
                            valid, fix_scale=cfg.fix_scale,
                            scale_factor=cfg.scale_factor)
        host = torch.cat([ref["R12"].reshape(-1), ref["t12"],
                          ref["s12"].reshape(1),
                          ref["n_inliers"].to(torch.float32).reshape(1)]
                         ).cpu().numpy()
        stats["t_optimize_sim3_ms"] = (clock() - t0) * 1e3
        R12, t12 = host[:9].reshape(3, 3), host[9:12]
        s12, n_inl = float(host[12]), int(host[13])
        stats["sim3_inliers"] = n_inl
        if n_inl < cfg.min_sim3_inliers:
            return None
        sim3 = dict(R12=R12, t12=t12, s12=s12, n_inliers=n_inl)
        # projection top-up: loop-neighborhood landmarks -> current KF
        t0 = clock()
        n_total = self._count_projected_matches(kf, cand, sim3)
        stats["t_topup_ms"] = (clock() - t0) * 1e3
        stats["n_total"] = n_total
        if n_total < cfg.min_total_matches:
            return None
        sim3["n_total"] = n_total
        return sim3

    def _loop_neighborhood_points(self, cand: int):
        s = self.store
        kfs = np.concatenate([[cand], s.covisible_keyframes(cand,
                                                            n_best=10)])
        return s.local_map_points(kfs.astype(np.int64))

    def _count_projected_matches(self, kf: int, cand: int, sim3) -> int:
        """Parity: SearchByProjection(CurrentKF, Scw, loop points, 10)."""
        s, cam, cfg = self.store, self.cam, self.cfg
        with s.lock:
            mp_ids = self._loop_neighborhood_points(cand)
            bundle = s.gather_map_points(mp_ids, pad_to=cfg.max_loop_points)
            # corrected current pose: Scw = S12 · T_cand_w (world ->
            # current), scale folded into the rotation: x_c = s12 R x + t
            R12, t12, s12 = sim3["R12"], sim3["t12"], sim3["s12"]
            Rcw = R12 @ s.kf_R[cand]
            tcw = s12 * (R12 @ s.kf_t[cand]) + t12
            kp = (s.kf_uv[kf].copy(), s.kf_desc[kf].copy(),
                  s.kf_octave[kf].copy(), s.kf_kp_valid[kf].copy())
        idx, _, _ = matcher.search_local_points(
            cam, self._t(np.asarray(s12 * Rcw, np.float32)),
            self._t(np.asarray(tcw, np.float32)), self._t(bundle["pos"]),
            self._t(bundle["desc"]), self._t(bundle["normal"]),
            self._t(bundle["dmin"]), self._t(bundle["dmax"]),
            self._t(bundle["valid"]), *(self._t(a) for a in kp),
            th_radius=10.0, th=H.TH_LOW, nn_ratio=1.0)
        idx = idx.cpu().numpy()
        self._loop_match = (idx, np.asarray(bundle["ids"]))
        return int((idx >= 0).sum())

    # ------------------------------------------------------------------
    def _correct_loop(self, kf: int, cand: int, sim3, stats=None):
        """Parity: LoopClosing::CorrectLoop — propagate the corrected Sim3
        over the current covisible group, fuse, optimize the essential
        graph, run global BA."""
        s, cfg = self.store, self.cfg
        stats = {} if stats is None else stats
        t0 = time.perf_counter()
        group = [kf] + [int(g) for g in s.covisible_keyframes(kf)]
        # corrected Scw for the current KF: S12 · T_cand_w
        R12, t12, s12 = sim3["R12"], sim3["t12"], sim3["s12"]
        with s.lock:
            R_corr = R12 @ s.kf_R[cand]
            t_corr = s12 * (R12 @ s.kf_t[cand]) + t12
            s_corr = s12
            # uncorrected current pose + full pre-correction snapshot (the
            # essential graph's odometry edges measure the pre-correction
            # relatives: the NonCorrectedSim3 map)
            R_cur, t_cur = s.kf_R[kf].copy(), s.kf_t[kf].copy()
            pre_R, pre_t = s.kf_R.copy(), s.kf_t.copy()

            corrected = {}
            for g in group:
                # T_g_cur = T_g_w · T_w_cur
                Rg, tg = s.kf_R[g], s.kf_t[g]
                R_gc = Rg @ R_cur.T
                t_gc = tg - R_gc @ t_cur
                # corrected S_gw = T_g_cur ∘ S_cur_w
                corrected[g] = (R_gc @ R_corr, (R_gc @ t_corr) + t_gc,
                                s_corr)

            # correct landmarks observed by the group: X' = S_new^-1(S_old X)
            moved = set()
            for g in group:
                Rn, tn, sn = corrected[g]
                mps = s.kf_mp[g]
                mps = np.unique(mps[mps >= 0])
                mps = mps[s.mp_valid[mps]]
                fresh = [m for m in mps if m not in moved]
                if not fresh:
                    continue
                fresh = np.asarray(fresh, np.int64)
                moved.update(int(m) for m in fresh)
                X = s.mp_pos[fresh]
                xc = X @ s.kf_R[g].T + s.kf_t[g]        # old (metric) coords
                s.mp_pos[fresh] = ((xc - tn) @ Rn) / sn
            # write corrected keyframe poses (scale folded into translation)
            for g in group:
                Rn, tn, sn = corrected[g]
                s.kf_R[g] = Rn
                s.kf_t[g] = tn / sn
            s.bump()   # poses/landmarks moved -> invalidate device caches

            # fuse loop landmarks into the corrected current KF
            if self._loop_match is not None:
                idx, ids = self._loop_match
                for row in np.nonzero(idx >= 0)[0]:
                    mp_new = int(ids[row])
                    feat = int(idx[row])
                    if mp_new < 0 or not s.mp_valid[mp_new]:
                        continue
                    mp_old = int(s.kf_mp[kf, feat])
                    if mp_old >= 0 and s.mp_valid[mp_old] \
                            and mp_old != mp_new:
                        s.replace_map_point(mp_old, mp_new)
                    elif mp_old < 0:
                        s.add_observation(mp_new, kf, feat)
        self.mapper.search_in_neighbors(kf)

        with s.lock:            # record the loop edge
            s.kf_loop_edges.setdefault(kf, set()).add(cand)
            s.kf_loop_edges.setdefault(cand, set()).add(kf)
            s.update_connections(kf)
        stats["t_correction_ms"] = (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        self._optimize_essential_graph(kf, cand, pre_R, pre_t)
        stats["t_essential_graph_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        if cfg.run_global_ba:
            self._global_ba()
        stats["t_gba_launch_ms"] = (time.perf_counter() - t0) * 1e3
        # refresh landmark derived state
        with s.lock:
            s.update_normal_and_depth(s.map_point_ids())
        self.loops.append(dict(kf=kf, cand=cand, **sim3))

    def _global_ba(self):
        """The full-map BA over the corrected map. Background: abort any
        in-flight one (its snapshot is stale now) and launch a fresh one —
        the mbStopGBA + new thread(RunGlobalBundleAdjustment) hand-off.
        A loop is closed by this process alone, so the BA stays on this
        rank's device even inside a process group: no other rank would
        join its collectives."""
        if self.cfg.background_gba:
            self.gba.abort()
            self.gba.launch()
        else:
            global_bundle_adjustment(self.store, self.cam, distributed=False,
                                     device=self.device)

    # ------------------------------------------------------------------
    def _essential_edges(self, pre_R, pre_t):
        """Spanning tree + loop + strong covisibility edges, padded to a
        power-of-two bucket (first 64): (ei, ej, eR, et, es, evalid)."""
        s, cfg = self.store, self.cfg
        edges = set()
        for i in s.keyframe_ids():
            i = int(i)
            p = int(s.kf_parent[i])
            if p >= 0 and s.kf_valid[p]:
                edges.add((min(i, p), max(i, p)))
            for j in s.kf_loop_edges.get(i, ()):
                if s.kf_valid[j]:
                    edges.add((min(i, int(j)), max(i, int(j))))
            for j in np.nonzero(s.covis[i] >= cfg.covis_edge_min_weight)[0]:
                if s.kf_valid[j]:
                    edges.add((min(i, int(j)), max(i, int(j))))
        edges = sorted(edges)
        E = 64
        while E < len(edges):
            E *= 2
        ei = np.zeros(E, np.int32)
        ej = np.zeros(E, np.int32)
        eR = np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))
        et = np.zeros((E, 3), np.float32)
        es = np.ones(E, np.float32)
        evalid = np.zeros(E, bool)
        for n, (i, j) in enumerate(edges):
            ei[n], ej[n] = i, j
            # odometry edges measure the PRE-correction relative pose;
            # loop edges measure the corrected one (the new constraint)
            is_loop = j in s.kf_loop_edges.get(i, ())
            Ri, ti = (s.kf_R[i], s.kf_t[i]) if is_loop else (pre_R[i],
                                                             pre_t[i])
            Rj, tj = (s.kf_R[j], s.kf_t[j]) if is_loop else (pre_R[j],
                                                             pre_t[j])
            Rji = Rj @ Ri.T
            eR[n], et[n] = Rji, tj - Rji @ ti
            evalid[n] = True
        return ei, ej, eR, et, es, evalid

    def _optimize_essential_graph(self, kf: int, cand: int, pre_R, pre_t):
        """Build the essential graph and run the Sim3 pose-graph GN; then
        correct landmarks through their reference keyframes. pre_R/pre_t:
        the pose snapshot from BEFORE the Sim3 correction."""
        s, cfg = self.store, self.cfg
        K = s.cfg.max_keyframes
        with s.lock:
            R = s.kf_R.astype(np.float32)
            t = s.kf_t.astype(np.float32)
            vert_valid = s.kf_valid.copy()
            edges = self._essential_edges(pre_R, pre_t)
        fixed = np.zeros(K, bool)
        fixed[cand] = True                     # the reference fixes it
        fixed[~vert_valid] = True
        out = optimize_essential_graph(
            self._t(R), self._t(t), torch.ones(K, device=self.device),
            self._t(vert_valid), self._t(fixed), *(self._t(a) for a in edges),
            n_iters=20, fix_scale=cfg.fix_scale)
        host = torch.cat([out["R"].reshape(K, 9), out["t"],
                          out["s"][:, None]], 1).cpu().numpy()
        Rn = lie.project_so3(host[:, :9].reshape(K, 3, 3))
        tn = host[:, 9:12].copy()
        sn = host[:, 12].copy()
        # guard against diverged slots (project_so3 marks them NaN): keep
        # the pre-optimization pose for any non-finite vertex
        bad = ~(np.isfinite(Rn).all((-1, -2)) & np.isfinite(tn).all(-1)
                & np.isfinite(sn) & (np.abs(sn) > 1e-12))
        with s.lock:
            Rn[bad] = s.kf_R[bad]
            tn[bad] = s.kf_t[bad]
            sn[bad] = 1.0
            # landmark correction via the reference KF (first observer):
            # X' = S_new^-1 ( S_old (X) )
            mp_ids = s.map_point_ids()
            ref_kf = s.mp_obs_kf[mp_ids, 0]
            good = ref_kf >= 0
            mp_ids = mp_ids[good]
            ref_kf = ref_kf[good]
            X = s.mp_pos[mp_ids]
            xc = np.einsum("kij,kj->ki", pre_R[ref_kf], X) + pre_t[ref_kf]
            s.mp_pos[mp_ids] = np.einsum(
                "kji,kj->ki", Rn[ref_kf], xc - tn[ref_kf]) \
                / sn[ref_kf][:, None]
            # write keyframe poses (SE3 with scale folded into t)
            ids = s.keyframe_ids()
            s.kf_R[ids] = Rn[ids]
            s.kf_t[ids] = tn[ids] / sn[ids][:, None]
            s.bump()   # poses/landmarks moved -> invalidate device caches
