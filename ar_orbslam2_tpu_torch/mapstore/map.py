"""Fixed-capacity structure-of-arrays map.

TPU-native redesign of the reference's pointer-graph map model
(src/Map.cc, src/KeyFrame.cc, src/MapPoint.cc — SURVEY.md §2.1): KeyFrame*
and MapPoint* pointer webs become preallocated index arrays; the
covisibility graph becomes a dense [MAX_KF, MAX_KF] weight matrix; the
spanning tree a parent vector; observations a two-way index table.

Division of labor (SURVEY.md §7 design stance): this container lives on the
HOST in numpy — map bookkeeping is per-keyframe, scalar-ish, and inherently
dynamic — while every hot numeric consumer (matching, BA, triangulation)
receives fixed-shape padded device bundles via the gather_* methods. The
reference's mutex discipline disappears: stages exchange explicit arrays,
single-writer (the pipeline) mutates the store.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops import hamming as H


@dataclass(frozen=True)
class MapConfig:
    max_keyframes: int = 1024
    max_map_points: int = 120_000
    max_kp: int = 1024            # features per keyframe (padded)
    max_obs: int = 48             # observations kept per map point
    covis_threshold: int = 15     # edge weight gate (UpdateConnections)
    scale_factor: float = 1.2     # ORB pyramid scale (PredictScale band)
    n_levels: int = 8


# byte -> popcount lookup (vectorized packed-Hamming on the host)
_POPCNT = np.array([bin(i).count("1") for i in range(256)], np.int32)


def _np_hamming(packed_a, packed_b):
    """(N,32) x (M,32) packed -> (N,M) int32 Hamming (host oracle path)."""
    x = np.bitwise_xor(packed_a[:, None, :], packed_b[None, :, :])
    return _POPCNT[x].sum(-1)


class MapStore:
    """The global map: keyframes, landmarks, covisibility, spanning tree."""

    def __init__(self, cfg: MapConfig = MapConfig()):
        import threading
        self.cfg = cfg
        # coarse map-update lock (parity: Map::mMutexMapUpdate) — held by
        # the async mapping stage around write-backs and by the tracking
        # loop around its chunk-boundary reads; single-threaded use never
        # contends
        self.lock = threading.RLock()
        K, M, P, O = (cfg.max_keyframes, cfg.max_map_points,
                      cfg.max_kp, cfg.max_obs)
        # --- keyframes ---
        self.kf_valid = np.zeros(K, bool)
        self.kf_R = np.zeros((K, 3, 3), np.float32)
        self.kf_t = np.zeros((K, 3), np.float32)
        self.kf_timestamp = np.zeros(K, np.float64)
        self.kf_frame_id = np.full(K, -1, np.int64)   # source frame index
        self.kf_uv = np.zeros((K, P, 2), np.float32)
        self.kf_desc = np.zeros((K, P, H.DESC_BYTES), np.uint8)
        self.kf_octave = np.zeros((K, P), np.int32)
        self.kf_angle = np.zeros((K, P), np.float32)
        self.kf_uvr = np.full((K, P), -1.0, np.float32)   # stereo right-u
        self.kf_depth = np.full((K, P), -1.0, np.float32)  # stereo/RGBD depth
        self.kf_kp_valid = np.zeros((K, P), bool)
        self.kf_mp = np.full((K, P), -1, np.int64)    # feature -> landmark
        # covisibility weight matrix (shared-landmark counts, symmetric)
        self.covis = np.zeros((K, K), np.int32)
        self.kf_parent = np.full(K, -1, np.int64)     # spanning tree
        self.kf_loop_edges: dict[int, set] = {}
        self.next_kf = 0                              # monotonic high-water
        # --- map points ---
        self.mp_valid = np.zeros(M, bool)
        self.mp_pos = np.zeros((M, 3), np.float32)
        self.mp_normal = np.zeros((M, 3), np.float32)
        self.mp_dmin = np.zeros(M, np.float32)
        self.mp_dmax = np.zeros(M, np.float32)
        self.mp_desc = np.zeros((M, H.DESC_BYTES), np.uint8)
        self.mp_obs_kf = np.full((M, O), -1, np.int64)
        self.mp_obs_feat = np.full((M, O), -1, np.int64)
        self.mp_nobs = np.zeros(M, np.int32)
        self.mp_visible = np.zeros(M, np.int32)       # GetFoundRatio counters
        self.mp_found = np.zeros(M, np.int32)
        self.mp_first_kf = np.full(M, -1, np.int64)
        # forwarding pointer set by replace_map_point (parity: the
        # mpReplaced chain behind MapPoint::GetReplaced, consumed by
        # Tracking::CheckReplacedInLastFrame)
        self.mp_replaced = np.full(M, -1, np.int64)
        self.mp_free = list(range(M - 1, -1, -1))     # free-list (stack)
        # structural mutation counter: bumped whenever landmark positions,
        # descriptors, observation topology, or keyframe poses change, so
        # downstream device-bundle caches (tracking's local-map gather) know
        # when to rebuild. Counter updates (mp_visible/mp_found) don't bump.
        self.version = 0

    def bump(self):
        self.version += 1

    # ------------------------------------------------------------------
    # keyframe lifecycle
    # ------------------------------------------------------------------
    def add_keyframe(self, R, t, uv, desc_packed, octave, kp_valid,
                     timestamp=0.0, frame_id=-1, angle=None, uvr=None,
                     depth=None) -> int:
        """Insert a keyframe; returns its id. Arrays padded to max_kp."""
        if self.next_kf >= self.cfg.max_keyframes:
            raise RuntimeError("MapStore keyframe capacity exhausted")
        k = self.next_kf
        self.next_kf += 1
        self.kf_valid[k] = True
        self.kf_R[k] = R
        self.kf_t[k] = t
        self.kf_timestamp[k] = timestamp
        self.kf_frame_id[k] = frame_id
        n = min(len(uv), self.cfg.max_kp)
        self.kf_uv[k, :n] = uv[:n]
        self.kf_desc[k, :n] = desc_packed[:n]
        self.kf_octave[k, :n] = octave[:n]
        self.kf_kp_valid[k, :n] = kp_valid[:n]
        if angle is not None:
            self.kf_angle[k, :n] = angle[:n]
        if uvr is not None:
            self.kf_uvr[k, :n] = uvr[:n]
        if depth is not None:
            self.kf_depth[k, :n] = depth[:n]
        self.kf_mp[k] = -1
        self.bump()
        return k

    def n_keyframes(self):
        return int(self.kf_valid.sum())

    def n_map_points(self):
        return int(self.mp_valid.sum())

    def keyframe_ids(self):
        return np.nonzero(self.kf_valid)[0]

    def map_point_ids(self):
        return np.nonzero(self.mp_valid)[0]

    # ------------------------------------------------------------------
    # map point lifecycle
    # ------------------------------------------------------------------
    def add_map_points(self, pos, desc_packed, first_kf=-1):
        """Allocate a batch of landmarks; returns their ids (np.int64)."""
        n = len(pos)
        if len(self.mp_free) < n:
            raise RuntimeError("MapStore map-point capacity exhausted")
        ids = np.array([self.mp_free.pop() for _ in range(n)], np.int64)
        self.mp_valid[ids] = True
        self.mp_pos[ids] = pos
        self.mp_desc[ids] = desc_packed
        self.mp_normal[ids] = 0.0
        self.mp_dmin[ids] = 0.0
        self.mp_dmax[ids] = 0.0
        self.mp_nobs[ids] = 0
        self.mp_visible[ids] = 1
        self.mp_found[ids] = 1
        self.mp_first_kf[ids] = first_kf
        self.mp_obs_kf[ids] = -1
        self.mp_obs_feat[ids] = -1
        self.mp_replaced[ids] = -1        # recycled slot: clear forwarding
        self.bump()
        return ids

    def add_observation(self, mp, kf, feat):
        """Bind landmark <-> (keyframe, feature). Parity:
        MapPoint::AddObservation + KeyFrame::AddMapPoint."""
        if self.kf_mp[kf, feat] == mp:
            return
        slot = self.mp_nobs[mp]
        if slot >= self.cfg.max_obs:
            return
        self.mp_obs_kf[mp, slot] = kf
        self.mp_obs_feat[mp, slot] = feat
        self.mp_nobs[mp] += 1
        self.kf_mp[kf, feat] = mp
        self.bump()

    def add_observations(self, mps, kf, feats):
        """Batched add_observation for one keyframe (vectorized scatter —
        duplicate mp ids within the batch get consecutive slots)."""
        mps = np.asarray(mps, np.int64).ravel()
        feats = np.asarray(feats, np.int64).ravel()
        if len(mps) == 0:
            return
        keep = self.kf_mp[kf, feats] != mps       # skip already-bound pairs
        mps, feats = mps[keep], feats[keep]
        if len(mps) == 0:
            return
        order = np.argsort(mps, kind="stable")
        ms, fs = mps[order], feats[order]
        first = np.r_[True, ms[1:] != ms[:-1]]
        start = np.nonzero(first)[0]
        cum = np.arange(len(ms)) - start[np.cumsum(first) - 1]
        slot = self.mp_nobs[ms] + cum
        ok = slot < self.cfg.max_obs
        ms, fs, slot = ms[ok], fs[ok], slot[ok]
        self.mp_obs_kf[ms, slot] = kf
        self.mp_obs_feat[ms, slot] = fs
        np.add.at(self.mp_nobs, ms, 1)
        self.kf_mp[kf, fs] = ms
        self.bump()

    def erase_observation(self, mp, kf):
        """Remove a landmark's binding to a keyframe (EraseObservation)."""
        obs = self.mp_obs_kf[mp, :self.mp_nobs[mp]]
        hit = np.nonzero(obs == kf)[0]
        if len(hit) == 0:
            return
        i = hit[0]
        feat = self.mp_obs_feat[mp, i]
        last = self.mp_nobs[mp] - 1
        self.mp_obs_kf[mp, i] = self.mp_obs_kf[mp, last]
        self.mp_obs_feat[mp, i] = self.mp_obs_feat[mp, last]
        self.mp_obs_kf[mp, last] = -1
        self.mp_obs_feat[mp, last] = -1
        self.mp_nobs[mp] = last
        if self.kf_mp[kf, feat] == mp:
            self.kf_mp[kf, feat] = -1
        self.bump()
        # landmarks need >= 2 observers to exist (SetBadFlag on <=2)
        if last <= 1:
            self.erase_map_point(mp)

    def erase_map_point(self, mp):
        """MapPoint::SetBadFlag parity: unbind everywhere, free the slot."""
        if not self.mp_valid[mp]:
            return
        for i in range(self.mp_nobs[mp]):
            kf = self.mp_obs_kf[mp, i]
            feat = self.mp_obs_feat[mp, i]
            if kf >= 0 and self.kf_mp[kf, feat] == mp:
                self.kf_mp[kf, feat] = -1
        self.mp_obs_kf[mp] = -1
        self.mp_obs_feat[mp] = -1
        self.mp_nobs[mp] = 0
        self.mp_valid[mp] = False
        self.mp_free.append(int(mp))
        self.bump()

    def replace_map_point(self, old, new):
        """MapPoint::Replace parity — merge old into new (fusion)."""
        if old == new or not self.mp_valid[old]:
            return
        obs_kf = self.mp_obs_kf[old, :self.mp_nobs[old]].copy()
        obs_ft = self.mp_obs_feat[old, :self.mp_nobs[old]].copy()
        self.mp_replaced[old] = new
        self.mp_found[new] += self.mp_found[old]
        self.mp_visible[new] += self.mp_visible[old]
        # free old first so add_observation sees a clean slate
        self.mp_obs_kf[old] = -1
        self.mp_obs_feat[old] = -1
        self.mp_nobs[old] = 0
        self.mp_valid[old] = False
        self.mp_free.append(int(old))
        for kf, ft in zip(obs_kf, obs_ft):
            if kf < 0:
                continue
            # if new already observed in kf keep its binding, just clear
            if new in self.kf_mp[kf]:
                if self.kf_mp[kf, ft] == old:
                    self.kf_mp[kf, ft] = -1
            else:
                self.kf_mp[kf, ft] = new
                slot = self.mp_nobs[new]
                if slot < self.cfg.max_obs:
                    self.mp_obs_kf[new, slot] = kf
                    self.mp_obs_feat[new, slot] = ft
                    self.mp_nobs[new] += 1
        self.bump()

    # ------------------------------------------------------------------
    # derived landmark state
    # ------------------------------------------------------------------
    def compute_distinctive_descriptors(self, mp_ids):
        """Min-median-Hamming representative descriptor per landmark.
        Parity: MapPoint::ComputeDistinctiveDescriptors
        (src/MapPoint.cc:≈200). Vectorized over the whole batch: one
        packed-XOR popcount pass instead of a Python loop per landmark;
        chunked so the (B, O, O, 32) XOR tensor stays small."""
        from ..native import mapgraph as _native

        mp_ids = np.atleast_1d(np.asarray(mp_ids, np.int64))
        if len(mp_ids) == 0:
            return
        n_all = self.mp_nobs[mp_ids]
        mp_ids = mp_ids[n_all > 0]
        if len(mp_ids) == 0:
            return
        if _native.available():
            _native.distinctive_descriptors(self, mp_ids)
        else:
            self._compute_distinctive_descriptors_np(mp_ids)
        self.bump()

    def _compute_distinctive_descriptors_np(self, mp_ids):
        """numpy oracle path (bit-identical to the native kernel)."""
        O = self.cfg.max_obs
        slot = np.arange(O)
        BIG = np.int32(1 << 20)
        for lo in range(0, len(mp_ids), 256):
            ids = mp_ids[lo:lo + 256]
            n = self.mp_nobs[ids]                          # (B,)
            kfs = np.maximum(self.mp_obs_kf[ids], 0)       # (B, O)
            fts = np.maximum(self.mp_obs_feat[ids], 0)
            descs = self.kf_desc[kfs, fts]                 # (B, O, 32)
            x = np.bitwise_xor(descs[:, :, None, :], descs[:, None, :, :])
            D = _POPCNT[x].sum(-1, dtype=np.int32)         # (B, O, O)
            ok = slot[None, :] < n[:, None]                # (B, O)
            D = np.where(ok[:, :, None] & ok[:, None, :], D, BIG)
            Ds = np.sort(D, axis=-1)
            b = np.arange(len(ids))
            # doubled median of the n valid distances per observation row
            med2 = (Ds[b[:, None], slot[None, :], ((n - 1) // 2)[:, None]]
                    + Ds[b[:, None], slot[None, :], (n // 2)[:, None]])
            med2 = np.where(ok, med2, 4 * BIG)
            best = np.argmin(med2, axis=1)
            self.mp_desc[ids] = descs[b, best]

    def update_normal_and_depth(self, mp_ids):
        """Mean viewing direction + scale-band distances.
        Parity: MapPoint::UpdateNormalAndDepth (src/MapPoint.cc:≈330).
        Vectorized over the whole batch (no per-landmark Python loop)."""
        from ..native import mapgraph as _native

        mp_ids = np.atleast_1d(np.asarray(mp_ids, np.int64))
        if len(mp_ids) == 0:
            return
        n = self.mp_nobs[mp_ids]
        mp_ids = mp_ids[n > 0]
        if len(mp_ids) == 0:
            return
        if _native.available():
            _native.update_normal_and_depth(self, mp_ids)
        else:
            self._update_normal_and_depth_np(mp_ids)
        self.bump()

    def _update_normal_and_depth_np(self, mp_ids):
        """numpy oracle path (matches the native kernel)."""
        n = self.mp_nobs[mp_ids]
        O = self.cfg.max_obs
        kfs = np.maximum(self.mp_obs_kf[mp_ids], 0)        # (B, O)
        ok = np.arange(O)[None, :] < n[:, None]
        R = self.kf_R[kfs]                                 # (B, O, 3, 3)
        t = self.kf_t[kfs]                                 # (B, O, 3)
        centers = -np.einsum("boij,boi->boj", R, t)        # -R^T t
        d = self.mp_pos[mp_ids][:, None, :] - centers      # (B, O, 3)
        norms = np.linalg.norm(d, axis=-1)                 # (B, O)
        dirs = d / np.maximum(norms, 1e-9)[..., None]
        normal = np.where(ok[..., None], dirs, 0.0).sum(1) / n[:, None]
        nn = np.maximum(np.linalg.norm(normal, axis=-1, keepdims=True), 1e-9)
        self.mp_normal[mp_ids] = (normal / nn).astype(np.float32)
        # scale band anchored at the reference (first) observation
        ref_kf = self.mp_obs_kf[mp_ids, 0]
        ref_ft = self.mp_obs_feat[mp_ids, 0]
        lvl = self.kf_octave[ref_kf, ref_ft]
        sf = self.cfg.scale_factor
        dmax = norms[:, 0] * sf ** lvl
        self.mp_dmax[mp_ids] = dmax.astype(np.float32)
        self.mp_dmin[mp_ids] = (dmax / sf ** (self.cfg.n_levels - 1)
                                ).astype(np.float32)

    # ------------------------------------------------------------------
    # covisibility graph + spanning tree
    # ------------------------------------------------------------------
    def update_connections(self, kf):
        """Recount shared landmarks between kf and all other keyframes,
        refresh the covisibility row/col and spanning-tree parent.
        Parity: KeyFrame::UpdateConnections (src/KeyFrame.cc:≈330)."""
        from ..native import mapgraph as _native

        if _native.available():
            _native.update_connections(self, int(kf))
            return
        self._update_connections_np(kf)

    def _update_connections_np(self, kf):
        """numpy oracle path (matches the native kernel)."""
        mps = self.kf_mp[kf]
        mps = mps[mps >= 0]
        counts = np.zeros(self.cfg.max_keyframes, np.int32)
        if len(mps):
            obs_kf = self.mp_obs_kf[mps]           # (n, O)
            flat = obs_kf[obs_kf >= 0]
            if len(flat):
                counts = np.bincount(flat, minlength=self.cfg.max_keyframes
                                     ).astype(np.int32)
        counts[kf] = 0
        th = self.cfg.covis_threshold
        keep = counts >= th
        if not keep.any() and counts.max() > 0:
            keep = counts == counts.max()          # keep the single best
        row = np.where(keep, counts, 0)
        self.covis[kf, :] = row
        self.covis[:, kf] = row
        # spanning tree: first connection -> parent = most covisible
        if self.kf_parent[kf] < 0 and kf != 0 and row.max() > 0:
            self.kf_parent[kf] = int(np.argmax(row))

    def covisible_keyframes(self, kf, n_best=None, min_weight=1):
        w = self.covis[kf]
        ids = np.nonzero((w >= min_weight) & self.kf_valid)[0]
        ids = ids[np.argsort(-w[ids], kind="stable")]
        return ids if n_best is None else ids[:n_best]

    def erase_keyframe(self, kf):
        """KeyFrame::SetBadFlag parity: detach observations, reconnect
        spanning-tree children to the best covisible ancestor."""
        if kf == 0 or not self.kf_valid[kf]:
            return
        for feat in np.nonzero(self.kf_mp[kf] >= 0)[0]:
            self.erase_observation(int(self.kf_mp[kf, feat]), kf)
        self.covis[kf, :] = 0
        self.covis[:, kf] = 0
        parent = self.kf_parent[kf]
        children = np.nonzero(self.kf_parent == kf)[0]
        for c in children:
            # candidate parents: covisible KFs of the child that are valid
            w = self.covis[c].copy()
            w[c] = 0
            cand = int(np.argmax(w)) if w.max() > 0 else int(parent)
            self.kf_parent[c] = cand
        self.kf_valid[kf] = False
        self.kf_kp_valid[kf] = False

    # ------------------------------------------------------------------
    # queries for the pipeline (fixed-shape device bundles)
    # ------------------------------------------------------------------
    def local_map_points(self, kf_ids):
        """Union of landmarks observed by the given keyframes."""
        mps = self.kf_mp[kf_ids]
        mps = np.unique(mps[mps >= 0])
        return mps[self.mp_valid[mps]]

    def gather_map_points(self, mp_ids, pad_to):
        """Fixed-shape landmark bundle for device matching kernels."""
        n = min(len(mp_ids), pad_to)
        ids = np.full(pad_to, -1, np.int64)
        ids[:n] = mp_ids[:n]
        sel = np.maximum(ids, 0)
        return dict(
            ids=ids,
            pos=self.mp_pos[sel],
            desc=self.mp_desc[sel],
            normal=self.mp_normal[sel],
            dmin=self.mp_dmin[sel],
            dmax=self.mp_dmax[sel],
            valid=(ids >= 0),
        )

    def resolve_replacements(self, mp):
        """Follow replace_map_point forwarding chains (parity:
        MapPoint::GetReplaced as used by CheckReplacedInLastFrame).
        mp: (N,) int64 landmark ids (-1 allowed). Returns resolved ids
        with dead, unforwarded landmarks mapped to -1."""
        out = np.asarray(mp, np.int64).copy()
        for _ in range(8):                     # chains are short
            sel = out >= 0
            nxt = np.where(sel, self.mp_replaced[np.maximum(out, 0)], -1)
            step = nxt >= 0
            if not step.any():
                break
            out = np.where(step, nxt, out)
        live = (out >= 0) & self.mp_valid[np.maximum(out, 0)]
        return np.where(live, out, -1)

    def median_scene_depth(self, kf):
        """Median depth of landmarks seen by kf (mono init scale norm).
        Parity: KeyFrame::ComputeSceneMedianDepth."""
        mps = self.kf_mp[kf]
        mps = mps[mps >= 0]
        if len(mps) == 0:
            return 1.0
        pos = self.mp_pos[mps]
        z = pos @ self.kf_R[kf][2] + self.kf_t[kf][2]
        return float(np.median(z))
