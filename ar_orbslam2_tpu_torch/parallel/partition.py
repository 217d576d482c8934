"""Covisibility-partitioned map sharding (SURVEY §5.7 — the sequence/
context-parallel analog: "map-block sharding by covisibility locality").

Port of ar_orbslam2_tpu/parallel/partition.py, which is plain numpy: the
same functions on the port's MapStore, equal outputs on equal store
contents. Keyframes are slot ids, as everywhere in the store (a reused
slot's stale observations are cleared when it is taken again).

The distributed Schur BA (dist_ba.py) shards the LANDMARK axis; which
landmark lands on which device determines how much of each device's
Schur contribution touches which cameras. Partitioning landmarks by the
covisibility structure — each shard owns the landmarks anchored to a
contiguous block of the covisibility-ordered keyframe chain — keeps each
device's camera footprint local (its S contribution is block-banded), so
a future sparse/compressed camera reduction exchanges only halo cameras.
With the current DENSE (6C)^2 psum the partition does not change comms
volume, but it fixes the data placement story and is what a compressed
exchange would rely on.
"""
from __future__ import annotations

import numpy as np


def covis_order(store):
    """BFS order over the covisibility graph from the first valid KF
    (falls back to id order for disconnected parts) — neighbors in the
    graph stay adjacent in the order. Returns a list of keyframe ids."""
    s = store
    kf_ids = [int(k) for k in s.keyframe_ids()]
    order = []
    seen = set()
    for root in kf_ids:
        if root in seen:
            continue
        frontier = [root]
        seen.add(root)
        while frontier:
            k = frontier.pop(0)
            order.append(k)
            nbrs = [int(n) for n in s.covisible_keyframes(k)]
            nbrs.sort(key=lambda n: -int(s.covis[k, n]))
            for n in nbrs:
                if n not in seen:
                    seen.add(n)
                    frontier.append(n)
    return order


def keyframe_blocks(store, n_shards: int):
    """Split the covisibility-ordered keyframe chain into n contiguous
    blocks of ~equal landmark-anchor mass.

    Returns block id per keyframe slot, (max_keyframes,) int32 (-1 for
    invalid slots).
    """
    s = store
    if not len(s.keyframe_ids()):
        return np.full(s.cfg.max_keyframes, -1, np.int32)
    order = covis_order(s)
    # anchor mass per KF = landmarks whose FIRST observation is that KF
    first_kf = s.mp_obs_kf[s.mp_valid, 0]
    mass = np.bincount(first_kf[first_kf >= 0],
                       minlength=s.cfg.max_keyframes).astype(np.float64)
    total = max(mass[order].sum(), 1.0)
    per_shard = total / n_shards
    block = np.full(s.cfg.max_keyframes, -1, np.int32)
    acc, b = 0.0, 0
    for k in order:
        block[k] = min(b, n_shards - 1)
        acc += mass[k]
        if acc >= per_shard * (b + 1):
            b += 1
    return block


def partition_landmarks(store, n_shards: int):
    """Assign every live landmark to the shard of its anchor (first
    observer) keyframe's covisibility block.

    Returns (assignment (max_map_points,) int32 with -1 for dead slots,
    counts (n_shards,)). Use with dist_ba by permuting the landmark axis
    so each device's contiguous slice is one shard.
    """
    s = store
    block = keyframe_blocks(s, n_shards)
    assign = np.full(s.cfg.max_map_points, -1, np.int32)
    live = np.nonzero(s.mp_valid)[0]
    anchor = s.mp_obs_kf[live, 0]
    ok = anchor >= 0
    assign[live[ok]] = block[anchor[ok]]
    # landmarks with no anchor: round-robin
    rest = live[~ok]
    if len(rest):
        assign[rest] = np.arange(len(rest)) % n_shards
    counts = np.bincount(assign[assign >= 0], minlength=n_shards)
    return assign, counts


def shard_camera_footprint(store, assign, n_shards: int):
    """For each shard: the set of cameras its landmarks touch (the halo
    a compressed camera-reduction would exchange). Returns a list of
    np arrays of keyframe ids."""
    s = store
    out = []
    for b in range(n_shards):
        mps = np.nonzero(assign == b)[0]
        kfs = s.mp_obs_kf[mps]
        out.append(np.unique(kfs[kfs >= 0]))
    return out


def banded_layout(store, n_shards: int, obs_bucket=None):
    """The layout the BANDED camera exchange needs (dist_ba.py's
    dist_bundle_adjust_banded): cameras permuted to covisibility-BFS
    order so each landmark shard's camera footprint is a contiguous
    band, landmarks grouped per shard (equal padded counts), and per-
    shard band offsets + a common band width W.

    Returns dict:
      kf_order (n_kf,) keyframe ids in BFS order (the camera axis)
      shard_mp (n_shards, P_s) landmark ids per shard, -1 padded
      band_off (n_shards,) int32 — band start in the permuted cam axis
      band_w   int — common band width (bucketed power of two)
    or None if the map is empty.
    """
    s = store
    order = covis_order(s)
    if not order:
        return None
    pos_of = np.full(s.cfg.max_keyframes, -1, np.int64)
    pos_of[order] = np.arange(len(order))
    assign, counts = partition_landmarks(s, n_shards)

    O = s.cfg.max_obs if obs_bucket is None else min(s.cfg.max_obs,
                                                     obs_bucket)
    P_s = _round_up(max(int(counts.max()), 1), 64)
    shard_mp = np.full((n_shards, P_s), -1, np.int64)
    band_lo = np.zeros(n_shards, np.int32)
    extent = 1
    for b in range(n_shards):
        mps = np.nonzero(assign == b)[0]
        shard_mp[b, :len(mps)] = mps
        if len(mps):
            okf = s.mp_obs_kf[mps, :O]
            ps = pos_of[okf[okf >= 0]]
            ps = ps[ps >= 0]
            if len(ps):
                band_lo[b] = int(ps.min())
                extent = max(extent, int(ps.max()) - int(ps.min()) + 1)
    C = len(order)
    W = 16
    while W < extent:
        W *= 2
    W = min(W, C)
    # clamp offsets so every band fits inside [0, C)
    band_off = np.minimum(band_lo, max(C - W, 0)).astype(np.int32)
    return dict(kf_order=np.asarray(order, np.int64), shard_mp=shard_mp,
                band_off=band_off, band_w=int(W))


def _round_up(n, q):
    return ((n + q - 1) // q) * q
