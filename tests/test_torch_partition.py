"""The port's covisibility partition (parallel/partition.py) and
gather_global_partitioned (mapping/global_ba.py) against the JAX
package's, on the CPU.

One map is built in the port's MapStore — a chain of 32 stereo keyframes
(bf 50: the scale is observed, so the BA has one optimum) along a line,
each landmark seen by up to six consecutive keyframes, one
keyframe erased and its slot reused by a new one at the chain's end (the
port's keyframe-slot reuse, which the JAX store cannot do) — and copied
array for array into a JAX MapStore (as tests/test_torch_fused.py does).
Every output must be exactly equal: the module is numpy on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ar_orbslam2_tpu.core import lie as JL
from ar_orbslam2_tpu.mapping import global_ba as JGBA
from ar_orbslam2_tpu.mapstore.map import MapConfig as JMapConfig
from ar_orbslam2_tpu.mapstore.map import MapStore as JMapStore
from ar_orbslam2_tpu.parallel import partition as JP
from ar_orbslam2_tpu_torch.mapping import global_ba as TGBA
from ar_orbslam2_tpu_torch.mapstore.checkpoint import _ARRAYS
from ar_orbslam2_tpu_torch.mapstore.map import MapConfig, MapStore
from ar_orbslam2_tpu_torch.parallel import partition as TP


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The port's steps are chains of tiny ops: more intra-op threads buy
    nothing and fight the other test workers for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


CAM_KW = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0, width=640,
              height=480)
MAP = dict(max_keyframes=32, max_map_points=1024, max_kp=128, max_obs=8)
N_KF, PER_KF, SPAN = 32, 16, 6
STEP = 0.2                      # metres between keyframes


def _view(R, t, pts, ids, rng):
    """Keyframe arrays for the landmarks `ids` seen from (R, t), with
    their right-image u."""
    xc = pts[ids] @ R.T + t
    uv = np.zeros((MAP["max_kp"], 2), np.float32)
    uv[:len(ids)] = np.stack([500 * xc[:, 0] / xc[:, 2] + 320,
                              500 * xc[:, 1] / xc[:, 2] + 240], -1)
    uv[:len(ids)] += rng.normal(0, 0.5, (len(ids), 2))
    uvr = np.full(MAP["max_kp"], -1.0, np.float32)
    uvr[:len(ids)] = uv[:len(ids), 0] - CAM_KW["bf"] / xc[:, 2]
    valid = np.zeros(MAP["max_kp"], bool)
    valid[:len(ids)] = True
    desc = rng.integers(0, 256, (MAP["max_kp"], 32)).astype(np.uint8)
    return uv, desc, np.zeros(MAP["max_kp"], np.int32), valid, uvr


def _port_chain_map(seed=0):
    """The chain map in the port's store; returns (store, true landmark
    positions)."""
    rng = np.random.default_rng(seed)
    s = MapStore(MapConfig(**MAP))
    n_pts = N_KF * PER_KF
    anchor = np.arange(n_pts) // PER_KF
    gt = np.c_[rng.uniform(-1.0, 1.0, n_pts) + STEP * anchor,
               rng.uniform(-1.5, 1.5, n_pts),
               rng.uniform(3.0, 6.0, n_pts)].astype(np.float32)
    noisy = gt + rng.normal(0, 0.01, gt.shape).astype(np.float32)
    ids = s.add_map_points(noisy, rng.integers(0, 256, (n_pts, 32)).astype(
        np.uint8), first_kf=0)

    def pose(i):
        R = np.asarray(JL.so3_exp(jnp.asarray(
            np.array([0.0, 0.02 * np.sin(i), 0.0], np.float32))))
        return R, np.array([-STEP * i, 0.0, 0.0], np.float32)

    def add(i, seen):
        R, t = pose(i)
        uv, desc, octv, valid, uvr = _view(R, t, gt, seen, rng)
        t_noisy = t + (rng.normal(0, 0.003, 3).astype(np.float32)
                       if i else 0.0)
        k = s.add_keyframe(R, t_noisy, uv, desc, octv, valid, frame_id=i,
                           uvr=uvr)
        s.add_observations(ids[seen], k, np.arange(len(seen)))
        s.update_connections(k)
        return k

    for i in range(N_KF):
        add(i, np.nonzero((anchor <= i) & (anchor > i - SPAN))[0])
    s.erase_keyframe(19)
    k = add(N_KF, np.nonzero(anchor >= N_KF - SPAN + 1)[0])
    assert k == 19 and s.kf_seq[k] == N_KF and s.n_kf_reused == 1
    return s, gt


def _jax_copy(ts):
    js = JMapStore(JMapConfig(**MAP))
    for name in _ARRAYS:
        getattr(js, name)[...] = getattr(ts, name)
    js.next_kf = ts.next_kf
    js.mp_replaced[...] = ts.mp_replaced
    js.mp_free = list(ts.mp_free)
    js.bump()
    return js


def chain_maps(seed=0):
    """((JAX store, port store) with equal contents, true landmarks)."""
    ts, gt = _port_chain_map(seed)
    return (_jax_copy(ts), ts), gt


@pytest.fixture(scope="module")
def maps():
    return chain_maps()[0]


def test_covis_order_and_blocks_equal(maps):
    js, ts = maps
    assert TP.covis_order(ts) == JP.covis_order(js)
    assert len(TP.covis_order(ts)) == N_KF
    for n in (1, 2, 4, 8):
        np.testing.assert_array_equal(TP.keyframe_blocks(ts, n),
                                      JP.keyframe_blocks(js, n))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_partition_footprint_and_banded_layout_equal(maps, n):
    js, ts = maps
    a_t, c_t = TP.partition_landmarks(ts, n)
    a_j, c_j = JP.partition_landmarks(js, n)
    np.testing.assert_array_equal(a_t, a_j)
    np.testing.assert_array_equal(c_t, c_j)
    assert c_t.sum() == ts.mp_valid.sum()
    for f_t, f_j in zip(TP.shard_camera_footprint(ts, a_t, n),
                        JP.shard_camera_footprint(js, a_j, n)):
        np.testing.assert_array_equal(f_t, f_j)
    l_t, l_j = TP.banded_layout(ts, n), JP.banded_layout(js, n)
    assert l_t.keys() == l_j.keys()
    for k in l_t:
        np.testing.assert_array_equal(l_t[k], l_j[k], err_msg=k)
    assert TP._round_up(65, 64) == JP._round_up(65, 64) == 128


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_gather_global_partitioned_equal(maps, n):
    js, ts = maps
    g_t = TGBA.gather_global_partitioned(ts, n)
    g_j = JGBA.gather_global_partitioned(js, n)
    assert g_t.keys() == g_j.keys()
    for k in g_t:
        np.testing.assert_array_equal(g_t[k], g_j[k], err_msg=k)


def test_banded_layout_covers_all_observations(maps):
    """Every live landmark's observations land inside its shard's camera
    band — the invariant the banded exchange rests on (an observation
    outside the band would be silently dropped) — and the bands are
    narrower than the chain, on the port's store with a reused slot."""
    _, ts = maps
    for n in (2, 4, 8):
        lay = TP.banded_layout(ts, n)
        pos_of = np.full(ts.cfg.max_keyframes, -1, np.int64)
        pos_of[lay["kf_order"]] = np.arange(len(lay["kf_order"]))
        W = lay["band_w"]
        for b in range(n):
            mps = lay["shard_mp"][b]
            mps = mps[mps >= 0]
            okf = ts.mp_obs_kf[mps]
            ps = pos_of[okf[okf >= 0]]
            assert (ps >= 0).all()
            off = lay["band_off"][b]
            assert (ps >= off).all() and (ps < off + W).all(), \
                f"{n} shards, shard {b}: obs outside [{off}, {off + W})"
        g = TGBA.gather_global_partitioned(ts, n)
        n_obs = (ts.mp_obs_kf[ts.mp_valid] >= 0).sum()
        assert g["obs_valid"].sum() == n_obs
    assert TP.banded_layout(ts, 4)["band_w"] < N_KF


def test_empty_map_has_no_layout():
    s = MapStore(MapConfig(**MAP))
    assert TP.covis_order(s) == []
    assert TP.banded_layout(s, 2) is None
    assert TGBA.gather_global_partitioned(s, 2) is None
    np.testing.assert_array_equal(TP.keyframe_blocks(s, 2),
                                  np.full(MAP["max_keyframes"], -1))


def test_stereo_loop_map_is_banded_and_well_posed():
    """synthetic.stereo_loop_map, chip_smoke.py phase 12's map with 16
    landmarks a keyframe in place of 160: a closed ring of covisibility whose 2-shard band is
    narrower than the map and keeps every observation, observations in
    the image with their right-image u, and a global BA that lowers the
    cost from the perturbed start."""
    from ar_orbslam2_tpu_torch.core.camera import Camera
    from ar_orbslam2_tpu_torch.data import synthetic as tsyn
    cam = Camera(**CAM_KW)
    n_kf = 100
    s, gt = tsyn.stereo_loop_map(
        cam, MapConfig(**dict(MAP, max_keyframes=128, max_map_points=2048)),
        n_kf=n_kf, per_kf=PER_KF, span=SPAN)
    assert s.n_keyframes() == n_kf and s.n_map_points() == len(gt)
    assert (s.mp_obs_kf[s.mp_valid] >= 0).sum(1).tolist() == \
        [SPAN] * len(gt)
    assert n_kf - 1 in s.covisible_keyframes(0)         # the loop closed
    lay = TP.banded_layout(s, 2)
    assert lay["band_w"] < n_kf
    g = TGBA.gather_global_partitioned(s, 2)
    assert g["obs_valid"].sum() == SPAN * len(gt)
    uv, uvr = s.kf_uv[s.kf_valid], s.kf_uvr[s.kf_valid]
    live = s.kf_kp_valid[s.kf_valid]
    assert (uv[live] >= 0).all() and (uv[live, 0] < 640).all() \
        and (uv[live, 1] < 480).all()
    depth = CAM_KW["bf"] / (uv[live, 0] - uvr[live])
    assert (depth > 1.0).all() and (depth < 10.0).all()
    cost0 = float(TGBA.dispatch_global_ba(
        TGBA.gather_global(s), cam, n_iters=0, device="cpu")["cost"])
    cost = TGBA.global_bundle_adjustment(s, cam, device="cpu")
    assert cost < 0.5 * cost0
