"""Keyframe slots are reused in the port (a repair of the JAX package).

The JAX package's MapStore raises once ``max_keyframes`` keyframes have
ever been created, culled ones included: erase_keyframe never gives a slot
back. The port puts an erased keyframe's slot on a free list and takes it
again once ``next_kf`` has reached capacity (mapstore/map.py). These tests
run both packages on the same input with a small capacity: an RGB-D
feature camera sweeping back and forth over tests/test_slam_stereo_e2e.py's
orbit scene (the back-and-forth makes keyframes redundant, so culling
frees slots; the redundancy gate of KeyFrameCulling is 0.6 here, in both
packages, so that it happens within a few dozen frames), and hold:
  * the JAX package raises its RuntimeError, the port goes on past
    capacity, reusing slots, at metric accuracy;
  * keyframe ids, and the keyframes erased, are the JAX package's until
    the first reuse;
  * a frame anchored to a keyframe whose slot was reused exports the pose
    it had before the reuse (within 1e-5);
  * a background global BA gathered before a reuse, a queued keyframe,
    the fused bundle refresh's re-anchoring and the place-recognition row
    of the slot do not reach the new keyframe;
  * the slot state goes through a map checkpoint.
"""
import threading
import types

import numpy as np
import pytest
import torch

from ar_orbslam2_tpu.core.camera import Camera as JCamera
from ar_orbslam2_tpu.data import synthetic
from ar_orbslam2_tpu.mapping.local_mapping import (
    LocalMapperConfig as JMapperConfig)
from ar_orbslam2_tpu.mapstore.map import MapConfig as JMapConfig
from ar_orbslam2_tpu.system.slam import SlamConfig as JSlamConfig
from ar_orbslam2_tpu.system.slam import SlamSystem as JSlamSystem
from ar_orbslam2_tpu.system.tracking import TrackingConfig as JTrackingConfig
from ar_orbslam2_tpu_torch.core.camera import Camera
from ar_orbslam2_tpu_torch.eval.ate import ate_rmse
from ar_orbslam2_tpu_torch.loop.place_recognition import KeyFrameDatabase
from ar_orbslam2_tpu_torch.mapping.async_mapper import AsyncMapper
from ar_orbslam2_tpu_torch.mapping.background_gba import BackgroundGBA
from ar_orbslam2_tpu_torch.mapping.local_mapping import LocalMapperConfig
from ar_orbslam2_tpu_torch.mapstore.checkpoint import load_map, save_map
from ar_orbslam2_tpu_torch.mapstore.map import MapConfig, MapStore
from ar_orbslam2_tpu_torch.system.fused import FusedFrontend
from ar_orbslam2_tpu_torch.system.slam import SlamConfig, SlamSystem
from ar_orbslam2_tpu_torch.system.tracking import TrackingConfig

KW = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=40.0)
CAPACITY = 8
N_FRAMES = 40
SIZES = dict(map=dict(max_keyframes=CAPACITY, max_map_points=20_000,
                      max_kp=512),
             tracking=dict(max_kp=512, n_local_mp=2048,
                           max_frames_between_kf=5),
             mapper=dict(ba_max_points=2048, n_triangulation_neighbors=5,
                         n_fuse_neighbors=5, kf_cull_redundancy=0.6))


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The port's stages are chains of small ops: more intra-op threads buy
    nothing and fight the other test workers for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(jax):
    M, T, L, S = ((JMapConfig, JTrackingConfig, JMapperConfig, JSlamConfig)
                  if jax else (MapConfig, TrackingConfig, LocalMapperConfig,
                               SlamConfig))
    return S(sensor="RGBD", map=M(**SIZES["map"]),
             tracking=T(**SIZES["tracking"]), mapper=L(**SIZES["mapper"]),
             enable_loop_closing=False, enable_relocalization=False)


def _sweep_scene(leg=30):
    """The orbit scene swept back and forth over a 3-radian arc."""
    base = synthetic.make_scene(n_landmarks=1500, n_frames=leg, seed=5,
                                trajectory="orbit", arc=3.0)
    back = np.arange(leg - 2, 0, -1)
    idx = np.concatenate([np.arange(leg), back, np.arange(leg)])[:N_FRAMES]
    return synthetic.SyntheticScene(base.landmarks, base.desc_bits,
                                    base.R_cw[idx], base.t_cw[idx],
                                    np.arange(len(idx)) / 30.0)


def _frame(scene, i):
    obs = synthetic.observe_frame(scene, i, JCamera(**KW), max_kp=512,
                                  noise_px=0.3, bit_flip=0.02)
    return dict(features=dict(uv=obs["uv"], desc=obs["desc"],
                              octave=obs["octave"], valid=obs["valid"]),
                kp_depth=obs["depth"], timestamp=scene.timestamps[i])


def _watch_ids(slam, ids):
    add = slam.store.add_keyframe

    def watched(*a, **kw):
        k = add(*a, **kw)
        ids.append(int(k))
        return k
    slam.store.add_keyframe = watched


@pytest.fixture(scope="module")
def jax_run():
    scene = _sweep_scene()
    slam = JSlamSystem(JCamera(**KW), _cfg(True))
    ids, raised = [], None
    _watch_ids(slam, ids)
    for i in range(scene.n_frames):
        try:
            slam.track_rgbd(**_frame(scene, i))
        except RuntimeError as e:
            raised = (i, str(e), slam.store.kf_valid.copy())
            break
    return dict(ids=ids, raised=raised)


@pytest.fixture(scope="module")
def port_run():
    """The port on the whole sweep; around each slot reuse the exported
    frame trajectory just before and just after the new keyframe takes
    the slot (nothing else moves in between)."""
    scene = _sweep_scene()
    slam = SlamSystem(Camera(**KW), _cfg(False), device="cpu")
    s = slam.store
    ids, reuses = [], []
    add = s.add_keyframe

    def watched(*a, **kw):
        reuse = s.next_kf >= s.cfg.max_keyframes
        if reuse:
            slot = s.kf_free[0]
            before = slam.frame_trajectory()
            dict_before = dict(slot=slot, seq=int(s.kf_seq[slot]),
                               valid=s.kf_valid.copy(), before=before)
        k = add(*a, **kw)
        ids.append(int(k))
        if reuse:
            dict_before.update(after=slam.frame_trajectory(),
                               anchored=sum(
                                   1 for r in slam.tracking.metrics
                                   if r.get("ref_kf") == k
                                   and r.get("ref_seq") == dict_before["seq"]
                                   and r["ok"]))
            reuses.append(dict_before)
        return k
    s.add_keyframe = watched
    poses = [slam.track_rgbd(**_frame(scene, i))
             for i in range(scene.n_frames)]
    return dict(scene=scene, slam=slam, ids=ids, reuses=reuses, poses=poses)


def test_port_goes_past_capacity_where_jax_raises(jax_run, port_run):
    assert jax_run["raised"] is not None, "the JAX package did not raise"
    assert "capacity exhausted" in jax_run["raised"][1]
    slam, s = port_run["slam"], port_run["slam"].store
    assert s.n_kf_created > CAPACITY and s.n_kf_reused >= 1
    assert len(port_run["reuses"]) == s.n_kf_reused
    assert all(p is not None for p in port_run["poses"])
    scene = port_run["scene"]
    est = np.array([-(p[:3, :3].T @ p[:3, 3]) for p in port_run["poses"]])
    gt = -(np.swapaxes(scene.R_cw, -1, -2) @ scene.t_cw[..., None])[..., 0]
    assert ate_rmse(est, gt, with_scale=False) < 0.05
    # the keyframe trajectory is in creation order, one row per live one
    ts, _, _ = slam.keyframe_trajectory()
    assert len(ts) == s.n_keyframes() and np.all(np.diff(ts) > 0)


def test_keyframe_ids_match_jax_until_the_first_reuse(jax_run, port_run):
    """The JAX package created CAPACITY keyframes, then raised at the next
    one; the port created the same ids and erased the same keyframes by
    then, and its creation numbers are those ids."""
    assert jax_run["ids"] == list(range(CAPACITY))
    assert port_run["ids"][:CAPACITY] == jax_run["ids"]
    first = port_run["reuses"][0]
    np.testing.assert_array_equal(first["valid"], jax_run["raised"][2])
    s = port_run["slam"].store
    slot = first["slot"]
    assert first["seq"] == slot            # the id was its age until then
    assert s.kf_seq[slot] >= CAPACITY      # now a younger keyframe


def test_export_through_a_reused_slot(port_run):
    """Across every reuse the exported trajectory stays put within 1e-5,
    including the frames anchored to the keyframe whose slot was taken
    (they now go through its parent at the pair's pose at erasure)."""
    assert sum(r["anchored"] for r in port_run["reuses"]) >= 1
    for r in port_run["reuses"]:
        (ts0, R0, t0), (ts1, R1, t1) = r["before"], r["after"]
        np.testing.assert_array_equal(ts1, ts0)
        np.testing.assert_allclose(R1, R0, rtol=0, atol=1e-5)
        np.testing.assert_allclose(t1, t0, rtol=0, atol=1e-5)


def _small_store(n_kf=5, cap=6, seed=0):
    """A few keyframes observing one set of landmarks, in a port store."""
    rng = np.random.default_rng(seed)
    s = MapStore(MapConfig(max_keyframes=cap, max_map_points=512,
                           max_kp=128, max_obs=8))
    pts = rng.uniform([-3, -2, 4], [3, 2, 10], (96, 3)).astype(np.float32)
    for i in range(n_kf):
        R = np.eye(3, dtype=np.float32)
        t = np.array([-0.2 * i, 0.0, 0.0], np.float32)
        xc = pts + t
        uv = np.stack([500 * xc[:, 0] / xc[:, 2] + 320,
                       500 * xc[:, 1] / xc[:, 2] + 240], -1)
        uv = np.pad(uv.astype(np.float32), ((0, 32), (0, 0)))
        valid = np.arange(128) < 96
        s.add_keyframe(R, t, uv, rng.integers(0, 256, (128, 32)).astype(
            np.uint8), np.zeros(128, np.int32), valid)
    ids = s.add_map_points(pts + rng.normal(0, 0.02, pts.shape).astype(
        np.float32), rng.integers(0, 256, (96, 32)).astype(np.uint8))
    for k in range(n_kf):
        s.add_observations(ids, k, np.arange(96))
        s.update_connections(k)
    return s


def _reuse(s, slot):
    """Erase keyframe `slot`, fill the store to capacity, and add one more
    keyframe: it takes the slot. Returns its pose."""
    s.erase_keyframe(slot)
    R = np.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                   np.float32)
    t = np.array([7.0, 8.0, 9.0], np.float32)
    kw = dict(uv=np.zeros((128, 2), np.float32),
              desc_packed=np.zeros((128, 32), np.uint8),
              octave=np.zeros(128, np.int32), kp_valid=np.ones(128, bool))
    while s.next_kf < s.cfg.max_keyframes:
        s.add_keyframe(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                       **kw)
    assert s.add_keyframe(R, t, **kw) == slot
    return R, t


def test_background_gba_does_not_write_into_a_reused_slot():
    s = _small_store()
    gba = BackgroundGBA(s, Camera(**KW), n_iters=6, device="cpu")
    gba.launch()                        # on the CPU the BA runs here
    R, t = _reuse(s, 3)
    assert gba.poll(block=True)
    np.testing.assert_array_equal(s.kf_R[3], R)
    np.testing.assert_array_equal(s.kf_t[3], t)
    assert gba.n_applied == 1 and not np.array_equal(
        s.kf_t[1], np.array([-0.2, 0.0, 0.0], np.float32))     # applied


def test_reused_slot_is_reset_and_its_database_row_forgotten():
    s = _small_store()
    db = KeyFrameDatabase(s, device="cpu")
    for k in range(5):
        db.add(k)
    s.kf_loop_edges = {3: {1}, 1: {3}}
    s.kf_uvr[3] = 5.0
    s.kf_depth[3] = 2.0
    _reuse(s, 3)
    assert not db.has_bow[3] and not db._bow_dev[3].any()
    assert db.has_bow[[0, 1, 2, 4]].all()
    assert 3 not in s.kf_loop_edges and 3 not in s.kf_loop_edges[1]
    assert not s.covis[3].any() and not s.covis[:, 3].any()
    assert (s.kf_mp[3] < 0).all() and not (s.mp_obs_kf == 3).any()
    assert (s.kf_uvr[3] == -1.0).all() and (s.kf_depth[3] == -1.0).all()
    assert s.kf_parent[3] == -1 and not (s.kf_parent == 3).any()
    assert s.slot_is(3, s.n_kf_created - 1) and not s.slot_is(3, 3)
    assert s.newest_keyframe() == 3
    # the erased keyframe's record: its parent and the pose relative to it
    parent, pseq, R_cp, t_cp = s.kf_tombs[3]
    assert parent >= 0 and s.kf_seq[parent] == pseq
    np.testing.assert_allclose(R_cp @ s.kf_R[parent], np.eye(3), atol=1e-6)
    with pytest.raises(RuntimeError, match="6 live keyframes"):
        s.add_keyframe(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                       np.zeros((128, 2), np.float32),
                       np.zeros((128, 32), np.uint8),
                       np.zeros(128, np.int32), np.ones(128, bool))


def test_worker_skips_a_keyframe_whose_slot_was_reused():
    s = _small_store()
    seq3 = int(s.kf_seq[3])
    _reuse(s, 3)
    mapped = []
    lock = threading.Lock()

    class Mapper:
        device = torch.device("cpu")
        store = s

        def process_keyframe(self, kf):
            with lock:
                mapped.append(kf)
    am = AsyncMapper(Mapper())
    am.submit(3, seq3)                  # queued before the reuse: stale
    am.submit(3, s.kf_seq[3])           # the keyframe now in the slot
    am.submit(2, s.kf_seq[2])
    am.join()
    assert mapped == [3, 2] and am.n_processed == 3


@pytest.mark.parametrize("reused", [False, True])
def test_bundle_refresh_reanchors_only_to_the_same_keyframe(reused):
    """refresh_bundle re-composes the last tracked pose with its reference
    keyframe's current pose only while the slot still holds that keyframe
    (``Tracking.last_rel`` carries its creation number)."""
    s = _small_store()
    seq3 = int(s.kf_seq[3])
    if reused:
        _reuse(s, 3)
    R_cr = np.asarray([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]],
                      np.float32)
    t_cr = np.array([0.5, -0.25, 1.0], np.float32)
    tracked_R = np.eye(3, dtype=np.float32)
    tracked_t = np.array([1.0, 2.0, 3.0], np.float32)
    got = dict(slot=np.full(4, -1, np.int32), R=tracked_R, t=tracked_t,
               oct=np.zeros(4, np.int32), vel_R=tracked_R, vel_t=tracked_t,
               have_vel=False, acc_visible=None, acc_found=None)
    rebuilt = {}
    fe = types.SimpleNamespace(
        store=s, state={k: None for k in (
            "prev_slot", "prev_R", "prev_t", "kp_oct", "vel_R", "vel_t",
            "have_vel", "acc_visible", "acc_found")},
        bundle_ids=np.arange(4), _read=lambda tensors: got,
        _fold_counters=lambda got: None,
        rebuild=lambda anchor, mp, R, t, **kw: rebuilt.update(R=R, t=t))
    FusedFrontend.refresh_bundle(fe, 2, rel_pose=(R_cr, t_cr, 3, seq3))
    if reused:          # another keyframe holds slot 3: pose kept as is
        np.testing.assert_array_equal(rebuilt["R"], tracked_R)
        np.testing.assert_array_equal(rebuilt["t"], tracked_t)
    else:
        np.testing.assert_allclose(rebuilt["R"], R_cr @ s.kf_R[3],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(rebuilt["t"], R_cr @ s.kf_t[3] + t_cr,
                                   rtol=0, atol=1e-6)


def test_slot_state_goes_through_a_checkpoint(tmp_path, port_run):
    s = port_run["slam"].store
    path = str(tmp_path / "map.npz")
    save_map(s, path)
    got = load_map(path)
    np.testing.assert_array_equal(got.kf_seq, s.kf_seq)
    assert got.n_kf_created == s.n_kf_created and got.kf_free == s.kf_free
    # a file without slot state (the JAX package's) implies creation
    # number = id and the erased slots free
    data = dict(np.load(path))
    del data["kf_seq"]
    np.savez(str(tmp_path / "plain.npz"), **data)
    plain = load_map(str(tmp_path / "plain.npz"))
    n = plain.next_kf
    np.testing.assert_array_equal(plain.kf_seq[:n], np.arange(n))
    assert plain.kf_free == [int(k) for k in np.nonzero(
        ~plain.kf_valid[:n])[0] if k != 0]
