"""The port's depth sensors and localization mode against the JAX package on
the CPU.

Two JAX runs are made once per module: the RGB-D feature orbit of
tests/test_slam_stereo_e2e.py (30 frames, 512 keypoints, per-keypoint
depth), and the rendered stereo pairs of tests/test_stereo_image_e2e.py
(640x480, 1024 keypoints, a few frames). Their states are carried into port
systems through interop.py, and both packages go on from there.

Tolerances: the depth initialization and the depth landmark seeding of a
keyframe are host numpy in both packages — landmark ids and bindings exact,
positions <= 1e-6; the keyframe decisions of a whole RGB-D run equal frame
by frame; poses after carried frames <= 1e-4, the tolerance of
tests/test_torch_slam.py::test_carried_state_tracks_like_jax. Localization
mode is held to tests/test_localization_vo.py's gates on that test's scene,
and a map saved by the JAX package loads into a port system and
relocalizes it (with the place-recognition database rebuilt even though the
system has no loop closer: the JAX package leaves it empty, ROADMAP.md §3).
"""
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
from ar_orbslam2_tpu_torch import interop
from ar_orbslam2_tpu_torch.core.camera import Camera
from ar_orbslam2_tpu_torch.eval.ate import ate_rmse
from ar_orbslam2_tpu_torch.mapping.local_mapping import LocalMapperConfig
from ar_orbslam2_tpu_torch.mapstore.map import MapConfig
from ar_orbslam2_tpu_torch.system.slam import SlamConfig, SlamSystem
from ar_orbslam2_tpu_torch.system.tracking import TrackingConfig

FEAT_KW = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=40.0)
IMG_KW = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480,
              bf=50.0)
RGBD_FRAMES = 30
RGBD_SNAP = 14           # RGB-D state carried across after this frame
STEREO_FRAMES = 6
STEREO_SNAP = 2          # stereo state carried across after this frame


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The port's stages are chains of small ops: more intra-op threads buy
    nothing and fight the other test workers for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _sizes(max_kp, n_local_mp, ba_points):
    return dict(map=dict(max_keyframes=64, max_map_points=20_000,
                         max_kp=max_kp),
                tracking=dict(max_kp=max_kp, n_local_mp=n_local_mp,
                              max_frames_between_kf=5),
                mapper=dict(ba_max_points=ba_points,
                            n_triangulation_neighbors=5,
                            n_fuse_neighbors=5))


FEAT_SIZES = _sizes(512, 2048, 2048)
IMG_SIZES = _sizes(1024, 4096, 4096)


def _cfg(jax, sensor, sizes, reloc=False):
    M, T, L, S = ((JMapConfig, JTrackingConfig, JMapperConfig, JSlamConfig)
                  if jax else (MapConfig, TrackingConfig, LocalMapperConfig,
                               SlamConfig))
    return S(sensor=sensor, map=M(**sizes["map"]),
             tracking=T(**sizes["tracking"]), mapper=L(**sizes["mapper"]),
             enable_loop_closing=False, enable_relocalization=reloc)


def _rgbd_scene():
    return synthetic.make_scene(n_landmarks=1500, n_frames=RGBD_FRAMES,
                                seed=5, trajectory="orbit", arc=1.0)


def _rgbd_frame(scene, i):
    obs = synthetic.observe_frame(scene, i, JCamera(**FEAT_KW), max_kp=512,
                                  noise_px=0.3, bit_flip=0.02)
    return dict(features=dict(uv=obs["uv"], desc=obs["desc"],
                              octave=obs["octave"], valid=obs["valid"]),
                kp_depth=obs["depth"], timestamp=scene.timestamps[i])


def _watch_decisions(tracking, out):
    need = tracking._need_new_keyframe

    def watched(frame, n_inliers):
        got = need(frame, n_inliers)
        out.append((int(frame.frame_id), bool(got)))
        return got
    tracking._need_new_keyframe = watched


@pytest.fixture(scope="module")
def jax_rgbd():
    """The JAX RGB-D run: poses, keyframe decisions, the state after frame
    0 and after RGBD_SNAP, and each keyframe insertion (the state and the
    frame just before it, the state just after)."""
    scene = _rgbd_scene()
    slam = JSlamSystem(JCamera(**FEAT_KW), _cfg(True, "RGBD", FEAT_SIZES))
    t = slam.tracking
    decisions, inserts = [], []
    _watch_decisions(t, decisions)
    insert = t._insert_keyframe

    def watched_insert(frame, record_dbg=True):
        before = interop.export_state(slam)
        fields = {k: np.array(getattr(frame, k), copy=True) for k in
                  ("R", "t", "mp", "uv", "desc_bits", "octave", "valid",
                   "angle", "uvr", "depth")}
        fields.update(frame_id=frame.frame_id, timestamp=frame.timestamp)
        kf = insert(frame, record_dbg)
        inserts.append(dict(before=before, frame=fields, kf=kf,
                            mp_after=frame.mp.copy(),
                            after=interop.export_state(slam),
                            recent=dict(slam.mapper.recent)))
        return kf
    t._insert_keyframe = watched_insert
    poses, snaps = [], {}
    for i in range(scene.n_frames):
        poses.append(slam.track_rgbd(**_rgbd_frame(scene, i)))
        if i in (0, RGBD_SNAP):
            snaps[i] = interop.export_state(slam)
    return dict(scene=scene, poses=poses, decisions=decisions,
                inserts=inserts, snaps=snaps, slam=slam)


def _port(state, sensor, sizes, kw, reloc=False):
    return interop.from_state(Camera(**kw), _cfg(False, sensor, sizes,
                                                 reloc), state, device="cpu")


def _assert_maps_equal(port_store, jax_map, pos_tol=1e-6):
    got = {k: getattr(port_store, k) for k in jax_map}
    for k in ("kf_valid", "kf_mp", "mp_valid", "mp_desc", "mp_obs_kf",
              "mp_obs_feat", "mp_nobs", "covis", "kf_parent", "kf_uvr",
              "kf_depth"):
        np.testing.assert_array_equal(got[k], jax_map[k], err_msg=k)
    for k in ("mp_pos", "mp_normal", "mp_dmin", "mp_dmax", "kf_R", "kf_t"):
        np.testing.assert_allclose(got[k], jax_map[k], rtol=0, atol=pos_tol,
                                   err_msg=k)


def test_initialize_stereo_matches_jax(jax_rgbd):
    """Frame 0 (>= 100 keypoints with depth) initializes the map: one
    keyframe at the identity, a landmark per depth keypoint."""
    slam = SlamSystem(Camera(**FEAT_KW), _cfg(False, "RGBD", FEAT_SIZES),
                      device="cpu")
    assert slam.track_rgbd(**_rgbd_frame(jax_rgbd["scene"], 0)) is not None
    want = jax_rgbd["snaps"][0]
    _assert_maps_equal(slam.store, want["map"])
    assert slam.store.n_keyframes() == 1 and slam.tracking.state == "OK"
    np.testing.assert_array_equal(slam.last_frame.mp,
                                  want["last_frame"]["mp"])
    assert slam.store.kf_seq[0] == 0 and slam.store.n_kf_created == 1


def test_create_depth_points_matches_jax(jax_rgbd):
    """Each keyframe insertion of the JAX run, replayed on its carried
    state: the same keyframe id, the same depth landmarks and bindings,
    positions within 1e-6, the same recent set."""
    assert len(jax_rgbd["inserts"]) >= 2
    for ins in jax_rgbd["inserts"]:
        slam = _port(ins["before"], "RGBD", FEAT_SIZES, FEAT_KW)
        f = ins["frame"]
        frame = slam.make_frame(features=dict(
            uv=f["uv"], desc=f["desc_bits"], octave=f["octave"],
            valid=f["valid"], angle=f["angle"]), timestamp=f["timestamp"],
            uvr=f["uvr"], depth=f["depth"])
        frame.frame_id = f["frame_id"]
        frame.R, frame.t, frame.mp = f["R"], f["t"], f["mp"].copy()
        kf = slam.tracking._insert_keyframe(frame)
        assert kf == ins["kf"]
        np.testing.assert_array_equal(frame.mp, ins["mp_after"])
        _assert_maps_equal(slam.store, ins["after"]["map"])
        assert slam.mapper.recent == ins["recent"]
        assert slam.tracking._dbg["n_depth_mp"] > 0


def test_depth_keyframe_decisions_match_jax(jax_rgbd):
    """The port's own run of the whole RGB-D sequence: the same keyframe
    decision at every frame, metric ATE, depth-seeded keyframes."""
    scene = jax_rgbd["scene"]
    slam = SlamSystem(Camera(**FEAT_KW), _cfg(False, "RGBD", FEAT_SIZES),
                      device="cpu")
    decisions = []
    _watch_decisions(slam.tracking, decisions)
    poses = [slam.track_rgbd(**_rgbd_frame(scene, i))
             for i in range(scene.n_frames)]
    assert decisions == jax_rgbd["decisions"]
    assert any(d for _, d in decisions)
    assert all(p is not None for p in poses)
    est = np.array([-(p[:3, :3].T @ p[:3, 3]) for p in poses])
    gt = -(np.swapaxes(scene.R_cw, -1, -2) @ scene.t_cw[..., None])[..., 0]
    assert ate_rmse(est, gt, with_scale=False) < 0.05
    seeded = [r.get("n_depth_mp", 0) for r in slam.tracking.metrics
              if "new_kf" in r]
    assert len(seeded) >= 2 and all(n > 0 for n in seeded)
    assert slam.store.n_keyframes() == jax_rgbd["slam"].store.n_keyframes()


def test_carried_rgbd_state_tracks_like_jax(jax_rgbd):
    scene, poses = jax_rgbd["scene"], jax_rgbd["poses"]
    slam = _port(jax_rgbd["snaps"][RGBD_SNAP], "RGBD", FEAT_SIZES, FEAT_KW)
    for i in range(RGBD_SNAP + 1, RGBD_SNAP + 6):
        T = slam.track_rgbd(**_rgbd_frame(scene, i))
        assert T is not None and poses[i] is not None
        np.testing.assert_allclose(T, poses[i], atol=1e-4,
                                   err_msg=f"frame {i}")


@pytest.fixture(scope="module")
def jax_stereo(tmp_path_factory):
    """The JAX stereo image run, its state after STEREO_SNAP and its map
    saved at the end."""
    left, right, R_cw, t_cw = synthetic.render_stereo_plane_sequence(
        JCamera(**IMG_KW), n_frames=STEREO_FRAMES, seed=1, motion=0.4)
    slam = JSlamSystem(JCamera(**IMG_KW), _cfg(True, "STEREO", IMG_SIZES))
    poses, snap = [], None
    for i in range(STEREO_FRAMES):
        poses.append(slam.track_stereo(left[i], right[i],
                                       timestamp=i / 30.0))
        if i == STEREO_SNAP:
            snap = interop.export_state(slam)
    path = str(tmp_path_factory.mktemp("map") / "stereo_map.npz")
    slam.save_map(path)
    return dict(left=left, right=right, R_cw=R_cw, t_cw=t_cw, poses=poses,
                snap=snap, path=path, slam=slam)


def test_carried_stereo_state_tracks_like_jax(jax_stereo):
    """From the carried state the port tracks the next stereo pairs from
    pixels (its own ORB, stereo match and refinement)."""
    js = jax_stereo
    assert js["snap"]["last_frame"]["depth"] is not None
    slam = _port(js["snap"], "STEREO", IMG_SIZES, IMG_KW)
    assert slam.last_frame.uvr is not None
    for i in range(STEREO_SNAP + 1, STEREO_FRAMES):
        T = slam.track_stereo(js["left"][i], js["right"][i],
                              timestamp=i / 30.0)
        assert T is not None and js["poses"][i] is not None
        np.testing.assert_allclose(T, js["poses"][i], atol=1e-4,
                                   err_msg=f"frame {i}")
        assert slam.tracking.metrics[-1]["t_features_ms"] > 0.0


def test_load_map_relocalizes_a_localization_only_system(jax_stereo):
    """A map saved by the JAX package loads into a fresh port system
    (relocalization on, no loop closer): the database is rebuilt from the
    loaded keyframes (the JAX package's load_map leaves it empty without a
    loop closer), the system relocalizes on a frame from the middle of the
    sequence at metric accuracy, and the map stays frozen."""
    js = jax_stereo
    cfg = _cfg(False, "STEREO", IMG_SIZES, reloc=True)
    slam = SlamSystem(Camera(**IMG_KW), cfg, device="cpu")
    slam.load_map(js["path"])
    s = slam.store
    n_kf, n_mp = s.n_keyframes(), s.n_map_points()
    assert n_kf == js["slam"].store.n_keyframes() and n_mp > 150
    assert slam.tracking.only_tracking and slam.tracking.state == "LOST"
    np.testing.assert_array_equal(slam.kfdb.has_bow, s.kf_valid)
    jslam = JSlamSystem(JCamera(**IMG_KW), _cfg(True, "STEREO", IMG_SIZES,
                                                 reloc=True))
    jslam.load_map(js["path"])                 # the reference fault
    assert jslam.store.n_keyframes() == n_kf
    assert not jslam.tracking.relocalizer.kfdb.has_bow.any()
    err = []
    R0, t0 = js["R_cw"][0], js["t_cw"][0]    # the map's frame: camera 0
    for i in (3, 4, 5):
        T = slam.track_stereo(js["left"][i], js["right"][i],
                              timestamp=i / 30.0)
        assert T is not None, f"frame {i} not tracked"
        c = -(T[:3, :3].T @ T[:3, 3])
        c_gt = R0 @ -(js["R_cw"][i].T @ js["t_cw"][i]) + t0
        err.append(np.linalg.norm(c - c_gt))
    assert slam.tracking.relocalizer.n_success >= 1
    assert max(err) < 0.05
    assert s.n_keyframes() == n_kf and s.n_map_points() == n_mp


def _out_and_back_scene(n_out=36, n_back=15, seed=5):
    """tests/test_localization_vo.py's corridor: forward, then retraced."""
    base = synthetic.make_scene(
        n_landmarks=4000, n_frames=n_out, seed=seed, trajectory="forward",
        box=((-4.0, -3.0, 0.0), (4.0, 3.0, 26.0)), speed=0.35)
    back = np.arange(n_back - 1, -1, -1)
    R = np.concatenate([base.R_cw, base.R_cw[back]])
    t = np.concatenate([base.t_cw, base.t_cw[back]])
    return synthetic.SyntheticScene(base.landmarks, base.desc_bits, R, t,
                                    np.arange(len(R)) / 30.0)


def test_localization_mode_rides_vo_and_reacquires_the_map():
    """tests/test_localization_vo.py's scenario at its size, on the port:
    the map built on the first 16 frames is frozen, the unmapped stretch is
    tracked in the VO regime, and the map is re-acquired on the way back."""
    scene = _out_and_back_scene()
    cam = Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0)
    slam = SlamSystem(cam, _cfg(False, "RGBD", FEAT_SIZES, reloc=True),
                      device="cpu")
    n_map = 16
    history = []
    for i in range(scene.n_frames):
        if i == n_map:
            slam.activate_localization_mode()
            n_kf, n_resets = slam.store.n_keyframes(), slam.tracking.n_resets
        obs = synthetic.observe_frame(scene, i, JCamera(*cam), max_kp=512,
                                      noise_px=0.3, bit_flip=0.02)
        T = slam.track_rgbd(features=dict(uv=obs["uv"], desc=obs["desc"],
                                          octave=obs["octave"],
                                          valid=obs["valid"]),
                            kp_depth=obs["depth"],
                            timestamp=scene.timestamps[i])
        history.append((i, T is not None, slam.tracking.vo))
    s = slam.store
    assert (s.kf_frame_id[s.kf_valid] >= n_map).sum() == 0
    # frozen: no keyframe added, and no reset after a loss (the JAX run of
    # this scene loses frame 11 in mapping mode and resets, as here)
    assert s.n_keyframes() == n_kf and slam.tracking.n_resets == n_resets
    assert any(not ok for i, ok, _ in history if i >= n_map)
    mid = [ok for i, ok, _ in history if n_map + 8 <= i < n_map + 20]
    assert sum(mid) >= 0.5 * len(mid)
    assert any(vo for _, _, vo in history)
    assert any(ok and not vo for _, ok, vo in history[-6:])
    slam.deactivate_localization_mode()
    assert not slam.tracking.only_tracking and not slam.tracking.vo
