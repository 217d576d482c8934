"""The port's per-frame monocular slice against the JAX package, on the
rendered textured-plane sequence of tests/test_slam_image_e2e.py (same
camera, 14 frames, motion 0.5, the same map/tracking/mapper sizes).

(a) The port runs the whole sequence from pixels (its own RANSAC draw) and
    must pass the JAX e2e test's gates: state OK, >= 10 frames tracked,
    > 150 map points, scale-aligned ATE < 0.05.
(b) The JAX system runs init + a few frames; its state is carried into a
    port SlamSystem through interop.py, and both track the next frames from
    that same map. Poses agree to 1e-4 (rotation entries and translation in
    the median-depth-1 gauge): both run the same matches and the same LM
    iterations in f32, and the observed gap is below 1e-5.
"""
import numpy as np
import pytest
import torch

from ar_orbslam2_tpu.core.camera import Camera as JCamera
from ar_orbslam2_tpu.data import synthetic
from ar_orbslam2_tpu.eval.trajectory import save_tum as jax_save_tum
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
from ar_orbslam2_tpu_torch.mapstore.checkpoint import _ARRAYS, load_map
from ar_orbslam2_tpu_torch.mapstore.map import MapConfig
from ar_orbslam2_tpu_torch.system.slam import SlamConfig, SlamSystem
from ar_orbslam2_tpu_torch.system.tracking import TrackingConfig


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The port's steps are chains of tiny ops: more intra-op threads buy
    nothing and fight the other test workers for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SIZES = dict(map=dict(max_keyframes=64, max_map_points=20_000, max_kp=1024),
             tracking=dict(max_kp=1024, n_local_mp=2048,
                           max_frames_between_kf=5),
             mapper=dict(ba_max_points=2048, n_triangulation_neighbors=5,
                         n_fuse_neighbors=5))
SLICE = dict(use_fused_tracking=False, async_mapping=False,
             enable_loop_closing=False, enable_relocalization=False)
CAM = Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)
SNAP_AT = 4          # JAX state is carried across after this frame
N_NEXT = 3           # frames then tracked by both packages


def _port_cfg():
    return SlamConfig(map=MapConfig(**SIZES["map"]),
                      tracking=TrackingConfig(**SIZES["tracking"]),
                      mapper=LocalMapperConfig(**SIZES["mapper"]), **SLICE)


@pytest.fixture(scope="module")
def sequence():
    return synthetic.render_plane_sequence(JCamera(*CAM), n_frames=14,
                                           seed=0, motion=0.5)


@pytest.fixture(scope="module")
def port_run(sequence):
    imgs, R_cw, t_cw = sequence
    slam = SlamSystem(CAM, _port_cfg(), device="cpu")
    poses = slam.track_monocular_batch(
        list(imgs), timestamps=[i / 30.0 for i in range(len(imgs))])
    return slam, poses


@pytest.fixture(scope="module")
def jax_run(sequence):
    imgs, _, _ = sequence
    cfg = JSlamConfig(map=JMapConfig(**SIZES["map"]),
                      tracking=JTrackingConfig(**SIZES["tracking"]),
                      mapper=JMapperConfig(**SIZES["mapper"]), **SLICE)
    slam = JSlamSystem(JCamera(*CAM), cfg)
    poses, snap = [], None
    for i in range(SNAP_AT + 1 + N_NEXT):
        poses.append(slam.track_monocular(imgs[i], timestamp=i / 30.0))
        if i == SNAP_AT:
            assert slam.tracking.state == "OK"
            snap = interop.export_state(slam)
    return poses, snap, slam


def test_port_tracks_the_sequence(port_run):
    slam, poses = port_run
    assert slam.tracking.state == "OK"
    assert sum(p is not None for p in poses) >= 10
    assert slam.store.n_map_points() > 150
    assert slam.store.n_keyframes() >= 2


def test_port_ate(port_run, sequence):
    _, R_cw, t_cw = sequence
    _, poses = port_run
    est = np.array([-(p[:3, :3].T @ p[:3, 3]) for p in poses
                    if p is not None])
    gt = np.array([-(R_cw[i].T @ t_cw[i]) for i, p in enumerate(poses)
                   if p is not None])
    assert ate_rmse(est, gt, with_scale=True) < 0.05


def test_carried_state_tracks_like_jax(jax_run, sequence):
    imgs, _, _ = sequence
    jax_poses, snap, _ = jax_run
    slam = interop.from_state(CAM, _port_cfg(), snap, device="cpu")
    assert slam.store.n_map_points() == int(snap["map"]["mp_valid"].sum())
    for i in range(SNAP_AT + 1, SNAP_AT + 1 + N_NEXT):
        T = slam.track_monocular(imgs[i], timestamp=i / 30.0)
        assert T is not None and jax_poses[i] is not None
        np.testing.assert_allclose(T, jax_poses[i], atol=1e-4,
                                   err_msg=f"frame {i}")
    assert slam.tracking.state == "OK"


def test_jax_saved_map_loads_in_port(jax_run, tmp_path):
    """A map written by the JAX package's save_map loads through the port's
    checkpoint module array for array (exact: it is the same npz)."""
    _, _, jslam = jax_run
    path = str(tmp_path / "map.npz")
    jslam.save_map(path)
    store = load_map(path)
    for name in _ARRAYS:
        np.testing.assert_array_equal(getattr(store, name),
                                      np.asarray(getattr(jslam.store, name)),
                                      err_msg=name)
    assert store.next_kf == jslam.store.next_kf
    assert store.n_map_points() == jslam.store.n_map_points()


def test_trajectory_exports(port_run, tmp_path):
    """The port's TUM and KITTI files hold its frame trajectory, and its TUM
    writer gives the JAX writer's file on the same poses (to 1e-6: the
    quaternion is computed in f32 by each framework)."""
    slam, poses = port_run
    ts, R_wc, t_wc = slam.frame_trajectory()
    assert len(ts) == sum(p is not None for p in poses)
    slam.save_trajectory_tum(str(tmp_path / "port.txt"))
    jax_save_tum(str(tmp_path / "jax.txt"), ts, R_wc, t_wc)
    port_tum = np.loadtxt(tmp_path / "port.txt")
    np.testing.assert_allclose(port_tum, np.loadtxt(tmp_path / "jax.txt"),
                               atol=1e-6)
    np.testing.assert_allclose(port_tum[:, 1:4], t_wc, atol=1e-6)
    slam.save_trajectory_kitti(str(tmp_path / "port.kitti"))
    kitti = np.loadtxt(tmp_path / "port.kitti").reshape(-1, 3, 4)
    np.testing.assert_allclose(kitti[:, :, 3], t_wc, rtol=1e-7, atol=1e-7)
    slam.save_keyframe_trajectory_tum(str(tmp_path / "kf.txt"))
    assert len(np.loadtxt(tmp_path / "kf.txt", ndmin=2)) == \
        slam.store.n_keyframes()


def test_unported_options_raise():
    for opt in ("use_fused_tracking", "async_mapping",
                "enable_relocalization", "enable_loop_closing"):  # ported
        assert getattr(SlamConfig(**dict(SLICE, **{opt: True})), opt)
    # the depth sensors are ported too; only an unknown sensor raises
    for sensor in ("STEREO", "RGBD"):
        assert SlamConfig(sensor=sensor, **SLICE).sensor == sensor
    with pytest.raises(ValueError, match="unknown sensor"):
        SlamConfig(sensor="LIDAR", **SLICE)
    # the JAX defaults are all ported for the monocular sensor
    assert SlamConfig().enable_loop_closing
    assert SlamConfig(async_mapping=True).async_mapping


def test_entry_points_default_to_the_card():
    """Without a GPU the entry points raise instead of moving to the CPU;
    the tests ask for the CPU explicitly."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    from ar_orbslam2_tpu_torch.mapping.local_mapping import LocalMapper
    from ar_orbslam2_tpu_torch.mapstore.map import MapStore
    from ar_orbslam2_tpu_torch.system.tracking import Tracking
    store = MapStore(MapConfig(**SIZES["map"]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SlamSystem(CAM, _port_cfg())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalMapper(store, CAM)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Tracking(store, None, CAM)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.from_state(CAM, _port_cfg(), {})
