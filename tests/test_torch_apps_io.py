"""The port's settings parser, dataset loaders, trajectory loaders and the
apps' SlamConfig against the JAX package, on inline fixtures.

Settings, loader outputs, associations and SlamConfigs must be equal; the
trajectory loaders within 1e-6 (each framework turns the quaternion into a
matrix in float32).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from ar_orbslam2_tpu.apps.common import build_system as jax_build_system
from ar_orbslam2_tpu.data import datasets as jds
from ar_orbslam2_tpu.eval import trajectory as jtraj
from ar_orbslam2_tpu.utils.config import load_settings as jax_load_settings
from ar_orbslam2_tpu_torch.apps.common import build_system, metrics_rows
from ar_orbslam2_tpu_torch.core.camera import Camera
from ar_orbslam2_tpu_torch.data import datasets
from ar_orbslam2_tpu_torch.eval import trajectory
from ar_orbslam2_tpu_torch.utils.config import load_settings, write_settings


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The port's steps are chains of tiny ops: more intra-op threads buy
    nothing and fight the other test workers for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TOL_TRAJ = 1e-6

TUM1_YAML = """%YAML:1.0
# Camera Parameters (reference TUM1.yaml field names)
Camera.fx: 517.306408
Camera.fy: 516.469215
Camera.cx: 318.643040
Camera.cy: 255.313989
Camera.k1: 0.262383
Camera.k2: -0.953104
Camera.p1: -0.005358
Camera.p2: 0.002628
Camera.k3: 1.163314
Camera.fps: 30.0
Camera.RGB: 1
ThDepth: 40.0
DepthMapFactor: 5000.0
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
Viewer.KeyFrameSize: 0.05
Viewer.ViewpointF: 500
"""

KITTI_YAML = """%YAML:1.0
---
Camera.fx: 718.856
Camera.fy: 718.856
Camera.cx: 607.1928
Camera.cy: 185.2157
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 1241
Camera.height: 376
Camera.fps: 10.0
Camera.bf: 386.1448
Camera.RGB: 1
ThDepth: 35
DepthMapFactor: 0
ORBextractor.nFeatures: 2000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
Viewer.PointSize:2
Viewer.ViewpointZ: -1.8e2
Name: "kitti"
"""


def _settings_fields(st):
    d = {f.name: getattr(st, f.name) for f in dataclasses.fields(st)}
    d["camera"] = tuple(d["camera"])
    return d


@pytest.mark.parametrize("text", [TUM1_YAML, KITTI_YAML],
                         ids=["tum1", "kitti"])
def test_load_settings_matches_jax(tmp_path, text):
    p = tmp_path / "settings.yaml"
    p.write_text(text)
    port, ref = load_settings(str(p)), jax_load_settings(str(p))
    assert _settings_fields(port) == _settings_fields(ref)
    for k, v in ref.raw.items():        # the int/float rule, key by key
        assert type(port.raw[k]) is type(v), k


def test_write_settings_reads_back_in_both_packages(tmp_path):
    cam = Camera(fx=500.0, fy=501.5, cx=320.0, cy=240.0, bf=50.0,
                 width=640, height=480)
    p = str(tmp_path / "s.yaml")
    write_settings(p, cam, fps=30.0, n_features=1000,
                   depth_map_factor=5000.0)
    st = load_settings(p)
    assert tuple(st.camera) == tuple(cam)
    assert (st.fps, st.n_features, st.depth_map_factor) == \
        (30.0, 1000, 5000.0)
    assert _settings_fields(st) == _settings_fields(jax_load_settings(p))


def _tum_tree(root):
    seq = root / "seq"
    (seq / "rgb").mkdir(parents=True)
    (seq / "rgb.txt").write_text(
        "# color images\n# timestamp filename\n"
        "1.0 rgb/0.png\n1.05 rgb/1.png\n1.10 rgb/2.png\n1.30 rgb/3.png\n")
    # 1.06 is nearest to both 1.05 and 1.10 (taken twice, as
    # associate.py's greedy pass allows); nothing within 0.02 of 1.30
    (seq / "depth.txt").write_text(
        "# depth\n1.01 depth/0.png\n1.06 depth/1.png\n1.2 depth/2.png\n")
    return str(seq)


def test_dataset_loaders_match_jax(tmp_path):
    seq = _tum_tree(tmp_path)
    for port, ref in ((datasets.load_tum_monocular(seq),
                       jds.load_tum_monocular(seq)),
                      (datasets.load_tum_rgbd(seq), jds.load_tum_rgbd(seq)),
                      (datasets.load_tum_rgbd(seq, max_dt=0.05),
                       jds.load_tum_rgbd(seq, max_dt=0.05))):
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    kseq = tmp_path / "00"
    kseq.mkdir()
    (kseq / "times.txt").write_text("0.0\n0.1\n0.2\n")
    for stereo in (False, True):
        for a, b in zip(datasets.load_kitti(str(kseq), stereo=stereo),
                        jds.load_kitti(str(kseq), stereo=stereo)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    eseq = tmp_path / "MH01" / "mav0" / "cam0"
    eseq.mkdir(parents=True)
    (eseq / "data.csv").write_text(
        "#timestamp [ns],filename\n"
        "1403636579763555584,1403636579763555584.png\n"
        "1403636579813555456, 1403636579813555456.png\n")
    for a, b in zip(datasets.load_euroc(str(tmp_path / "MH01")),
                    jds.load_euroc(str(tmp_path / "MH01"))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("max_dt", [0.005, 0.02, 0.1])
def test_associate_matches_jax(max_dt):
    rng = np.random.default_rng(3)
    ts_a = np.sort(rng.uniform(0, 3, 90))
    ts_b = np.sort(rng.uniform(0, 3, 70))
    assert datasets.associate(ts_a, ts_b, max_dt) == \
        jds.associate(ts_a, ts_b, max_dt)


def test_images_and_16bit_depth_as_the_jax_app_reads_them(tmp_path):
    import cv2
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "g.png"), img)
    raw = rng.integers(0, 65535, (48, 64)).astype(np.uint16)
    cv2.imwrite(str(tmp_path / "d.png"), raw)
    np.testing.assert_array_equal(
        datasets.imread_gray(str(tmp_path / "g.png")),
        jds._imread_gray(str(tmp_path / "g.png")))
    want = raw.astype(np.float32)       # JAX apps/run_dataset.py:77-80
    want /= 5000.0
    np.testing.assert_array_equal(
        datasets.imread_depth(str(tmp_path / "d.png"), 5000.0), want)
    assert list(datasets.iter_images([str(tmp_path / "g.png")]))[0].shape \
        == (48, 64)


def test_write_tum_sequence_reads_back_through_the_jax_loaders(tmp_path):
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(1)
    n = 6
    R_cw = Rotation.random(n, rng).as_matrix().astype(np.float32)
    t_cw = rng.standard_normal((n, 3)).astype(np.float32)
    imgs = rng.integers(0, 256, (n, 24, 32), dtype=np.uint8)
    depth = rng.uniform(0.5, 4.0, (n, 24, 32)).astype(np.float32)
    seq = str(tmp_path / "seq")
    datasets.write_tum_sequence(seq, imgs, R_cw, t_cw, depth=depth)
    ts, rgb, dep = jds.load_tum_rgbd(seq)
    np.testing.assert_allclose(ts, np.arange(n) / 30.0, atol=1e-6)
    for i in range(n):
        np.testing.assert_array_equal(jds._imread_gray(rgb[i]), imgs[i])
        # 16-bit at 5000 per meter: within half a step
        assert np.abs(datasets.imread_depth(dep[i], 5000.0)
                      - depth[i]).max() <= 0.5 / 5000 + 1e-6
    _, R_wc, t_wc = jtraj.load_tum(f"{seq}/groundtruth.txt")
    np.testing.assert_allclose(R_wc, np.swapaxes(R_cw, 1, 2), atol=1e-5)
    np.testing.assert_allclose(
        t_wc, -np.einsum("nji,nj->ni", R_cw, t_cw), atol=1e-5)


def test_trajectory_loaders_match_jax(tmp_path):
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(2)
    n = 12
    R = Rotation.random(n, rng).as_matrix().astype(np.float32)
    t = rng.standard_normal((n, 3)).astype(np.float32)
    ts = 1e9 + np.arange(n) / 30.0
    p = tmp_path / "traj.txt"
    jtraj.save_tum(str(p), ts, R, t)
    # comment lines and comma separators, as load_tum tolerates them
    body = p.read_text().splitlines()
    body[3] = body[3].replace(" ", ",")
    p.write_text("# timestamp tx ty tz qx qy qz qw\n" + "\n".join(body)
                 + "\n")
    port, ref = trajectory.load_tum(str(p)), jtraj.load_tum(str(p))
    np.testing.assert_array_equal(port[0], ref[0])
    for a, b in zip(port[1:], ref[1:]):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL_TRAJ)
    np.testing.assert_allclose(port[1], R, atol=1e-5)   # qx qy qz qw order
    k = tmp_path / "traj.kitti"
    trajectory.save_kitti(str(k), R, t)
    for a, b in zip(trajectory.load_kitti(str(k)), jtraj.load_kitti(str(k))):
        np.testing.assert_allclose(a, b, atol=TOL_TRAJ)


@pytest.mark.parametrize("sensor,text", [("MONOCULAR", TUM1_YAML),
                                         ("STEREO", KITTI_YAML),
                                         ("RGBD", TUM1_YAML)])
@pytest.mark.parametrize("loops", [True, False])
def test_build_system_config_matches_jax(tmp_path, sensor, text, loops):
    p = tmp_path / "s.yaml"
    p.write_text(text)
    port = build_system(load_settings(str(p)), sensor=sensor,
                        enable_loops=loops, device="cpu")
    ref = jax_build_system(jax_load_settings(str(p)), sensor=sensor,
                           enable_loops=loops)
    assert dataclasses.asdict(port.cfg) == dataclasses.asdict(ref.cfg)
    assert tuple(port.cam) == tuple(ref.cam)
    assert port.device.type == "cpu"


def test_build_system_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    import torch
    from ar_orbslam2_tpu_torch.utils.config import Settings
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_system(Settings())


def test_metrics_rows_are_json_with_the_camera_centre():
    R = np.eye(3, dtype=np.float32)[[1, 2, 0]]
    t = np.array([1.0, 2.0, 3.0], np.float32)
    recs = [dict(frame_id=0, ok=False, state="NOT_INITIALIZED"),
            dict(frame_id=1, ok=True, R=R, t=t, R_cr=R, t_cr=t,
                 ref_kf=np.int64(0), n_inliers=np.int32(77))]
    rows = [json.loads(r) for r in metrics_rows(recs)]
    assert "twc" not in rows[0]
    np.testing.assert_allclose(rows[1]["twc"], -(R.T @ t))
    assert "R" not in rows[1] and "t" not in rows[1]
    assert rows[1]["R_cr"] == R.tolist() and rows[1]["n_inliers"] == 77
