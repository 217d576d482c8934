"""The port's run_ar and run_stream end to end on the CPU, on
tests/test_torch_apps.py's TUM directory (nFeatures 500: 512 padded
keypoints; 32 frames of the rendered plane sweep at 640x480):

- run_ar anchors a cube on the rendered plane (its normal within 10
  degrees of the plane's, both in the camera's frame) and every overlay
  draws the tracked dots of the frame just tracked: each dot is a keypoint
  of that image (to 1e-4 px), where the JAX app draws the last frame of
  the per-frame path, which lags by one more frame per fused frame (shown
  on the JAX package itself);
- run_stream tracks an image directory with the overlay and its metrics.
"""
import os

import numpy as np
import pytest
import torch

from ar_orbslam2_tpu_torch.apps import run_ar, run_stream
from ar_orbslam2_tpu_torch.frontend.orb import OrbConfig, extract_orb
from test_torch_apps import N_FRAMES, tum_sequence

NORMAL_GATE_DEG = 10.0
DOT_TOL_PX = 1e-4
STALE_FRAMES = 8


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    return tum_sequence(tmp_path_factory.mktemp("tum"))


def test_run_ar_anchors_a_cube_and_draws_the_current_frame(seq, tmp_path):
    d, imgs, R_cw, t_cw = seq
    at = 20
    out = run_ar.main([os.path.join(d, "settings.yaml"), d, "--out",
                       str(tmp_path / "ar"), "--add-cube-at", str(at),
                       "--device", "cpu"])
    slam, viewer = out["slam"], out["viewer"]
    assert out["cube_frame"] == at and len(viewer.cubes) == 1
    # the plane's normal in the camera at the cube's frame: estimated
    # (R_cw . n) against the rendered plane's (z = 3, facing the camera)
    rec = next(r for r in slam.tracking.metrics if r["frame_id"] == at)
    n_est = rec["R"] @ viewer.plane.normal
    n_true = R_cw[at] @ np.array([0.0, 0.0, -1.0])
    angle = np.degrees(np.arccos(np.clip(n_est @ n_true, -1.0, 1.0)))
    assert angle < NORMAL_GATE_DEG, angle
    pngs = sorted(os.listdir(tmp_path / "ar"))
    assert len(pngs) == N_FRAMES
    import cv2
    assert cv2.imread(str(tmp_path / "ar" / pngs[-1])).shape == (502, 640, 3)
    # the dots of overlay i are keypoints of image i
    assert out["drawn"] == list(range(N_FRAMES))
    fused = [r["frame_id"] for r in slam.tracking.metrics if r.get("fused")]
    assert len(fused) >= N_FRAMES // 2
    cfg = OrbConfig(n_features=slam.cfg.tracking.max_kp)

    def keypoints(i):
        f = extract_orb(torch.as_tensor(imgs[i]), cfg)
        return f["uv"][f["valid"]].numpy()

    for i in fused[::4]:
        dots = out["dots"][i]
        assert len(dots) >= 50
        gap = np.abs(dots[:, None, :] - keypoints(i)[None]).max(-1).min(1)
        assert gap.max() <= DOT_TOL_PX, (i, gap.max())


def test_jax_run_ar_reads_a_stale_frame(seq):
    """The reference fault the port's run_ar repairs: the JAX app reads
    slam.last_frame after track_monocular, and the fused path never sets
    it, so from the first fused frame on it lags one more frame each
    frame."""
    from ar_orbslam2_tpu.apps.common import build_system as jax_build
    from ar_orbslam2_tpu.utils.config import Settings as JSettings
    from ar_orbslam2_tpu.core.camera import Camera as JCamera
    _, imgs, _, _ = seq
    cam = JCamera(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640,
                  height=480)
    slam = jax_build(JSettings(camera=cam, n_features=500))
    lags, fused = [], []
    for i in range(STALE_FRAMES):
        slam.track_monocular(imgs[i], timestamp=i / 30.0)
        fused.append(bool(slam.tracking.metrics[-1].get("fused")))
        lags.append(i - int(round(slam.last_frame.timestamp * 30.0)))
    slam.shutdown()
    first = fused.index(True)
    assert all(fused[first:])
    assert lags[:first] == [0] * first
    assert lags[first:] == list(range(1, STALE_FRAMES - first + 1)), lags


def test_run_stream_tracks_an_image_glob(seq, tmp_path):
    import json
    d, imgs, _, _ = seq
    n = 8
    frames = list(run_stream.frame_source(os.path.join(d, "rgb", "*.png")))
    assert len(frames) == N_FRAMES
    np.testing.assert_array_equal(frames[0], imgs[0])
    slam = run_stream.main([os.path.join(d, "settings.yaml"),
                            os.path.join(d, "rgb"), "--ar", "--out",
                            str(tmp_path / "ov"), "--max-frames", str(n),
                            "--metrics", str(tmp_path / "m.jsonl"),
                            "--save-traj", str(tmp_path / "t.txt"),
                            "--device", "cpu"])
    assert slam.tracking.state == "OK" and len(slam.tracking.metrics) == n
    rows = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert [r["frame_id"] for r in rows] == list(range(n))
    assert len(os.listdir(tmp_path / "ov")) == n
    assert len(np.loadtxt(tmp_path / "t.txt", ndmin=2)) >= n - 3
