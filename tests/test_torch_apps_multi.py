"""The port's run_multi on the CPU: two rendered sequences interleaved
chunk by chunk through two SlamSystems (nFeatures 500: 512 padded
keypoints; 16 frames each at 640x480: two chunks of 8 each, so the
systems alternate chunk by chunk and each runs a fused chunk).

The JAX package's gates (tests/test_run_multi.py): > 60 % of each
sequence's frames tracked, >= 2 keyframes each, two distinct stores. And
the states stay apart: the second sequence, run alone through a system of
its own, gives the same trajectory and the same map, exactly.
"""
import os

import numpy as np
import pytest
import torch

from ar_orbslam2_tpu_torch.apps import run_multi
from ar_orbslam2_tpu_torch.apps.common import build_system
from ar_orbslam2_tpu_torch.core.camera import Camera
from ar_orbslam2_tpu_torch.utils.config import load_settings, write_settings

N_FRAMES = 16
CAM = Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_two_sequences_interleaved_stay_apart(tmp_path):
    settings = str(tmp_path / "settings.yaml")
    write_settings(settings, CAM, n_features=500)
    prefix = str(tmp_path / "traj_")
    out = run_multi.main([settings, "--synthetic", "2", "--frames",
                          str(N_FRAMES), "--chunk", "8", "--out-prefix",
                          prefix, "--device", "cpu"])
    sources, systems = out["sources"], out["systems"]
    assert [s["name"] for s in sources] == ["synthetic0", "synthetic1"]
    for src, slam in zip(sources, systems):
        ok = sum(1 for m in slam.tracking.metrics if m.get("ok"))
        assert ok > 0.6 * len(src["frames"]), (src["name"], ok)
        assert slam.store.n_keyframes() >= 2
        assert sum(1 for m in slam.tracking.metrics if m.get("fused")) \
            >= N_FRAMES // 2
        assert os.path.getsize(f"{prefix}{src['name']}.txt") > 0
    assert systems[0].store is not systems[1].store
    assert out["fps"] > 0

    # the second sequence alone, in a system of its own
    alone = build_system(load_settings(settings), sensor="MONOCULAR",
                         device="cpu")
    src = sources[1]
    for i in range(0, N_FRAMES, 8):
        alone.track_monocular_batch(src["frames"][i:i + 8],
                                    timestamps=src["ts"][i:i + 8], chunk=8)
    alone.shutdown()
    mixed = systems[1]
    for a, b in zip(alone.frame_trajectory(), mixed.frame_trajectory()):
        np.testing.assert_array_equal(a, b)
    for name in ("kf_valid", "kf_R", "kf_t", "mp_valid", "mp_pos", "kf_mp"):
        np.testing.assert_array_equal(getattr(alone.store, name),
                                      getattr(mixed.store, name),
                                      err_msg=name)
