"""The port's apps end to end on the CPU, at a small size: nFeatures 500
(512 padded keypoints), 32 frames of the rendered plane sweep at 640x480
written as a TUM directory with its ground truth.

- run_eval tum exits 0 under a 0.05 m gate (PERF.md §2's limit) and
  writes both trajectories;
- recall_study.run_study equals the JAX package's exactly.

run_ar and run_stream on the same directory are in
tests/test_torch_apps_ar.py (split so that the two run on two test
workers).
"""
import os

import numpy as np
import pytest
import torch

from ar_orbslam2_tpu.loop import recall_study as jrecall
from ar_orbslam2_tpu_torch.apps import run_eval
from ar_orbslam2_tpu_torch.core.camera import Camera
from ar_orbslam2_tpu_torch.data import datasets, synthetic
from ar_orbslam2_tpu_torch.loop import recall_study
from ar_orbslam2_tpu_torch.utils.config import write_settings

N_FRAMES = 32
ATE_GATE = 0.05
CAM = Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tum_sequence(root):
    """The rendered plane sweep written under `root` as a TUM directory
    with its settings: (directory, images, R_cw, t_cw)."""
    imgs, R_cw, t_cw = synthetic.render_plane_sequence(
        CAM, n_frames=N_FRAMES, seed=0, motion=0.25)
    d = str(root / "seq")
    datasets.write_tum_sequence(d, imgs, R_cw, t_cw)
    write_settings(os.path.join(d, "settings.yaml"), CAM, n_features=500)
    return d, imgs, R_cw, t_cw


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    return tum_sequence(tmp_path_factory.mktemp("tum"))


def test_run_eval_tum_passes_its_gate(seq, tmp_path):
    d, _, _, _ = seq
    out = str(tmp_path / "eval")
    res = run_eval.run(["tum", os.path.join(d, "settings.yaml"), d,
                        "--gate-ate", str(ATE_GATE), "--out", out,
                        "--device", "cpu", "--no-precompile"])
    assert res["code"] == 0, res
    assert res["ate"] < ATE_GATE and res["n_eval"] >= 0.9 * N_FRAMES
    for suffix in ("_tum.txt", "_kitti.txt", "_kf_tum.txt",
                   "_metrics.jsonl"):
        assert os.path.getsize(out + suffix) > 0, suffix
    assert len(np.loadtxt(out + "_kitti.txt", ndmin=2)) == res["n_eval"]
    # a fused run: chunks of 8 after init
    assert sum(1 for r in res["slam"].tracking.metrics
               if r.get("chunked")) >= N_FRAMES // 2
    with pytest.raises(SystemExit) as e:
        run_eval.main(["tum", os.path.join(d, "settings.yaml"), d,
                       "--gate-ate", "0.0", "--out", out, "--device", "cpu",
                       "--no-precompile", "--max-frames", "16"])
    assert e.value.code == 1


@pytest.mark.parametrize("keep,flip", [(0.4, 0.08), (0.25, 0.15)])
def test_recall_study_matches_jax(keep, flip):
    kw = dict(n_places=50, n_queries=10, n_words=512, bit_flip=flip,
              keep_frac=keep)
    port = recall_study.run_study(device="cpu", **kw)
    ref = jrecall.run_study(**kw)
    for got, want in zip(port, ref):
        ranks = got.pop("ranks")
        assert got == want
        assert len(ranks) == kw["n_queries"]
        assert np.mean(ranks) == want["mean_rank"]


def test_recall_study_table(tmp_path, capsys):
    path = tmp_path / "recall.md"
    recall_study.main(["--places", "20", "--queries", "5", "--words", "256",
                       "--out", str(path), "--device", "cpu"])
    table = path.read_text().splitlines()
    assert sum(1 for line in table if line.startswith("| ")) == 1 + 6
    assert "recall@1" in capsys.readouterr().out
