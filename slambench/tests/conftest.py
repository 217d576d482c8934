"""Shared fixtures of the benchmark's CPU tests: a throwaway catalog in a
temporary directory holding a tiny cell (a 320x240 camera with the TUM1
distortion, 512 keypoints) beside copies of the real files."""
from __future__ import annotations

import json
import os
import shutil
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BENCH = os.path.join(ROOT, "slambench")

TINY_YAML = """%YAML:1.0
Camera.fx: 258.653204
Camera.fy: 258.234608
Camera.cx: 159.32152
Camera.cy: 127.656995
Camera.k1: 0.262383
Camera.k2: -0.953104
Camera.p1: -0.005358
Camera.p2: 0.002628
Camera.k3: 1.163314
Camera.fps: 30.0
Camera.RGB: 1
ORBextractor.nFeatures: 500
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_catalog(tmp):
    """A copy of the benchmark's data files plus the tiny cell
    ``tiny_mono.xyz_sway``; returns (Catalog, base directory)."""
    from slambench.catalog import Catalog
    base = os.path.join(tmp, "bench")
    for sub in ("configs", "traffic", "limits", "metrics", "path_kinds",
                "scene_kinds"):
        shutil.copytree(os.path.join(BENCH, sub), os.path.join(base, sub))
    with open(os.path.join(base, "configs", "tiny_mono.yaml"), "w") as f:
        f.write(TINY_YAML)
    with open(os.path.join(BENCH, "configs", "tum1_mono.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny_mono", settings="tiny_mono.yaml",
               image=dict(width=320, height=240, source="test"))
    with open(os.path.join(base, "configs", "tiny_mono.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(BENCH, "traffic", "xyz_sway.json")) as f:
        traffic = json.load(f)
    traffic.update(name="tiny_sway", setup_frames_after_init=0,
                   render_fps=16, init_frames_max=48)
    with open(os.path.join(base, "traffic", "tiny_sway.json"), "w") as f:
        json.dump(traffic, f)
    shutil.copy(os.path.join(BENCH, "limits", "tum1_mono.xyz_sway.json"),
                os.path.join(base, "limits", "tiny_mono.tiny_sway.json"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bm = json.load(f)
    bm["workloads"].append(dict(name="tiny_mono.tiny_sway",
                                config="tiny_mono", traffic="tiny_sway",
                                chips=1, why="test"))
    for m in bm["per_layer"]:
        if "tum1_mono.xyz_sway" in m.get("workloads", []):
            m["workloads"].append("tiny_mono.tiny_sway")
    path = os.path.join(base, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bm, f)
    return Catalog(path, base=base), base


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_catalog(str(tmp_path_factory.mktemp("catalog")))
