"""The configurations load to their published values, and BENCHMARK.json
keeps to the benchmark's contract."""
import json
import math
import os
import re

import pytest
from ar_orbslam2_tpu_torch.utils.config import load_settings

from slambench.catalog import ROOT, Catalog

PUBLISHED = {
    "tum1_mono": dict(fx=517.306408, fy=516.469215, cx=318.643040,
                      cy=255.313989, k1=0.262383, k2=-0.953104,
                      p1=-0.005358, p2=0.002628, k3=1.163314, fps=30.0,
                      width=640, height=480),
    "euroc_mono": dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375,
                       k1=-0.28340811, k2=0.07395907, p1=0.00019359,
                       p2=1.76187114e-05, k3=0.0, fps=20.0, width=752,
                       height=480),
}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_config_loads_to_its_published_values(name):
    cat = Catalog()
    cfg = cat.config(name)
    st = load_settings(cfg["settings_path"], cfg["image"]["width"],
                       cfg["image"]["height"])
    want = PUBLISHED[name]
    for k in ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3",
              "width", "height"):
        assert getattr(st.camera, k) == pytest.approx(want[k], abs=0), k
    assert st.fps == want["fps"]
    assert (st.n_features, st.scale_factor, st.n_levels, st.ini_th_fast,
            st.min_th_fast) == (1000, 1.2, 8, 20, 7)
    assert st.camera.has_distortion
    assert cfg["reduced"] == []
    # every system choice the file states is one the harness passes on
    assert set(cfg["system"]) == {"sensor", "async_mapping", "enable_loops",
                                  "chunk"}


def _text_ok(s, n=200):
    return isinstance(s, str) and 1 <= len(s) <= n and "\n" not in s \
        and "\t" not in s


def test_benchmark_json_keeps_to_the_contract():
    path = os.path.join(ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    with open(path) as f:
        b = json.load(f)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(b["command"]) <= 32 and all(map(_text_ok, b["command"]))
    assert b["paths"] == ["slambench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    cells = len(b["workloads"])
    # a full check of 24 cells fits in 43200 s
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    names = set()
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _text_ok(c["source"])
        assert _text_ok(c["why"])
        assert c["file"].startswith("slambench/") and os.path.exists(
            os.path.join(ROOT, c["file"]))
        assert c["name"] in used and len(c["reduced"]) <= 16
        names.add(c["name"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _text_ok(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(ROOT, "slambench", "traffic",
                                           w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(ROOT, "slambench", "limits",
                                           w["name"] + ".json"))
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(
        1, math.floor(cells * 0.25))
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    layers = {}
    cell_names = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m["workloads"]) <= cell_names and _text_ok(m["layer"])
        assert os.path.exists(os.path.join(ROOT, "slambench", "metrics",
                                           m["name"] + ".py"))
        layers.setdefault(m["layer"], set()).add(m["name"])
    every = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(every) == len(set(every)) and all(map(NAME.match, every))
    for w in b["workloads"]:
        assert any(w["name"] in m["workloads"] for m in b["per_layer"])
