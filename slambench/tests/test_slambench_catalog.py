"""A new configuration, traffic mix and per-layer metric are found by
name as new files and entries, with no existing file edited."""
import hashlib
import json
import os
from types import SimpleNamespace

from slambench import bench
from slambench.catalog import ROOT


def _digest():
    h = hashlib.sha256()
    for d, _, files in sorted(os.walk(os.path.join(ROOT, "slambench"))):
        if "__pycache__" in d:
            continue
        for f in sorted(files):
            with open(os.path.join(d, f), "rb") as fh:
                h.update(f.encode() + fh.read())
    return h.hexdigest()


def test_new_files_are_found_by_name(tiny):
    before = _digest()
    cat, base = tiny
    with open(os.path.join(base, "metrics", "frames_seen.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx.frames)\n")
    with open(cat.benchmark_path) as f:
        bm = json.load(f)
    bm["per_layer"].append(dict(
        name="frames_seen", unit="frames", better="higher",
        source="program_counter", layer="tracking state machine",
        moves="track_fps", workloads=["tiny_mono.tiny_sway"]))
    with open(cat.benchmark_path, "w") as f:
        json.dump(bm, f)
    from slambench.catalog import Catalog
    cat = Catalog(cat.benchmark_path, base=base)
    cell = bench.load_cell("tiny_mono.tiny_sway", cat)
    assert cell.settings.camera.width == 320
    assert cell.traffic["name"] == "tiny_sway"
    assert "numbers" in cell.limits
    out = dict(records=[], spans=[], summary=None, roofline=None,
               attempted=17, timing=[])
    got = bench.per_layer("tiny_mono.tiny_sway", out, cat)
    assert got["frames_seen"] == {"value": 17.0, "unit": "frames"}
    assert cat.reader("frames_seen")(SimpleNamespace(frames=3)) == 3.0
    assert _digest() == before


STILL = """import numpy as np
from slambench.scenes import look_at


def poses(path, n, cam):
    R, t = look_at(path["eye"], path["target"])
    return np.stack([R] * n), np.stack([t] * n)
"""

PLANE = """import numpy as np
import torch
from slambench.scenes import make_textures, seed64


class Scene:
    \"\"\"One textured wall x = at_m, facing the camera.\"\"\"

    def __init__(self, spec, seed, centres, device):
        self.x = float(spec["at_m"])
        self.texel = float(spec["texel_m"])
        self.th = self.tw = 64
        self.textures = make_textures([seed64(seed, 9)], 64, 64, device)

    def distance(self, p):
        return np.abs(np.asarray(p, np.float64)[:, 0] - self.x)

    def hit(self, eye, d):
        e = eye[:, None, None, :]
        p = e + d * ((self.x - e[..., 0]) / d[..., 0])[..., None]
        face = torch.zeros(p.shape[:-1], dtype=torch.long, device=d.device)
        return face, p[..., 1] / self.texel + 32, p[..., 2] / self.texel + 32
"""


def test_a_new_path_and_scene_kind_are_found_by_name(tiny):
    """A motion or a scene that no file has yet is a new file under
    ``path_kinds/`` or ``scene_kinds/`` and a traffic mix that names it;
    scenes.py and every other existing file stay as they are."""
    import numpy as np

    from slambench import scenes
    before = _digest()
    cat, base = tiny
    with open(os.path.join(base, "path_kinds", "still.py"), "w") as f:
        f.write(STILL)
    with open(os.path.join(base, "scene_kinds", "plane.py"), "w") as f:
        f.write(PLANE)
    traffic = dict(name="stare", scene=dict(kind="plane", at_m=2.0,
                                            texel_m=0.02),
                   path=dict(kind="still", eye=[0.0, 0.0, 0.0],
                             target=[2.0, 0.0, 0.0]),
                   init_frames_max=8, setup_frames_after_init=0,
                   render_fps=8)
    with open(os.path.join(base, "traffic", "stare.json"), "w") as f:
        json.dump(traffic, f)
    cell = bench.load_cell("tiny_mono.tiny_sway", cat)
    seq = scenes.render(cat.traffic("stare"), cell.settings.camera, 2, 7,
                        "cpu", base=cell.base)
    assert seq.images.shape == (2, 240, 320)
    assert np.array_equal(seq.R_cw[0], seq.R_cw[1])
    assert seq.images.std() > 5.0            # the wall's texture shows
    assert _digest() == before
