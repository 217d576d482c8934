"""The traffic generator: deterministic from the seed, and the truth it
keeps is where the images show the scene."""
import numpy as np
import pytest
import torch
from ar_orbslam2_tpu_torch.core.camera import Camera

from slambench import scenes
from slambench.reference import geometry as G

CAM = Camera(fx=129.3, fy=129.1, cx=79.7, cy=63.8, k1=0.262383,
             k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314,
             width=160, height=120)
BOX = {"scene": {"kind": "box", "lo": [-3, -3, 0], "hi": [3, 3, 3],
                 "texel_m": 0.03},
       "path": {"kind": "lissajous", "center": [0.5, 0, 1.5],
                "look_at": [3, 0, 1.5],
                "amplitude_m": {"lateral": 0.3, "vertical": 0.15,
                                "depth": 0.2},
                "period_frames": {"lateral": 120, "vertical": 90,
                                  "depth": 150}}}
CORRIDOR = {"scene": {"kind": "corridor", "width_m": 3.0, "height_m": 3.0,
                      "segment_m": 2.0, "texel_m": 0.03,
                      "view_reach_m": 12.0},
            "path": {"kind": "traverse", "start": [0, 0, 1.5],
                     "direction": [1, 0, 0], "facing": [0, 1, 0],
                     "distance_m": 1.5, "px_per_frame": 12.0,
                     "yaw_deg": 10.0, "yaw_period_frames": 100}}


def test_render_is_deterministic_from_the_seed():
    a = scenes.render(BOX, CAM, 3, 2 ** 31 + 7, "cpu")
    b = scenes.render(BOX, CAM, 3, 2 ** 31 + 7, "cpu")
    c = scenes.render(BOX, CAM, 3, 2 ** 31 + 8, "cpu")
    assert a.images.dtype == np.uint8 and a.images.shape == (3, 120, 160)
    assert np.array_equal(a.images, b.images)
    assert np.array_equal(a.R_cw, b.R_cw)
    assert (a.images != c.images).mean() > 0.5
    assert np.array_equal(a.R_cw, c.R_cw)      # the path is the traffic's


def test_corridor_segments_do_not_depend_on_the_length():
    a = scenes.render(CORRIDOR, CAM, 4, 99, "cpu")
    b = scenes.render(CORRIDOR, CAM, 12, 99, "cpu")
    assert np.array_equal(a.images, b.images[:4])


def test_each_frame_gets_fresh_noise():
    seq = scenes.render(BOX, CAM, 2, 5, "cpu")
    still = dict(BOX, path=dict(BOX["path"], amplitude_m=dict(
        lateral=0.0, vertical=0.0, depth=0.0)))
    seq = scenes.render(still, CAM, 2, 5, "cpu")
    diff = seq.images[0].astype(int) - seq.images[1].astype(int)
    assert np.array_equal(seq.R_cw[0], seq.R_cw[1])
    assert 0.5 < diff.std() < 4.0


def _wall_points(seq, frame):
    """Points on the wall x = 3 and the texture's grey there."""
    sc = seq.scene
    rng = np.random.default_rng(0)
    y = rng.uniform(-1.0, 1.0, 400)
    z = rng.uniform(0.8, 2.2, 400)
    pts = np.stack([np.full_like(y, 3.0), y, z], -1)
    a = (y - sc.lo[1]) / sc.texel - 0.5
    b = (z - sc.lo[2]) / sc.texel - 0.5
    grid = torch.tensor(np.stack([(a + 0.5) / sc.tw * 2 - 1,
                                  (b + 0.5) / sc.th * 2 - 1], -1),
                        dtype=torch.float32)[None, None]
    tex = sc.textures[1][None, None]
    grey = torch.nn.functional.grid_sample(tex, grid, align_corners=False)
    return pts, grey[0, 0, 0].numpy()


def test_a_wall_point_projects_where_the_truth_says():
    seq = scenes.render(BOX, CAM, 1, 3, "cpu")
    pts, grey = _wall_points(seq, 0)
    R, t = seq.R_cw[0], seq.t_cw[0]
    xc = pts @ R.T + t
    und = np.stack([CAM.fx * xc[:, 0] / xc[:, 2] + CAM.cx,
                    CAM.fy * xc[:, 1] / xc[:, 2] + CAM.cy], -1)
    img = seq.images[0].astype(np.float64)

    def err(shift):
        raw = G.distort_px(CAM, und) + shift
        inside = ((raw >= 2) & (raw < [CAM.width - 3, CAM.height - 3])).all(1)
        u, v = np.rint(raw[inside]).astype(int).T
        return np.abs(img[v, u] - grey[inside]).mean(), inside.sum()

    e0, n = err(0.0)
    e_off, _ = err(np.array([4.0, 3.0]))
    assert n > 200
    assert e0 < 3.0 and e_off > 3 * e0


@pytest.mark.parametrize("traffic", ["xyz_sway", "wall_walk"])
def test_the_stated_motion_is_the_paths(traffic):
    """A mix's ``as_run`` figures, set beside the dataset's published
    ones, are what its path does under each configuration."""
    from ar_orbslam2_tpu_torch.utils.config import load_settings

    from slambench.catalog import Catalog, load
    cat = Catalog()
    t = cat.traffic(traffic)
    stated = {k: v for k, v in t["as_run"].items() if k != "note"}
    assert stated and set(t["published"]) >= {"source", "speed_m_s",
                                              "turn_deg_s"}
    for name, want in stated.items():
        cfg = cat.config(name)
        st = load_settings(cfg["settings_path"], cfg["image"]["width"],
                           cfg["image"]["height"])
        n = int(30 * st.fps)
        R, tt = load("path_kinds", t["path"]["kind"]).poses(
            t["path"], n, st.camera)
        got = scenes.motion(R, tt, st.fps)
        assert got["speed_m_s"] == pytest.approx(want["speed_m_s"], abs=1e-3)
        assert got["turn_deg_s"] == pytest.approx(want["turn_deg_s"],
                                                  abs=1e-3)
        assert got["extent_m"] == pytest.approx(want["extent_m"], abs=1e-3)
