"""Parity of the port's ORB extraction (frontend/orb.py) with the JAX
package on a rendered 640x480 frame.

Tolerances and why:
  * pyramid resize: jax.image.resize("linear") and F.interpolate(bilinear,
    antialias=True) apply the same triangle filter but compute and sum its
    weights in another order — 2e-3 grey levels (0..255 scale) bounds it;
  * orientation: the intensity-centroid moments are sums over ~700 pixels
    taken in another order — 1e-2 degrees;
  * everything else on a level (keypoints, responses, descriptors) is
    compared exactly, and the full extraction must agree on >= 99% of its
    keypoints.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ar_orbslam2_tpu.core.camera import Camera
from ar_orbslam2_tpu.data import synthetic
from ar_orbslam2_tpu.frontend import orb as JO
from ar_orbslam2_tpu_torch.frontend import orb as TO

CAM = Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)
JCFG = JO.OrbConfig(n_features=1024)
TCFG = TO.OrbConfig(n_features=1024)


@pytest.fixture(scope="module")
def image():
    imgs, _, _ = synthetic.render_plane_sequence(CAM, n_frames=2, seed=0,
                                                 motion=0.5)
    return imgs[1]


@pytest.fixture(scope="module")
def level2(image):
    shapes = JO.level_shapes(480, 640, JCFG)
    lvl = jnp.asarray(image, jnp.float32)
    for s in shapes[1:3]:
        lvl = jax.image.resize(lvl, s, "linear")
    return np.asarray(lvl)


def _features(img_f, quota):
    got = TO._level_features(torch.as_tensor(np.array(img_f)), quota, TCFG)
    want = jax.jit(lambda x: JO._level_features(x, quota, JCFG))(
        jnp.asarray(img_f))
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("which", ["level0", "level2"])
def test_level_features_match(image, level2, which):
    img_f = image.astype(np.float32) if which == "level0" else level2
    got, want = _features(img_f, 222 if which == "level0" else 154)
    names = ("ys", "xs", "response", "angle", "desc", "valid")
    for name, g, w in zip(names, got, want):
        if name == "angle":
            np.testing.assert_allclose(g, w, atol=1e-2, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)
    assert got[5].sum() > 100


def test_resize_matches_jax_within_tolerance(image):
    shapes = JO.level_shapes(480, 640, JCFG)
    lj = jnp.asarray(image, jnp.float32)
    lt = torch.as_tensor(image).float()
    for s in shapes[1:]:
        lj = jax.image.resize(lj, s, "linear")
        lt = TO.resize_level(lt, s)
        assert tuple(lt.shape) == s
        assert float(np.abs(np.asarray(lj) - lt.numpy()).max()) < 2e-3


def test_extract_orb_agrees_on_keypoints(image):
    want = {k: np.asarray(v) for k, v in
            JO.extract_orb(jnp.asarray(image), JCFG).items()}
    got = {k: v.numpy() for k, v in
           TO.extract_orb(torch.as_tensor(image), TCFG).items()}
    for k in want:
        assert got[k].shape == want[k].shape, k

    def keys(f):
        v = f["valid"]
        return set(map(tuple, np.c_[f["uv"][v], f["octave"][v]].tolist()))
    kw, kg = keys(want), keys(got)
    assert len(kw & kg) >= 0.99 * len(kw)
    same = np.all(got["uv"] == want["uv"], 1) & (got["valid"] == want["valid"])
    assert same.mean() >= 0.99
    # where a slot holds the same keypoint, its descriptor is the same
    desc_eq = (got["desc_bits"][same] == want["desc_bits"][same]).all(1)
    assert desc_eq.mean() >= 0.99
