"""The port's stereo frontend (frontend/stereo.py) against the JAX package
on the CPU.

Inputs are made from a seed with numpy and go through the JAX function
(jit) and the port's (CPU tensors). Tolerances:
  * match_stereo: indices and right-u exact (integer Hamming distances from
    an exact float32 matmul, first-index ties in both);
  * refine_stereo_subpixel: <= 1e-5 px (every SAD is an exact integer in
    float32; the parabola step is one float32 division in both);
  * stereo_frame_features on a rendered 640x480 pair: right-u <= 1e-5 px
    and depth <= 1e-5 relative, on the JAX package's own ORB extraction
    handed to both (ORB parity is tests/test_torch_orb.py's: its pyramid
    resize differs in the last bits, so the keypoint sets differ by a few);
  * the renderers behind the stereo and localization tests draw bit for
    bit what the JAX package's draw.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ar_orbslam2_tpu.core.camera import Camera as JCamera
from ar_orbslam2_tpu.data import synthetic as jsyn
from ar_orbslam2_tpu.frontend import stereo as JS
from ar_orbslam2_tpu.mapstore.map import MapConfig as JMapConfig
from ar_orbslam2_tpu.ops import hamming as JH
from ar_orbslam2_tpu.system.slam import SlamConfig as JSlamConfig
from ar_orbslam2_tpu.system.slam import SlamSystem as JSlamSystem
from ar_orbslam2_tpu.system.tracking import TrackingConfig as JTrackingConfig
from ar_orbslam2_tpu_torch.core.camera import Camera
from ar_orbslam2_tpu_torch.data import synthetic as tsyn
from ar_orbslam2_tpu_torch.frontend import stereo as TS
from ar_orbslam2_tpu_torch.mapstore.map import MapConfig
from ar_orbslam2_tpu_torch.ops import hamming as TH
from ar_orbslam2_tpu_torch.system.slam import SlamConfig, SlamSystem
from ar_orbslam2_tpu_torch.system.tracking import TrackingConfig

KW = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480,
          bf=50.0)
CAM, JCAM = Camera(**KW), JCamera(**KW)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The port's stages are chains of small ops: more intra-op threads buy
    nothing and fight the other test workers for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _stereo_inputs(seed, n=700, m=650):
    """Left/right keypoints of a rectified pair: most right keypoints are
    a left one shifted by a disparity (with row jitter, flipped descriptor
    bits, a neighbouring octave), the rest are clutter; some invalid."""
    rng = np.random.default_rng(seed)
    uv_l = rng.uniform([0, 0], [640, 480], (n, 2)).astype(np.float32)
    bits_l = rng.integers(0, 2, (n, 256)).astype(np.uint8)
    oct_l = rng.integers(0, 8, n).astype(np.int32)
    src = rng.choice(n, m, replace=False)
    disp = rng.uniform(-2.0, 80.0, m)
    uv_r = np.stack([uv_l[src, 0] - disp,
                     uv_l[src, 1] + rng.normal(0, 1.5, m)], -1)
    clutter = rng.random(m) < 0.2
    uv_r[clutter] = rng.uniform([0, 0], [640, 480], (clutter.sum(), 2))
    flips = rng.random((m, 256)) < rng.uniform(0.0, 0.35, (m, 1))
    bits_r = np.where(flips, 1 - bits_l[src], bits_l[src]).astype(np.uint8)
    oct_r = np.clip(oct_l[src] + rng.integers(-2, 3, m), 0, 7).astype(
        np.int32)
    valid_l = rng.random(n) > 0.05
    valid_r = rng.random(m) > 0.05
    return (uv_l, bits_l, oct_l, valid_l, uv_r.astype(np.float32), bits_r,
            oct_r, valid_r)


@pytest.mark.parametrize("seed", [0, 1])
def test_match_stereo_matches_jax(seed):
    uv_l, bits_l, oct_l, vl, uv_r, bits_r, oct_r, vr = _stereo_inputs(seed)
    want_uvr, want_idx = JS.match_stereo(
        jnp.asarray(uv_l), JH.to_signs(bits_l), jnp.asarray(oct_l),
        jnp.asarray(vl), jnp.asarray(uv_r), JH.to_signs(bits_r),
        jnp.asarray(oct_r), jnp.asarray(vr), 64.0)
    t = torch.as_tensor
    got_uvr, got_idx = TS.match_stereo(
        t(uv_l), TH.to_signs(bits_l), t(oct_l), t(vl), t(uv_r),
        TH.to_signs(bits_r), t(oct_r), t(vr), 64.0)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_uvr.numpy(), np.asarray(want_uvr))
    assert (got_idx.numpy() >= 0).sum() > 100      # a real matching


def _textured_pair(seed, shift=17.3):
    """A smooth random texture and the same texture moved left by `shift`
    pixels (bilinear), with a little noise: a rectified pair of a plane."""
    rng = np.random.default_rng(seed)
    h, w = 480, 640
    base = rng.random((h // 8 + 2, w // 8 + 2))
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)

    def sample(x, y):
        gx, gy = x / 8.0, y / 8.0
        x0, y0 = np.floor(gx).astype(int), np.floor(gy).astype(int)
        fx, fy = gx - x0, gy - y0
        x0 = np.clip(x0, 0, base.shape[1] - 2)
        y0 = np.clip(y0, 0, base.shape[0] - 2)
        return ((1 - fx) * (1 - fy) * base[y0, x0]
                + fx * (1 - fy) * base[y0, x0 + 1]
                + (1 - fx) * fy * base[y0 + 1, x0]
                + fx * fy * base[y0 + 1, x0 + 1])
    left = sample(xs, ys)
    right = sample(xs + shift, ys)
    noise = rng.normal(0, 0.01, (2, h, w))
    to_u8 = lambda a: np.clip(a * 255.0, 0, 255).astype(np.uint8)   # noqa
    return to_u8(left + noise[0]), to_u8(right + noise[1])


def test_refine_stereo_subpixel_matches_jax():
    left, right = _textured_pair(3)
    rng = np.random.default_rng(4)
    n = 800
    uv = rng.uniform([-4, -4], [644, 484], (n, 2)).astype(np.float32)
    # matched right-u near the true one (+-3 px, some far off), unmatched
    # (-1) and invalid keypoints, and keypoints on the borders
    uvr = (uv[:, 0] - 17.3 + rng.normal(0, 1.5, n)).astype(np.float32)
    uvr[rng.random(n) < 0.1] = -1.0
    uvr[:20] = rng.uniform(0, 640, 20)
    valid = rng.random(n) > 0.1
    want = np.asarray(JS.refine_stereo_subpixel(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(uv),
        jnp.asarray(uvr), jnp.asarray(valid)))
    t = torch.as_tensor
    got = TS.refine_stereo_subpixel(t(left), t(right), t(uv), t(uvr),
                                    t(valid)).numpy()
    np.testing.assert_array_equal(got < 0, want < 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    refined = (want > 0) & (want != uvr)
    assert refined.sum() > 300                     # the step was taken


def _systems():
    jcfg = JSlamConfig(sensor="STEREO", map=JMapConfig(
        max_keyframes=8, max_map_points=5000, max_kp=1024),
        tracking=JTrackingConfig(max_kp=1024), enable_loop_closing=False,
        enable_relocalization=False)
    tcfg = SlamConfig(sensor="STEREO", map=MapConfig(
        max_keyframes=8, max_map_points=5000, max_kp=1024),
        tracking=TrackingConfig(max_kp=1024), enable_loop_closing=False,
        enable_relocalization=False)
    return JSlamSystem(JCAM, jcfg), SlamSystem(CAM, tcfg, device="cpu")


@pytest.fixture(scope="module")
def rendered_pair():
    left, right, R_cw, t_cw = tsyn.render_stereo_plane_sequence(
        CAM, n_frames=1, seed=4, motion=0.0)
    return left[0], right[0], R_cw[0], t_cw[0]


def test_stereo_frame_features_matches_jax(rendered_pair):
    left, right, _, _ = rendered_pair
    jslam, tslam = _systems()
    orb, extract = {}, jslam._extract

    def jax_orb(img):           # the JAX extraction, for both packages
        key = img.tobytes()
        if key not in orb:
            orb[key] = {k: np.asarray(v) for k, v in extract(img).items()}
        return orb[key]
    jslam._extract = jax_orb
    tslam._extract = jax_orb
    jf, juvr, jdepth = JS.stereo_frame_features(jslam, left, right)
    tf, tuvr, tdepth = TS.stereo_frame_features(tslam, left, right)
    for k in jf:
        np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)
    np.testing.assert_array_equal(tuvr < 0, juvr < 0)
    np.testing.assert_allclose(tuvr, juvr, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tdepth < 0, jdepth < 0)
    good = jdepth > 0
    assert good.sum() > 300
    np.testing.assert_allclose(tdepth[good], jdepth[good], rtol=1e-5)


def test_port_stereo_depth_on_its_own_orb(rendered_pair):
    """The port end to end (its own ORB): depth against the plane's true
    depth, with tests/test_stereo_image_e2e.py's gate (median error below
    8 cm, and the subpixel pass no worse than integer disparities)."""
    left, right, R, t = rendered_pair
    _, tslam = _systems()
    errs = {}
    for sub in (False, True):
        feats, uvr, depth = TS.stereo_frame_features(tslam, left, right,
                                                     subpixel=sub)
        good = depth > 0
        assert good.sum() > 100
        uv = feats["uv"][good]
        rays = np.stack([(uv[:, 0] - CAM.cx) / CAM.fx,
                         (uv[:, 1] - CAM.cy) / CAM.fy,
                         np.ones(len(uv))], -1)
        z_gt = (3.0 + (R.T @ t)[2]) / (rays @ R)[:, 2]
        errs[sub] = np.abs(depth[good] - z_gt)
    assert np.median(errs[True]) <= np.median(errs[False]) * 1.05
    assert np.median(errs[True]) < 0.08


def test_synthetic_draws_match_jax():
    """The stereo renderer and the forward feature scene (with a box and a
    speed, as tests/test_localization_vo.py builds it) draw bit for bit
    what the JAX package's do."""
    small = dict(fx=125.0, fy=125.0, cx=80.0, cy=60.0, width=160,
                 height=120, bf=12.5)
    want = jsyn.render_stereo_plane_sequence(JCamera(**small), n_frames=3,
                                             seed=2, tex_size=256,
                                             motion=0.4)
    got = tsyn.render_stereo_plane_sequence(Camera(**small), n_frames=3,
                                            seed=2, tex_size=256, motion=0.4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    kw = dict(n_landmarks=500, n_frames=12, seed=5, trajectory="forward",
              box=((-4.0, -3.0, 0.0), (4.0, 3.0, 26.0)), speed=0.35)
    js, ts = jsyn.make_scene(**kw), tsyn.make_scene(**kw)
    for name in ("landmarks", "desc_bits", "R_cw", "t_cw", "timestamps"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name),
                                      err_msg=name)
    jo = jsyn.observe_frame(js, 7, JCamera(**small), max_kp=64,
                            noise_px=0.3, bit_flip=0.02)
    to = tsyn.observe_frame(ts, 7, Camera(**small), max_kp=64,
                            noise_px=0.3, bit_flip=0.02)
    assert jo.keys() == to.keys()
    for k in jo:
        np.testing.assert_array_equal(to[k], jo[k], err_msg=k)
