"""The plain references: the ORB reference follows the port's extractor
on a rendered frame, and its bfloat16 control does not (the control test,
at a size a test run holds); the resampling filter is PyTorch's
antialiased bilinear; the similarity fit recovers a known one."""
import numpy as np
import pytest
import torch
from ar_orbslam2_tpu_torch.frontend.orb import OrbConfig, extract_orb

from slambench import scenes
from slambench.reference import check as CHK
from slambench.reference import geometry as G
from slambench.reference import orb as ORB
from test_slambench_scenes import BOX, CAM

PARAMS = dict(n_features=512, scale_factor=1.2, n_levels=8, ini_th=20,
              min_th=7)
BIG = CAM._replace(fx=258.65, fy=258.23, cx=159.32, cy=127.66, width=320,
                   height=240)


@pytest.mark.parametrize("shape,out", [((240, 320), (200, 267)),
                                       ((97, 131), (81, 109))])
def test_resize_is_antialiased_bilinear(shape, out):
    img = torch.rand(shape, dtype=torch.float64) * 255
    want = torch.nn.functional.interpolate(
        img[None, None], size=out, mode="bilinear", align_corners=False,
        antialias=True)[0, 0]
    assert torch.allclose(ORB.resize(img, out), want, atol=1e-9)


@pytest.fixture(scope="module")
def frame():
    box = dict(BOX, scene=dict(BOX["scene"], texel_m=0.012))
    return scenes.render(box, BIG, 2, 7, "cpu")


def _program(image):
    f = extract_orb(torch.as_tensor(image), OrbConfig(n_features=512))
    v = f["valid"].numpy()
    uv = f["uv"].numpy()[v].astype(np.float64)    # raw pixels
    return dict(uv=uv, octave=f["octave"].numpy()[v],
                desc=f["desc_bits"].numpy()[v])


def test_port_orb_agrees_with_the_reference(frame):
    img = frame.images[1]
    prog = _program(img)
    ref = ORB.extract(img, **PARAMS)
    keys = CHK.raw_keys(prog["uv"], prog["octave"], 1.2)
    diff, total = CHK.orb_mismatch(keys, prog["desc"], ref, 1.2)
    assert total >= 256 * 400
    assert 100 * diff / total < 1.0


def test_bf16_control_fails_the_orb_number(frame):
    """The reference in bfloat16 in the program's place reads far above
    the program's reading and above the cells' limit."""
    from slambench.catalog import Catalog
    limit = Catalog().limits("tum1_mono.xyz_sway")["numbers"][
        "orb_bit_err_pct"]["limit"]
    frames = [(1, None)]
    low = CHK.orb_reading(frames, frame.images, BIG, PARAMS,
                          low_dtype=torch.bfloat16)
    assert low > limit


def test_align_recovers_a_similarity():
    rng = np.random.default_rng(3)
    n = 30
    Rt = np.stack([G.project_so3(np.eye(3) + 0.1 * rng.normal(size=(3, 3)))
                   for _ in range(n)])
    ct = np.stack([np.linspace(0, 3, n), np.zeros(n), np.ones(n)], -1)
    s0, R0 = 0.37, G.project_so3(rng.normal(size=(3, 3)))
    if np.linalg.det(R0) < 0:
        R0 = -R0
    t0 = np.array([0.5, -1.0, 2.0])
    # the estimate lives in a world x_e = (R0^T (x_t - t0)) / s0
    ce = (ct - t0) @ R0 / s0
    Re = np.einsum("ji,njk->nik", R0, Rt)
    s, R, t = G.align(Rt, ct, Re, ce)
    assert s == pytest.approx(s0) and np.allclose(R, R0)
    assert np.allclose(t, t0)
    sim = (s, R, t)
    assert G.ate(sim, ct, ce) < 1e-9 and G.rpe(sim, ct, ce) < 1e-9
    assert G.rotation_error_deg(sim, Rt, Re) < 1e-5
