"""Parity of the port's Schur-complement local BA (estimation/local_ba.py,
ba_core.py) with the JAX package on one synthetic problem: 6 cameras (2
fixed, 2 padded), 256 landmarks with 2-6 observations, 0.5 px noise and 3%
gross outliers.

Tolerances and why: the JAX package assembles the Schur system S with bf16
operands (~0.4% relative noise per entry, an MXU speed trade); the port
assembles it in f32 with index gathers/index_add. The LM iterations
therefore take slightly different steps and stop at slightly different
points of the same optimum: the robust cost agrees to 1e-3 relative, the
camera poses to 1e-3 (rotation) / 2e-3 (translation, scene depth ~5), the
landmarks to 2e-2 at depths of 4-7, and no more than 0.5% of the inlier
flags differ.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ar_orbslam2_tpu.core import lie as JL
from ar_orbslam2_tpu.core.camera import Camera
from ar_orbslam2_tpu.estimation import local_ba as JB
from ar_orbslam2_tpu_torch.core.camera import Camera as TCamera
from ar_orbslam2_tpu_torch.estimation import local_ba as TB


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The port's steps are chains of tiny ops: more intra-op threads buy
    nothing and fight the other test workers for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


CAM = Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0)


def _so3(w):
    return np.array(JL.so3_exp(jnp.asarray(w.astype(np.float32))))


def _problem(seed=0, C=8, n_live=6, P=256, O=6):
    rng = np.random.default_rng(seed)
    Rs = _so3(rng.normal(0, 0.05, (C, 3)))
    centers = np.c_[np.linspace(-0.5, 0.5, C), rng.normal(0, 0.05, (C, 2))]
    ts = -(Rs @ centers[..., None])[..., 0].astype(np.float32)
    X = rng.uniform([-2, -1.5, 4], [2, 1.5, 7], (P, 3)).astype(np.float32)
    obs_cam = np.full((P, O), -1, np.int32)
    obs_uv = np.zeros((P, O, 2), np.float32)
    for p in range(P):
        cams = rng.choice(n_live, size=rng.integers(2, n_live + 1),
                          replace=False)
        for o, c in enumerate(cams):
            xc = Rs[c] @ X[p] + ts[c]
            obs_cam[p, o] = c
            obs_uv[p, o] = [500 * xc[0] / xc[2] + 320,
                            500 * xc[1] / xc[2] + 240]
    obs_uv += rng.normal(0, 0.5, obs_uv.shape).astype(np.float32)
    obs_uv[rng.random((P, O)) < 0.03] += 30.0          # gross outliers
    obs_oct = rng.integers(0, 3, (P, O)).astype(np.int32)
    cam_fixed = np.arange(C) < 2
    cam_valid = np.arange(C) < n_live
    pt_valid = rng.random(P) < 0.95
    R0 = _so3(rng.normal(0, 0.01, (C, 3))) @ Rs
    t0 = (ts + rng.normal(0, 0.03, ts.shape)).astype(np.float32)
    R0[cam_fixed], t0[cam_fixed] = Rs[cam_fixed], ts[cam_fixed]
    X0 = (X + rng.normal(0, 0.05, X.shape)).astype(np.float32)
    args = [R0.astype(np.float32), t0, cam_fixed, cam_valid, X0, pt_valid,
            obs_cam, obs_uv, obs_oct, obs_cam >= 0]
    return (ts, n_live), args


def test_bundle_adjust_matches():
    (ts, n_live), args = _problem()
    want = JB.bundle_adjust(*map(jnp.asarray, args), CAM)
    got = TB.bundle_adjust(*map(torch.as_tensor, args), TCamera(*CAM))
    np.testing.assert_allclose(float(got["cost"]), float(want["cost"]),
                               rtol=1e-3)
    np.testing.assert_allclose(got["cam_R"].numpy(),
                               np.asarray(want["cam_R"]), atol=1e-3)
    np.testing.assert_allclose(got["cam_t"].numpy(),
                               np.asarray(want["cam_t"]), atol=2e-3)
    np.testing.assert_allclose(got["pts"].numpy(), np.asarray(want["pts"]),
                               atol=2e-2)
    flips = (got["obs_inlier"].numpy() != np.asarray(want["obs_inlier"]))
    assert flips.sum() <= 0.005 * args[-1].sum()
    # fixed cameras did not move; the free ones moved toward the truth
    np.testing.assert_array_equal(got["cam_t"].numpy()[:2], args[1][:2])
    err0 = np.abs(args[1][:n_live] - ts[:n_live]).max()
    err = np.abs(got["cam_t"].numpy()[:n_live] - ts[:n_live]).max()
    assert err < 0.2 * err0
