"""Parity of the port's motion-only BA (estimation/pose_opt.py) with the
JAX package on a synthetic 3D-2D problem with noise, outliers and padding.

The port replaces the JAX early-exit while_loop and scanned CG with fixed
loops that freeze the state once converged, so the two run the same
iterations: R and t agree to 1e-4 (f32 rounding through ~40 LM steps; the
observed gap is ~1e-7) and the chi2 inlier sets are equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ar_orbslam2_tpu.core import lie as JL
from ar_orbslam2_tpu.core.camera import Camera
from ar_orbslam2_tpu.estimation import pose_opt as JP
from ar_orbslam2_tpu_torch.core.camera import Camera as TCamera
from ar_orbslam2_tpu_torch.estimation import pose_opt as TP

CAM = Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0)


def _problem(seed, n=400):
    rng = np.random.default_rng(seed)
    xw = rng.uniform([-2, -1.5, 3], [2, 1.5, 7], (n, 3)).astype(np.float32)
    R = np.array(JL.so3_exp(jnp.asarray([0.05, -0.1, 0.02])))
    t = np.array([0.1, -0.05, 0.2], np.float32)
    xc = xw @ R.T + t
    uv = np.stack([500 * xc[:, 0] / xc[:, 2] + 320,
                   500 * xc[:, 1] / xc[:, 2] + 240], -1)
    uv += rng.normal(0, 0.7, uv.shape)
    bad = rng.random(n) < 0.1                      # gross outliers
    uv[bad] = rng.uniform(0, 600, (bad.sum(), 2))
    octave = rng.integers(0, 4, n).astype(np.int32)
    valid = rng.random(n) < 0.8                    # padded rows
    R0 = np.array(JL.so3_exp(jnp.asarray([0.06, -0.08, 0.03])))
    t0 = t + np.array([0.05, 0.03, -0.05], np.float32)
    return (R, t), [R0, t0, xw, uv.astype(np.float32), octave, valid]


@pytest.mark.parametrize("seed,M", [(0, 256), (1, 512)])
def test_pose_optimization_compact_matches(seed, M):
    (R, t), args = _problem(seed)
    want = JP.pose_optimization_compact(*map(jnp.asarray, args), CAM, M)
    got = TP.pose_optimization_compact(*map(torch.as_tensor, args),
                                       TCamera(*CAM), M)
    np.testing.assert_allclose(got["R"].numpy(), np.asarray(want["R"]),
                               atol=1e-4)
    np.testing.assert_allclose(got["t"].numpy(), np.asarray(want["t"]),
                               atol=1e-4)
    np.testing.assert_array_equal(got["inlier"].numpy(),
                                  np.asarray(want["inlier"]))
    assert int(got["n_inliers"]) == int(want["n_inliers"]) > 150
    # and it actually solved the problem (0.7 px noise, 5 m depth)
    assert np.abs(got["t"].numpy() - t).max() < 2e-2


def test_compact_rows_matches():
    rng = np.random.default_rng(3)
    mask = rng.random(300) < 0.6
    for M in (64, 512):
        got = TP.compact_rows(torch.as_tensor(mask), M)
        want = JP.compact_rows(jnp.asarray(mask), M)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
