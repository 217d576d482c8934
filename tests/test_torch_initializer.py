"""Parity of the port's two-view initialization (estimation/initializer.py)
with the JAX package, with the JAX RANSAC draw injected.

The JAX package draws its hypotheses with jax.random.categorical; the port
takes the same (n_hyp, 8) sample indices, so both score the same minimal
sets. Tolerances: hypotheses come from 9x9 eigh / 3x3 SVD in each
framework's LAPACK call (f32, sign-free after normalization), so scores
agree to 1e-3 relative and at most 1% of the inlier flags may flip at the
chi2 gate; the recovered relative pose agrees to 1e-3. One exception: on
a planar scene F is degenerate (a plane fixes only a family of fundamental
matrices), so which member each LAPACK eigensolver returns differs and
the F score is held to 1e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ar_orbslam2_tpu.core import lie as JL
from ar_orbslam2_tpu.core.camera import Camera
from ar_orbslam2_tpu.estimation import initializer as JI
from ar_orbslam2_tpu_torch.estimation import initializer as TI

CAM = Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0)
K = np.asarray(CAM.K)


def _two_views(planar, seed, n=300, pad=512):
    rng = np.random.default_rng(seed)
    if planar:
        xy = rng.uniform([-2, -1.5], [2, 1.5], (n, 2))
        xw = np.c_[xy, 5.0 + 0.1 * xy[:, 0]]
    else:
        xw = rng.uniform([-2, -1.5, 3], [2, 1.5, 8], (n, 3))
    R2 = np.asarray(JL.so3_exp(jnp.asarray([0.01, -0.04, 0.01]))).astype(
        np.float64)
    t2 = np.array([-0.4, 0.02, 0.05])

    def proj(x):
        return np.c_[500 * x[:, 0] / x[:, 2] + 320,
                     500 * x[:, 1] / x[:, 2] + 240]
    uv1 = proj(xw) + rng.normal(0, 0.5, (n, 2))
    uv2 = proj(xw @ R2.T + t2) + rng.normal(0, 0.5, (n, 2))
    bad = rng.random(n) < 0.15
    uv2[bad] = rng.uniform(0, 600, (bad.sum(), 2))
    U1 = np.zeros((pad, 2), np.float32)
    U2 = np.zeros((pad, 2), np.float32)
    valid = np.zeros(pad, bool)
    U1[:n], U2[:n], valid[:n] = uv1, uv2, True
    return U1, U2, valid


def _jax_draw(valid, n_hyp=256):
    logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    return np.asarray(jax.random.categorical(jax.random.PRNGKey(0), logits,
                                             shape=(n_hyp, 8)))


@pytest.mark.parametrize("planar", [False, True])
def test_ransac_fh_matches_with_injected_draw(planar):
    uv1, uv2, valid = _two_views(planar, seed=int(planar))
    want = JI.ransac_fh(jnp.asarray(uv1), jnp.asarray(uv2),
                        jnp.asarray(valid), jax.random.PRNGKey(0))
    got = TI.ransac_fh(torch.as_tensor(uv1), torch.as_tensor(uv2),
                       torch.as_tensor(valid), sample_idx=_jax_draw(valid))
    for k in ("score_f", "score_h"):
        rtol = 1e-2 if (planar and k == "score_f") else 1e-3
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol)
    for k in ("inliers_f", "inliers_h"):
        flips = (got[k].numpy() != np.asarray(want[k])).sum()
        assert flips <= 0.01 * valid.sum(), (k, flips)


@pytest.mark.parametrize("planar", [False, True])
def test_initialize_two_view_matches(planar):
    uv1, uv2, valid = _two_views(planar, seed=10 + int(planar))
    want = JI.initialize_two_view(jnp.asarray(uv1), jnp.asarray(uv2),
                                  jnp.asarray(valid), K,
                                  jax.random.PRNGKey(0))
    got = TI.initialize_two_view(torch.as_tensor(uv1), torch.as_tensor(uv2),
                                 torch.as_tensor(valid), K,
                                 sample_idx=_jax_draw(valid))
    assert want is not None and got is not None
    assert got["used_model"] == want["used_model"]
    np.testing.assert_allclose(got["R21"], want["R21"], atol=1e-3)
    np.testing.assert_allclose(got["t21"], want["t21"], atol=1e-3)
    flips = (got["good"] != want["good"]).sum()
    assert flips <= 0.01 * valid.sum()
    both = got["good"] & want["good"]
    # triangulated points of the unit-baseline reconstruction (depth ~10)
    np.testing.assert_allclose(got["xw"][both], want["xw"][both],
                               rtol=5e-3, atol=5e-3)


def test_generator_draw_is_reproducible():
    uv1, uv2, valid = _two_views(False, seed=4)
    args = (torch.as_tensor(uv1), torch.as_tensor(uv2),
            torch.as_tensor(valid))
    a = TI.ransac_fh(*args, generator=torch.Generator().manual_seed(0))
    b = TI.ransac_fh(*args, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a["F"], b["F"]) and torch.equal(a["H"], b["H"])
    idx = TI.sample_hypotheses(args[2], 64,
                               torch.Generator().manual_seed(1))
    assert idx.shape == (64, 8) and bool(args[2][idx].all())
