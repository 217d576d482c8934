"""Parity of the port's core/ (lie, camera, geometry, robust) with the JAX
package, on the probes that caught real bugs: so3_log near pi, degenerate
(zero-parallax) triangulation, worst-corner undistortion.

Tolerances are float32 ones: both packages compute in f32 with the same
formulas, so results differ only by operation order and library math
(sin/cos/atan2/solve), i.e. a few ulps of the values involved.
"""
import jax.numpy as jnp
import numpy as np
import torch

from ar_orbslam2_tpu.core import camera as JC
from ar_orbslam2_tpu.core import geometry as JG
from ar_orbslam2_tpu.core import lie as JL
from ar_orbslam2_tpu.core import robust as JR
from ar_orbslam2_tpu_torch.core import camera as TC
from ar_orbslam2_tpu_torch.core import geometry as TG
from ar_orbslam2_tpu_torch.core import lie as TL
from ar_orbslam2_tpu_torch.core import robust as TR


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def test_so3_log_near_pi_and_exp_log_roundtrip():
    rng = np.random.default_rng(0)
    axes = rng.normal(size=(64, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.concatenate([np.full(16, np.pi), np.pi - rng.uniform(
        0, 1e-3, 16), rng.uniform(0, np.pi, 32)])
    omega = (axes * angles[:, None]).astype(np.float32)
    R_t = TL.so3_exp(_t(omega))
    R_j = np.asarray(JL.so3_exp(jnp.asarray(omega)))
    # f32 Rodrigues: entries are O(1), a few ulps apart
    np.testing.assert_allclose(R_t.numpy(), R_j, atol=2e-6)
    w_t = TL.so3_log(R_t).numpy()
    w_j = np.asarray(JL.so3_log(jnp.asarray(R_j)))
    # near theta = pi the axis sign is arbitrary; compare the rotations
    R_back_t = TL.so3_exp(torch.as_tensor(w_t)).numpy()
    R_back_j = np.asarray(JL.so3_exp(jnp.asarray(w_j)))
    np.testing.assert_allclose(R_back_t, R_back_j, atol=2e-5)
    np.testing.assert_allclose(R_back_t, R_j, atol=2e-5)
    # away from pi the log itself agrees (atan2 branch, no sign choice)
    np.testing.assert_allclose(w_t[32:], w_j[32:], atol=1e-5)


def test_se3_and_quaternions_match():
    rng = np.random.default_rng(1)
    xi = rng.normal(0, 0.8, (32, 6)).astype(np.float32)
    R_t, t_t = TL.se3_exp(_t(xi))
    R_j, t_j = JL.se3_exp(jnp.asarray(xi))
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=2e-6)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-5)
    np.testing.assert_allclose(TL.se3_log(R_t, t_t).numpy(),
                               np.asarray(JL.se3_log(R_j, t_j)), atol=1e-4)
    q_t = TL.rot_to_quat(R_t).numpy()
    q_j = np.asarray(JL.rot_to_quat(R_j))
    np.testing.assert_allclose(q_t, q_j, atol=2e-6)
    np.testing.assert_allclose(TL.quat_to_rot(torch.as_tensor(q_t)).numpy(),
                               np.asarray(JL.quat_to_rot(jnp.asarray(q_j))),
                               atol=2e-6)
    np.testing.assert_allclose(TL.project_so3(R_t.numpy() * 1.01),
                               JL.project_so3(np.asarray(R_j) * 1.01),
                               atol=1e-6)


def test_worst_corner_undistortion():
    cam_j = JC.Camera(fx=458.654, fy=457.296, cx=367.215, cy=248.375,
                      k1=-0.28340811, k2=0.07395907, p1=0.00019359,
                      p2=1.76187114e-05, width=752, height=480)
    cam_t = TC.Camera(*cam_j)
    np.testing.assert_allclose(TC.undistorted_bounds(cam_t),
                               JC.undistorted_bounds(cam_j), atol=1e-3)
    corners = np.array([[0, 0], [752, 0], [0, 480], [752, 480],
                        [376, 240]], np.float32)
    und_t = TC.undistort_points(cam_t, _t(corners)).numpy()
    und_j = np.asarray(JC.undistort_points(cam_j, jnp.asarray(corners)))
    # pixel coordinates of magnitude ~1e3: 1e-3 px is ~10 f32 ulps
    np.testing.assert_allclose(und_t, und_j, atol=1e-3)
    # the undistorted corner re-distorts onto the raw corner
    xy = TC.normalize_pixels(cam_t, torch.as_tensor(und_t))
    xd = TC.distort_normalized(cam_t, xy).numpy()
    raw = TC.normalize_pixels(cam_t, _t(corners)).numpy()
    np.testing.assert_allclose(xd, raw, atol=2e-3)


def test_triangulation_matches_and_degenerate_stays_finite():
    rng = np.random.default_rng(2)
    R1, t1 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    R2 = np.asarray(JL.so3_exp(jnp.asarray([0.0, 0.05, 0.0])))
    t2 = np.array([-0.3, 0.0, 0.02], np.float32)
    xw = rng.uniform([-1, -1, 3], [1, 1, 6], (50, 3)).astype(np.float32)
    xn1 = xw[:, :2] / xw[:, 2:]
    xc2 = xw @ R2.T + t2
    xn2 = xc2[:, :2] / xc2[:, 2:]
    got = TG.triangulate_linear(*map(_t, (R1, t1, R2, t2, xn1, xn2))).numpy()
    want = np.asarray(JG.triangulate_linear(
        *map(jnp.asarray, (R1, t1, R2, t2, xn1, xn2))))
    # depths 3-6 m from a 0.3 m baseline: f32 solve error ~1e-5 relative
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, xw, rtol=1e-3, atol=1e-3)
    # zero baseline: the Tikhonov term keeps every point finite
    deg = TG.triangulate_linear(*map(_t, (R1, t1, R1, t1, xn1, xn1)))
    assert torch.isfinite(deg).all()
    cos_t = TG.parallax_cos(_t(t1), _t(t1), deg).numpy()
    cos_j = np.asarray(JG.parallax_cos(jnp.asarray(t1), jnp.asarray(t1),
                                       jnp.asarray(deg.numpy())))
    np.testing.assert_allclose(cos_t, cos_j, atol=1e-6)


def test_epipolar_and_essential_decomposition():
    R = np.asarray(JL.so3_exp(jnp.asarray([0.02, -0.1, 0.03])))
    t = np.array([0.5, 0.1, -0.05], np.float32)
    K = JC.Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0).K
    F_t = TG.fundamental_from_pose(_t(R), _t(t), _t(K), _t(K))
    F_j = JG.fundamental_from_pose(jnp.asarray(R), jnp.asarray(t), K, K)
    np.testing.assert_allclose(F_t.numpy(), np.asarray(F_j), rtol=1e-5,
                               atol=1e-9)
    rng = np.random.default_rng(3)
    uv1 = rng.uniform(0, 600, (40, 2)).astype(np.float32)
    uv2 = rng.uniform(0, 600, (40, 2)).astype(np.float32)
    np.testing.assert_allclose(
        TG.epipolar_sq_dist(F_t, _t(uv1), _t(uv2)).numpy(),
        np.asarray(JG.epipolar_sq_dist(F_j, jnp.asarray(uv1),
                                       jnp.asarray(uv2))), rtol=1e-3)
    # decompositions agree as SETS of hypotheses: SVD signs may differ
    E = np.asarray(JG.essential_from_pose(jnp.asarray(R), jnp.asarray(t)))
    R1t, R2t, tt = TG.decompose_essential(_t(E))
    R1j, R2j, tj = JG.decompose_essential(jnp.asarray(E))
    for r in (R1t.numpy(), R2t.numpy()):
        assert min(np.abs(r - np.asarray(q)).max() for q in (R1j, R2j)) < 1e-4
    assert abs(abs(float(np.dot(tt.numpy(), np.asarray(tj)))) - 1) < 1e-5


def test_huber_weight_matches():
    chi2 = np.linspace(0, 30, 61).astype(np.float32)
    np.testing.assert_allclose(
        TR.huber_weight(_t(chi2), 5.991).numpy(),
        np.asarray(JR.huber_weight(jnp.asarray(chi2), 5.991)), atol=1e-7)
