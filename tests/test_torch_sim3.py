"""The Sim(3) half of the port's loop-closing slice against the JAX package
on the CPU: the Sim(3) Lie functions, Horn's closed form, the Sim3 RANSAC
(with the JAX draw handed to the port), the Sim3 Gauss-Newton, and the
essential graph on both solver paths.

Inputs come from numpy seeds and go through both packages. Tolerances:

* Sim3 exp/log/inv/mul/apply and Horn on exact data: 1e-5.
* RANSAC with the JAX draw: the winner 5e-3, its inlier count +-2 (a
  3-point sample is nearly degenerate for a 4x4 eigensolver in float32).
* optimize_sim3: 1e-4, the inlier set exact.
* The essential graph, dense path (K <= 128): poses 1e-4. PCG path (the
  192-vertex drifted circle): 80 float32 CG iterations on a chain whose
  condition number grows with K^2 do not reproduce across reduction
  orders: the JAX function's own jitted and eager runs disagree by a few
  1e-3 in translation (magnitudes up to 17) after ONE Gauss-Newton step,
  and more mid-descent. The port is held after one step and after 60 (the
  JAX test's count) to 1e-2 in translation and 3e-3 in rotation and
  scale, and to the reference's convergence: the drift collapses 10x and
  the final error to the ground truth is within 5 % of the JAX
  function's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ar_orbslam2_tpu.core import lie as JL
from ar_orbslam2_tpu.core.camera import Camera as JCamera
from ar_orbslam2_tpu.estimation import pose_graph as JPG
from ar_orbslam2_tpu.estimation import sim3_solver as JS
from ar_orbslam2_tpu_torch.core import lie as TL
from ar_orbslam2_tpu_torch.core.camera import Camera
from ar_orbslam2_tpu_torch.estimation import pose_graph as TPG
from ar_orbslam2_tpu_torch.estimation import sim3_solver as TS

CAM = Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)
JCAM = JCamera(fx=500.0, fy=500.0, cx=320.0, cy=240.0)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The port's stages are chains of small ops: more intra-op threads buy
    nothing and fight the other test workers for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def T(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


# ---------------------------------------------------------------------------
# Sim(3) Lie functions and Horn
# ---------------------------------------------------------------------------
def test_sim3_lie_functions_match_jax():
    rng = np.random.default_rng(0)
    v = rng.normal(0, 0.6, (64, 7)).astype(np.float32)
    v[:4] *= 1e-7                                   # the small-angle end
    w = rng.normal(0, 0.6, (64, 7)).astype(np.float32)
    x = rng.normal(0, 2.0, (64, 3)).astype(np.float32)
    ja, ta = JL.sim3_exp(jnp.asarray(v)), TL.sim3_exp(T(v))
    jb, tb = JL.sim3_exp(jnp.asarray(w)), TL.sim3_exp(T(w))
    for g, want in zip(ta, ja):
        _close(g, want, 1e-5)
    _close(TL.sim3_log(*ta), JL.sim3_log(*ja), 1e-5)
    for g, want in zip(TL.sim3_inv(*ta), JL.sim3_inv(*ja)):
        _close(g, want, 1e-5)
    for g, want in zip(TL.sim3_mul(*ta, *tb), JL.sim3_mul(*ja, *jb)):
        _close(g, want, 1e-5)
    _close(TL.sim3_apply(*ta, T(x)), JL.sim3_apply(*ja, jnp.asarray(x)),
           1e-5)
    # the round trip itself
    _close(TL.sim3_log(*ta), v, 1e-5)


def _pose(seed):
    rng = np.random.default_rng(seed)
    R = np.asarray(JL.so3_exp(jnp.asarray(
        rng.normal(0, 0.2, 3).astype(np.float32))))
    t = rng.normal(0, 0.3, 3).astype(np.float32)
    return R, t


@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_sim3_on_exact_data(fix_scale):
    rng = np.random.default_rng(3)
    p2 = rng.normal(0, 1, (10, 3)).astype(np.float32)
    R, t = _pose(4)
    s = 1.0 if fix_scale else 1.7
    p1 = (s * p2 @ R.T + t).astype(np.float32)
    want = JS.horn_sim3(jnp.asarray(p1), jnp.asarray(p2), fix_scale=fix_scale)
    got = TS.horn_sim3(T(p1), T(p2), fix_scale=fix_scale)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    _close(got[0], R, 1e-5)
    assert abs(float(got[2]) - s) < 1e-5
    # a batch of samples is one batched eigh: same as one at a time
    Rb, tb, sb = TS.horn_sim3(torch.stack([T(p1), T(p1)[[3, 1, 2, 0, 4, 5,
                                                          6, 7, 8, 9]]]),
                              torch.stack([T(p2), T(p2)[[3, 1, 2, 0, 4, 5,
                                                         6, 7, 8, 9]]]),
                              fix_scale=fix_scale)
    _close(Rb[1], R, 1e-5)
    _close(sb, [s, s], 1e-5)


# ---------------------------------------------------------------------------
# RANSAC and Gauss-Newton
# ---------------------------------------------------------------------------
def _sim3_problem(N=128, seed=5):
    rng = np.random.default_rng(seed)
    p2 = rng.uniform([-2, -2, 3], [2, 2, 8], (N, 3)).astype(np.float32)
    Rg, tg = _pose(6)
    sg = 1.3
    p1 = (sg * p2 @ Rg.T + tg).astype(np.float32)
    p1[:, 2] = np.abs(p1[:, 2]) + 2.0
    p2 = (((p1 - tg) @ Rg) / sg).astype(np.float32)

    def proj(p):
        return np.stack([500 * p[:, 0] / p[:, 2] + 320,
                         500 * p[:, 1] / p[:, 2] + 240], -1).astype(
                             np.float32)

    uv1, uv2 = proj(p1), proj(p2)
    uv1 += rng.normal(0, 0.5, uv1.shape).astype(np.float32)
    n_out = N // 4
    p1c = p1.copy()
    p1c[:n_out] += rng.normal(0, 2.0, (n_out, 3)).astype(np.float32)
    octave = rng.integers(0, 3, N).astype(np.int32)
    valid = np.ones(N, bool)
    valid[-8:] = False
    return p1c, p2, uv1, uv2, octave, octave[::-1].copy(), valid, (Rg, tg,
                                                                   sg)


def test_sim3_ransac_and_refine_with_the_jax_draw():
    p1, p2, uv1, uv2, o1, o2, valid, (Rg, tg, sg) = _sim3_problem()
    N = len(p1)
    key = jax.random.PRNGKey(1)
    p = valid.astype(np.float32) / valid.sum()
    samples = np.asarray(jax.random.choice(key, N, (256, 3), replace=True,
                                           p=jnp.asarray(p)))
    jargs = tuple(jnp.asarray(a) for a in (p1, p2, uv1, uv2, o1, o2, valid))
    targs = tuple(T(a) for a in (p1, p2, uv1, uv2, o1, o2, valid))
    want = JS.sim3_ransac(JCAM, *jargs, key)
    got = TS.sim3_ransac(CAM, *targs, samples=T(samples))
    assert bool(got["ok"]) and bool(want["ok"])
    assert abs(int(got["n_inliers"]) - int(want["n_inliers"])) <= 2
    for k in ("R12", "t12", "s12"):
        _close(got[k], want[k], 5e-3)
    assert abs(float(got["s12"]) - sg) < 0.05
    # the generator draw also finds it
    gen = torch.Generator().manual_seed(0)
    assert abs(float(TS.sim3_ransac(CAM, *targs, generator=gen)["s12"])
               - sg) < 0.05

    # Gauss-Newton from the same start: both packages, one start value
    start = tuple(np.asarray(want[k]) for k in ("R12", "t12", "s12"))
    for fix_scale in (False, True):
        jr = JS.optimize_sim3(JCAM, *(jnp.asarray(a) for a in start),
                              *jargs, fix_scale=fix_scale)
        tr = TS.optimize_sim3(CAM, *(T(a) for a in start), *targs,
                              fix_scale=fix_scale)
        np.testing.assert_array_equal(tr["inlier"].numpy(),
                                      np.asarray(jr["inlier"]))
        assert int(tr["n_inliers"]) == int(jr["n_inliers"])
        for k in ("R12", "t12", "s12"):
            _close(tr[k], jr[k], 1e-4)
    assert int(tr["n_inliers"]) >= N - N // 4 - 8 - 5


# ---------------------------------------------------------------------------
# essential graph
# ---------------------------------------------------------------------------
def _circle_problem(K, seed=7, drift=0.01):
    """tests/test_pose_graph_cg.py's drifted circle (the dense-path test of
    tests/test_pnp_sim3.py builds the same one at K = 12, drift 0.02)."""
    rng = np.random.default_rng(seed)
    Rs_gt, ts_gt = [], []
    for i in range(K):
        a = 2 * np.pi * i / K
        Rw = np.asarray(JL.so3_exp(jnp.asarray([0.0, a, 0.0], jnp.float32)))
        cw = np.array([np.cos(a), 0.0, np.sin(a)], np.float32) * 3.0
        Rs_gt.append(Rw)
        ts_gt.append(-(Rw @ cw))
    Rs_gt = np.stack(Rs_gt).astype(np.float32)
    ts_gt = np.stack(ts_gt).astype(np.float32)
    edges = [(i, i + 1) for i in range(K - 1)] + [(K - 1, 0)]
    ei = np.array([e[0] for e in edges], np.int32)
    ej = np.array([e[1] for e in edges], np.int32)
    eR, et = [], []
    for i, j in edges:
        Rji = Rs_gt[j] @ Rs_gt[i].T
        et.append(ts_gt[j] - Rji @ ts_gt[i])
        eR.append(Rji)
    R0, t0 = Rs_gt.copy(), ts_gt.copy()
    for i in range(1, K):
        dw = rng.normal(0, drift * i, 3).astype(np.float32)
        R0[i] = np.asarray(JL.so3_exp(jnp.asarray(dw))) @ R0[i]
        t0[i] = t0[i] + rng.normal(0, 2.5 * drift * i, 3).astype(np.float32)
    E = len(edges)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    args = (R0, t0, np.ones(K, np.float32), np.ones(K, bool), fixed, ei, ej,
            np.stack(eR).astype(np.float32), np.stack(et).astype(np.float32),
            np.ones(E, np.float32), np.ones(E, bool))
    return args, ts_gt


def test_essential_graph_dense_path_matches_jax():
    args, ts_gt = _circle_problem(12, drift=0.02)
    assert 12 <= TPG.CG_THRESHOLD
    want = JPG.optimize_essential_graph(*(jnp.asarray(a) for a in args),
                                        n_iters=20)
    got = TPG.optimize_essential_graph(*(T(a) for a in args), n_iters=20)
    for k in ("R", "t", "s"):
        _close(got[k], want[k], 1e-4)
    err0 = np.linalg.norm(args[1] - ts_gt, axis=1).max()
    err = np.linalg.norm(got["t"].numpy() - ts_gt, axis=1).max()
    assert err < 0.05 * err0


def test_essential_graph_pcg_path_matches_jax():
    K = 192
    assert K > TPG.CG_THRESHOLD          # must exercise the PCG branch
    args, ts_gt = _circle_problem(K)
    for n_iters in (1, 60):
        want = JPG.optimize_essential_graph(*(jnp.asarray(a) for a in args),
                                            n_iters=n_iters)
        got = TPG.optimize_essential_graph(*(T(a) for a in args),
                                           n_iters=n_iters)
        _close(got["R"], want["R"], 3e-3)
        _close(got["t"], want["t"], 1e-2)
        _close(got["s"], want["s"], 3e-3)
    err0 = np.linalg.norm(args[1] - ts_gt, axis=1).max()
    err_j = np.linalg.norm(np.asarray(want["t"]) - ts_gt, axis=1).max()
    err_t = np.linalg.norm(got["t"].numpy() - ts_gt, axis=1).max()
    assert err_t < 0.1 * err0
    assert abs(err_t - err_j) <= 0.05 * err_j
