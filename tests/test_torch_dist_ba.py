"""The port's landmark-sharded distributed BA (parallel/dist_ba.py, SPMD
over torch.distributed ranks) against the JAX package's (shard_map over a
device mesh), on the CPU.

The port runs as 4 (and 1) gloo ranks in CPU processes started by
multihost.spawn_local (the ranks live in tests/torch_dist_workers.py,
which imports no jax); the JAX package runs on a 4-device sub-mesh of the
8 virtual CPU devices that conftest.py provides. Inputs are
tests/test_local_ba.py's problem (built from a numpy seed) and, for the
banded route, gather_global_partitioned(store, 4) of a covisibility chain
map. Tolerances: those of tests/test_torch_local_ba.py — cost 1e-3
relative, rotations 1e-3, translations 2e-3, landmarks 2e-2 — which cover
the bf16 operands the JAX package assembles S with (the port assembles in
float32). Port world 1 against world 4, where only the order of the
float32 sums differs: the cost 1e-5 relative, poses 1e-5, inlier flags
equal, landmarks with two or more inlier observations 3e-5 (about 30
float32 steps at the problem's depths of 4-10; 1.4e-5 measured on this
CPU). A landmark left with one inlier observation has an unobservable
depth — only the solver's 1e-6 regularization holds it, so any change
of rounding moves it (3.4e-3 here) — and is not compared; there is one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ar_orbslam2_tpu.core.camera import Camera as JCamera
from ar_orbslam2_tpu.parallel import dist_ba as JD
from ar_orbslam2_tpu_torch.mapping import global_ba as TGBA
from ar_orbslam2_tpu_torch.parallel import dist_ba as TD
from ar_orbslam2_tpu_torch.parallel.multihost import spawn_local
from test_local_ba import build_ba_problem
from test_torch_partition import CAM_KW, chain_maps

import torch_dist_workers as W

N_ITERS = 12
SPAWN_LIMIT_S = 180    # each group's own time limit (a world-4 case took
                       # 35-42 s beside five other test workers)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _problem():
    p = build_ba_problem(np.random.default_rng(0), n_cams=8, n_pts=400,
                         opp=6)
    n_pts, opp = p["obs_cam"].shape
    return dict(cam_R=p["cam_R0"], cam_t=p["cam_t0"], cam_fixed=p["fixed"],
                cam_valid=np.ones(len(p["fixed"]), bool), pts=p["pts0"],
                pt_valid=np.ones(n_pts, bool), obs_cam=p["obs_cam"],
                obs_uv=p["uv"], obs_oct=np.zeros((n_pts, opp), np.int32),
                obs_valid=np.ones((n_pts, opp), bool),
                obs_uvr=np.full((n_pts, opp), -1.0, np.float32))


def _jax(prob, banded=False):
    mesh = JD.make_mesh(jax.devices()[:4])
    pts = JD.shard_point_arrays(mesh, *(jnp.asarray(prob[k])
                                        for k in W.PT_KEYS))
    cams = JD.replicate(mesh, *(jnp.asarray(prob[k]) for k in W.CAM_KEYS))
    cam = JCamera(**{k: CAM_KW[k] for k in ("fx", "fy", "cx", "cy", "bf")})
    if banded:
        (off,) = JD.shard_point_arrays(mesh, jnp.asarray(prob["band_off"]))
        res = JD.dist_bundle_adjust_banded(
            mesh, *cams, *pts[:6], cam, band_off=off, band_w=prob["band_w"],
            obs_uvr=pts[6], n_iters=N_ITERS)
    else:
        res = JD.dist_bundle_adjust(mesh, *cams, *pts[:6], cam,
                                    obs_uvr=pts[6], n_iters=N_ITERS)
    return {k: np.asarray(v) for k, v in res.items()}


def _port(prob, world, tmp_path):
    out = str(tmp_path / f"world{world}.npz")
    spawn_local(world, W.dist_ba_rank, prob, CAM_KW, N_ITERS, out,
                timeout=SPAWN_LIMIT_S)
    return dict(np.load(out))


def _assert_parity(got, want):
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-3)
    np.testing.assert_allclose(got["cam_R"], want["cam_R"], atol=1e-3)
    np.testing.assert_allclose(got["cam_t"], want["cam_t"], atol=2e-3)
    np.testing.assert_allclose(got["pts"], want["pts"], atol=2e-2)


def _banded_problem():
    (_, ts), _ = chain_maps()
    gp = TGBA.gather_global_partitioned(ts, 4)
    return {k: gp[k] for k in W.PT_KEYS + W.CAM_KEYS
            + ("band_off", "band_w")}


@pytest.mark.parametrize("banded", [False, True], ids=["dense", "banded"])
def test_dist_ba_world4_matches_jax_4_device_mesh(banded, tmp_path):
    prob = _banded_problem() if banded else _problem()
    got = _port(prob, 4, tmp_path)
    want = _jax(prob, banded)
    _assert_parity(got, want)
    # the cost fell and every rank counted the same exchange: per LM
    # iteration one camera-system and one cost collective, plus the final
    # cost (and the banded route's one gather of the offsets)
    assert got["calls"] == 2 * N_ITERS + 1 + int(banded)


def test_dist_ba_world1_matches_world4(tmp_path):
    prob = _problem()
    one, four = _port(prob, 1, tmp_path), _port(prob, 4, tmp_path)
    np.testing.assert_allclose(four["cost"], one["cost"], rtol=1e-5)
    for k in ("cam_R", "cam_t"):
        np.testing.assert_allclose(four[k], one[k], atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(four["obs_inlier"], one["obs_inlier"])
    seen = one["obs_inlier"].sum(1) >= 2
    assert (~seen).sum() <= 1
    np.testing.assert_allclose(four["pts"][seen], one["pts"][seen],
                               atol=3e-5)


def test_shard_point_arrays_needs_p_divisible_by_world():
    mesh = TD.Mesh(group=None, world_size=3, rank=1,
                   device=torch.device("cpu"), backend="gloo")
    (a,) = TD.shard_point_arrays(mesh, np.arange(12).reshape(6, 2))
    np.testing.assert_array_equal(a.numpy(), [[4, 5], [6, 7]])
    with pytest.raises(AssertionError, match="multiple of mesh size"):
        TD.shard_point_arrays(mesh, np.zeros((7, 2)))


def test_make_mesh_without_a_group_raises():
    with pytest.raises(RuntimeError, match="no torch.distributed"):
        TD.make_mesh(device="cpu")
