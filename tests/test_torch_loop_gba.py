"""Global bundle adjustment and the vocabulary training of the port's
loop-closing slice against the JAX package on the CPU: the full-map gather
and run, its distributed dense and banded routes (gloo ranks against the
JAX package's 8-device mesh), the background GBA protocol (its three cases in
tests/test_background_gba.py: poll applies, abort drops, propagation to
keyframes made during the BA), and the k-medians codebook.

Inputs come from numpy seeds and go through both packages. Tolerances:
gather_global exact (it only gathers); the BA results those of
tests/test_torch_local_ba.py, as global BA runs the same Schur LM (f32
here, bf16 operands in the JAX package): cost 1e-3 relative, poses 1e-3
(rotation) / 2e-3 (translation), landmarks 2e-2; train_codebook and
assign_words bit for bit for one seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ar_orbslam2_tpu.core import lie as JL
from ar_orbslam2_tpu.core.camera import Camera as JCamera
from ar_orbslam2_tpu.loop import vocab_train as JV
from ar_orbslam2_tpu.mapping import background_gba as JBG
from ar_orbslam2_tpu.mapping import global_ba as JGBA
from ar_orbslam2_tpu.mapstore.map import MapConfig as JMapConfig
from ar_orbslam2_tpu.mapstore.map import MapStore as JMapStore
from ar_orbslam2_tpu_torch.core.camera import Camera
from ar_orbslam2_tpu_torch.loop import vocab_train as TV
from ar_orbslam2_tpu_torch.mapping import background_gba as TBG
from ar_orbslam2_tpu_torch.mapping import global_ba as TGBA
from ar_orbslam2_tpu_torch.mapstore.map import MapConfig, MapStore
from ar_orbslam2_tpu_torch.ops import hamming as TH

CAM = Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)
JCAM = JCamera(fx=500.0, fy=500.0, cx=320.0, cy=240.0)
SPAWN_LIMIT_S = 240    # each group's own time limit (the world-4 routes took
                       # about 70 s beside five other test workers)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The port's stages are chains of small ops: more intra-op threads buy
    nothing and fight the other test workers for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


# ---------------------------------------------------------------------------
# global BA: gather, run, background protocol
# ---------------------------------------------------------------------------
def _build_maps(n_kf=5, n_pts=96, noise=0.02, seed=0):
    """tests/test_background_gba.py's map, in both packages' stores."""
    rng = np.random.default_rng(seed)
    kw = dict(max_keyframes=16, max_map_points=512, max_kp=128, max_obs=8)
    stores = (JMapStore(JMapConfig(**kw)), MapStore(MapConfig(**kw)))
    pts_gt = rng.uniform([-3, -2, 4], [3, 2, 10],
                         (n_pts, 3)).astype(np.float32)
    frames = []
    for i in range(n_kf):
        R = np.asarray(JL.so3_exp(jnp.asarray(
            np.array([0.0, 0.05 * i, 0.0], np.float32))))
        t = np.array([-0.2 * i, 0.0, 0.0], np.float32)
        xc = pts_gt @ R.T + t
        uv = np.stack([500 * xc[:, 0] / xc[:, 2] + 320,
                       500 * xc[:, 1] / xc[:, 2] + 240], -1)
        uv = np.pad(uv.astype(np.float32), ((0, 128 - n_pts), (0, 0)))
        desc = rng.integers(0, 256, (128, 32)).astype(np.uint8)
        valid = np.zeros(128, bool)
        valid[:n_pts] = True
        frames.append((R, t, uv, desc, np.zeros(128, np.int32), valid))
    pts0 = pts_gt + rng.normal(0, noise, pts_gt.shape).astype(np.float32)
    for store in stores:
        for f in frames:
            store.add_keyframe(*f)
        ids = store.add_map_points(pts0, frames[-1][3][:n_pts], first_kf=0)
        for k in range(n_kf):
            store.add_observations(ids, k, np.arange(n_pts))
            store.update_connections(k)
    return stores, pts_gt, ids


def test_gather_global_and_global_ba_match_jax():
    (js, ts), _, _ = _build_maps()
    gj, gt = JGBA.gather_global(js), TGBA.gather_global(ts)
    assert gj.keys() == gt.keys()
    for k in gj:                     # gathers: floats are copies too
        np.testing.assert_array_equal(gt[k], gj[k])
    cj = JGBA.global_bundle_adjustment(js, JCAM, n_iters=12,
                                       distributed=False)
    ct = TGBA.global_bundle_adjustment(ts, CAM, n_iters=12, device="cpu")
    np.testing.assert_allclose(ct, cj, rtol=1e-3, atol=1e-6)
    _close(ts.kf_R[:5], js.kf_R[:5], 1e-3)
    _close(ts.kf_t[:5], js.kf_t[:5], 2e-3)
    _close(ts.mp_pos[:96], js.mp_pos[:96], 2e-2)
    assert ts.version == js.version


# ---------------------------------------------------------------------------
# the multi-device routes: dense and banded distributed global BA
# ---------------------------------------------------------------------------
ROUTES = {"dense": dict(distributed=True, banded=False),
          "banded": dict(distributed=True, banded=True)}


@pytest.fixture(scope="module")
def dist_routes(tmp_path_factory):
    """tests/test_torch_partition.py's chain map through both distributed
    routes: the port at world 4 (gloo ranks in CPU processes, each loading
    the saved map), the JAX package on its 8-device mesh. Returns
    {route: (port (kf_t, mp_pos, cost), JAX (kf_t, mp_pos, cost))} and
    the live keyframe and landmark ids."""
    from ar_orbslam2_tpu_torch.mapstore.checkpoint import save_map
    from ar_orbslam2_tpu_torch.parallel.multihost import spawn_local
    from test_torch_partition import CAM_KW, chain_maps

    import torch_dist_workers as W
    d = tmp_path_factory.mktemp("dist_gba")
    (js, ts), _ = chain_maps()
    save_map(ts, str(d / "map.npz"))
    spawn_local(4, W.gba_rank, str(d / "map.npz"), CAM_KW,
                list(ROUTES.values()), 12, str(d / "out.npz"),
                timeout=SPAWN_LIMIT_S)
    got = np.load(d / "out.npz")
    jcam = JCamera(**{k: CAM_KW[k] for k in ("fx", "fy", "cx", "cy", "bf")})
    out = {}
    for i, (name, kw) in enumerate(ROUTES.items()):
        (jc, _), _ = chain_maps()
        cost = JGBA.global_bundle_adjustment(jc, jcam, n_iters=12, **kw)
        out[name] = ((got[f"kf_t{i}"], got[f"mp_pos{i}"],
                      float(got[f"cost{i}"])),
                     (jc.kf_t.copy(), jc.mp_pos.copy(), cost))
    return out, ts.keyframe_ids(), ts.map_point_ids()


def test_dist_routes_dense_and_banded_agree_at_world4(dist_routes):
    """tests/test_partition.py::test_banded_gba_matches_dense's gate on
    the port: the banded exchange lands on the dense route's optimum."""
    out, kf, mp = dist_routes
    (t_d, p_d, _), _ = out["dense"]
    (t_b, p_b, _), _ = out["banded"]
    assert np.linalg.norm(t_b[kf] - t_d[kf], axis=1).max() < 5e-3
    assert np.median(np.linalg.norm(p_b[mp] - p_d[mp], axis=1)) < 5e-3


@pytest.mark.parametrize("route", list(ROUTES))
def test_dist_route_matches_jax_8_device_mesh(dist_routes, route):
    out, kf, mp = dist_routes
    (t, p, cost), (jt, jp, jcost) = out[route]
    np.testing.assert_allclose(cost, jcost, rtol=1e-3)
    _close(t[kf], jt[kf], 2e-3)
    _close(p[mp], jp[mp], 2e-2)


def test_distributed_route_without_a_group_raises():
    (_, ts), _, _ = _build_maps()
    before = ts.mp_pos.copy()
    for kw in ROUTES.values():
        with pytest.raises(RuntimeError, match="no torch.distributed"):
            TGBA.global_bundle_adjustment(ts, CAM, device="cpu", **kw)
    with pytest.raises(RuntimeError, match="no torch.distributed"):
        TGBA.dispatch_global_ba(TGBA.gather_global(ts), CAM,
                                distributed=True, device="cpu")
    np.testing.assert_array_equal(ts.mp_pos, before)


def test_rank_local_global_ba_stays_on_its_rank(tmp_path):
    """In a group of two gloo ranks, a loop closed by rank 0 alone: the
    background BA and the loop closer's inline and background BA must not
    take the distributed route (its peers would never join the
    collectives), and land where the single-device BA does."""
    from ar_orbslam2_tpu_torch.mapstore.checkpoint import load_map, save_map
    from ar_orbslam2_tpu_torch.parallel.multihost import spawn_local

    import torch_dist_workers as W
    (_, ts), _, _ = _build_maps()
    path, out = str(tmp_path / "map.npz"), str(tmp_path / "out.npz")
    save_map(ts, path)
    spawn_local(2, W.rank_local_gba_rank, path,
                dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640,
                     height=480), out, timeout=SPAWN_LIMIT_S)
    got = np.load(out)
    assert bool(got["bg_applied"])
    ref = load_map(path)
    TGBA.global_bundle_adjustment(ref, CAM, distributed=False, device="cpu")
    for key in ("bg_kf_t", "lc0_kf_t", "lc1_kf_t"):
        _close(got[key][:5], ref.kf_t[:5], 1e-5)
    assert np.abs(ref.kf_t[1:5] - ts.kf_t[1:5]).max() > 1e-4   # BA moved


@pytest.mark.parametrize("entry", ["global_bundle_adjustment",
                                   "dispatch_global_ba", "train_codebook"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """device=None means the GPU (core.device.resolve_device): without
    one these entry points raise rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (_, ts), _, _ = _build_maps()
    call = {"global_bundle_adjustment":
            lambda: TGBA.global_bundle_adjustment(ts, CAM),
            "dispatch_global_ba":
            lambda: TGBA.dispatch_global_ba(TGBA.gather_global(ts), CAM),
            "train_codebook":
            lambda: TV.train_codebook(np.zeros((70, 256), np.uint8),
                                      n_words=64)}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_background_gba_poll_applies_and_matches_jax():
    (js, ts), pts_gt, ids = _build_maps()
    jg = JBG.BackgroundGBA(js, JCAM, n_iters=12)
    tg = TBG.BackgroundGBA(ts, CAM, n_iters=12, device="cpu")
    err_before = np.abs(ts.mp_pos[ids] - pts_gt).max()
    jg.launch()
    tg.launch()
    assert tg.running()
    assert jg.poll(block=True) and tg.poll(block=True)
    assert not tg.running() and tg.n_applied == 1
    err_after = np.abs(ts.mp_pos[ids] - pts_gt).max()
    assert err_after < 0.5 * err_before
    _close(ts.kf_R[:5], js.kf_R[:5], 1e-3)
    _close(ts.kf_t[:5], js.kf_t[:5], 2e-3)
    _close(ts.mp_pos[ids], js.mp_pos[ids], 2e-2)
    assert not tg.poll()                 # nothing in flight


def test_background_gba_abort_drops_result():
    (_, ts), _, ids = _build_maps()
    before = ts.mp_pos[ids].copy()
    v0 = ts.version
    gba = TBG.BackgroundGBA(ts, CAM, n_iters=12, device="cpu")
    gba.launch()
    gba.abort()                    # mbStopGBA: a new loop invalidates it
    assert not gba.poll(block=True)
    assert np.array_equal(ts.mp_pos[ids], before) and ts.version == v0
    assert gba.n_aborted == 1 and gba.n_applied == 0


def test_background_gba_propagates_to_keyframes_created_during_ba():
    """A keyframe inserted AFTER launch is corrected through its
    spanning-tree ancestor, in both packages alike."""
    (js, ts), _, _ = _build_maps()
    out = []
    for store, gba in ((js, JBG.BackgroundGBA(js, JCAM, n_iters=12)),
                       (ts, TBG.BackgroundGBA(ts, CAM, n_iters=12,
                                              device="cpu"))):
        gba.launch()
        R_new = store.kf_R[4].copy()
        t_new = store.kf_t[4] + np.array([-0.2, 0.0, 0.0], np.float32)
        k_new = store.add_keyframe(R_new, t_new, store.kf_uv[4],
                                   store.kf_desc[4], store.kf_octave[4],
                                   store.kf_kp_valid[4])
        store.kf_parent[k_new] = 4
        R_rel = R_new @ store.kf_R[4].T
        t_rel = t_new - R_rel @ store.kf_t[4]
        assert gba.poll(block=True)
        R_rel2 = store.kf_R[k_new] @ store.kf_R[4].T
        t_rel2 = store.kf_t[k_new] - R_rel2 @ store.kf_t[4]
        assert np.isfinite(store.kf_R[k_new]).all()
        _close(R_rel2, R_rel, 1e-4)
        _close(t_rel2, t_rel, 1e-4)
        out.append((store.kf_R[k_new].copy(), store.kf_t[k_new].copy()))
    _close(out[1][0], out[0][0], 1e-3)
    _close(out[1][1], out[0][1], 2e-3)


# ---------------------------------------------------------------------------
# vocabulary training
# ---------------------------------------------------------------------------
def test_train_codebook_and_assign_words_match_jax():
    rng = np.random.default_rng(9)
    centres = (rng.random((40, 256)) < 0.5).astype(np.uint8)
    flips = (rng.random((1500, 256)) < 0.08).astype(np.uint8)
    bits = centres[rng.integers(0, 40, 1500)] ^ flips
    words_bits = (rng.random((64, 256)) < 0.5).astype(np.uint8)
    signs = bits.astype(np.int8) * 2 - 1
    a_j = JV.assign_words(signs, jnp.asarray(words_bits.astype(np.int8) * 2
                                             - 1), chunk=512)
    a_t = TV.assign_words(signs, TH.to_signs(words_bits), chunk=512)
    np.testing.assert_array_equal(a_t, a_j)
    cb_j = JV.train_codebook(bits, n_words=64, n_iters=6, seed=3)
    cb_t = TV.train_codebook(bits, n_words=64, n_iters=6, seed=3,
                             device="cpu")
    np.testing.assert_array_equal(cb_t, cb_j)
    # fewer descriptors than words: padded with random words alike
    np.testing.assert_array_equal(
        TV.train_codebook(bits[:40], n_words=64, n_iters=2, seed=1,
                          device="cpu"),
        JV.train_codebook(bits[:40], n_words=64, n_iters=2, seed=1))
