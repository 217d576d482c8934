"""Global bundle adjustment and the vocabulary training of the port's
loop-closing slice against the JAX package on the CPU: the full-map gather
and run, the background GBA protocol (its three cases in
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


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The port's stages are chains of small ops: more intra-op threads buy
    nothing and fight the other test workers for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
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


def test_multi_device_global_ba_routes_raise():
    (_, ts), _, _ = _build_maps()
    for kw in (dict(distributed=True), dict(banded=True)):
        with pytest.raises(NotImplementedError, match="item 6"):
            TGBA.global_bundle_adjustment(ts, CAM, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="item 6"):
        TGBA.dispatch_global_ba(TGBA.gather_global(ts), CAM,
                                distributed=True, device="cpu")


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
