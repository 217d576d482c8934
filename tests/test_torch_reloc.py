"""The port's relocalization slice against the JAX package on the CPU:
place recognition (vocabulary transform, L1 scores, candidate lists), the
batched DLT-PnP RANSAC, the Relocalizer on a map carried across with
interop, and the slice as a whole (a LOST tracker recovers), per-frame and
with fused tracking + async mapping configured.

Inputs come from numpy seeds and go through both packages. Tolerances:
integer outputs (words, candidate lists, inlier masks, landmark bindings)
are exact; bow vectors and scores agree to 1e-6 (float32 sums of <= 4096
terms in another order); poses to 1e-4 (the two LAPACKs' eigenvectors
agree to ~1e-6 where the smallest eigenvalue is separated, and the pose
optimizations are the same float32 iterations). The RANSAC draw is JAX's,
handed to the port, because the two frameworks' generators differ.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ar_orbslam2_tpu.core.camera import Camera as JCamera
from ar_orbslam2_tpu.data import synthetic
from ar_orbslam2_tpu.estimation import pnp as jpnp
from ar_orbslam2_tpu.loop import place_recognition as jpr
from ar_orbslam2_tpu.mapping.local_mapping import (
    LocalMapperConfig as JMapperConfig)
from ar_orbslam2_tpu.mapstore.map import MapConfig as JMapConfig
from ar_orbslam2_tpu.mapstore.map import MapStore as JMapStore
from ar_orbslam2_tpu.ops import hamming as JH
from ar_orbslam2_tpu.system.slam import SlamConfig as JSlamConfig
from ar_orbslam2_tpu.system.slam import SlamSystem as JSlamSystem
from ar_orbslam2_tpu.system.tracking import TrackingConfig as JTrackingConfig
from ar_orbslam2_tpu_torch import interop
from ar_orbslam2_tpu_torch.core.camera import Camera
from ar_orbslam2_tpu_torch.estimation import pnp as tpnp
from ar_orbslam2_tpu_torch.loop import place_recognition as tpr
from ar_orbslam2_tpu_torch.mapping.local_mapping import LocalMapperConfig
from ar_orbslam2_tpu_torch.mapstore.map import MapConfig, MapStore
from ar_orbslam2_tpu_torch.ops import hamming as TH
from ar_orbslam2_tpu_torch.system.frame import Frame
from ar_orbslam2_tpu_torch.system.slam import SlamConfig, SlamSystem
from ar_orbslam2_tpu_torch.system.tracking import TrackingConfig

CAM = Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)
JCAM = JCamera(fx=500.0, fy=500.0, cx=320.0, cy=240.0)
SIZES = dict(map=dict(max_keyframes=64, max_map_points=20_000, max_kp=512),
             tracking=dict(max_kp=512, n_local_mp=2048,
                           max_frames_between_kf=5),
             mapper=dict(ba_max_points=2048, n_triangulation_neighbors=5,
                         n_fuse_neighbors=5))


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The port's steps are chains of tiny ops: more intra-op threads buy
    nothing and fight the other test workers for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port_cfg(fused=False, async_mapping=False):
    return SlamConfig(map=MapConfig(**SIZES["map"]),
                      tracking=TrackingConfig(**SIZES["tracking"]),
                      mapper=LocalMapperConfig(**SIZES["mapper"]),
                      use_fused_tracking=fused, async_mapping=async_mapping,
                      enable_loop_closing=False, enable_relocalization=True)


def _jax_cfg():
    return JSlamConfig(map=JMapConfig(**SIZES["map"]),
                       tracking=JTrackingConfig(**SIZES["tracking"]),
                       mapper=JMapperConfig(**SIZES["mapper"]),
                       use_fused_tracking=False, async_mapping=False,
                       enable_loop_closing=False, enable_relocalization=True)


def _feats(scene, i, **kw):
    obs = synthetic.observe_frame(scene, i, JCAM, max_kp=512, noise_px=0.3,
                                  bit_flip=0.02, **kw)
    return dict(uv=obs["uv"], desc=obs["desc"], octave=obs["octave"],
                valid=obs["valid"])


# ---------------------------------------------------------------------------
# place recognition
# ---------------------------------------------------------------------------
def test_vocab_transform_and_l1_scores():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (512, 256)).astype(np.uint8)
    valid = rng.random(512) > 0.2
    jv, tv = jpr.VocabTensor(), tpr.VocabTensor(device="cpu")
    assert np.array_equal(np.asarray(jv.signs), tv.signs.numpy())
    words_j, bow_j = jv.transform(JH.to_signs(bits), jnp.asarray(valid))
    words_t, bow_t = tv.transform(TH.to_signs(bits), torch.as_tensor(valid))
    assert np.array_equal(np.asarray(words_j), words_t.numpy())
    assert np.abs(np.asarray(bow_j) - bow_t.numpy()).max() <= 1e-6
    assert abs(float(bow_t.sum()) - 1.0) < 1e-5

    db = rng.random((40, 4096)).astype(np.float32)
    db /= db.sum(-1, keepdims=True)
    db_valid = rng.random(40) > 0.3
    s_j = jpr.l1_scores(bow_j, jnp.asarray(db), jnp.asarray(db_valid))
    s_t = tpr.l1_scores(bow_t, torch.as_tensor(db), torch.as_tensor(db_valid))
    assert np.abs(np.asarray(s_j) - s_t.numpy()).max() <= 1e-6
    assert np.array_equal(s_t.numpy() == -1.0, ~db_valid)


def _orbit_databases():
    """The 12-keyframe orbit scene of tests/test_loop_reloc.py in both
    packages' stores and databases, with a shared landmark set so that the
    keyframes are covisible."""
    scene = synthetic.make_scene(n_landmarks=1200, n_frames=12, seed=5,
                                 trajectory="orbit", arc=1.6)
    cfg = dict(max_keyframes=32, max_map_points=4096, max_kp=512)
    js, ts = JMapStore(JMapConfig(**cfg)), MapStore(MapConfig(**cfg))
    jdb, tdb = jpr.KeyFrameDatabase(js), tpr.KeyFrameDatabase(ts,
                                                              device="cpu")
    obs_all = []
    for i in range(12):
        obs = synthetic.observe_frame(scene, i, JCAM, max_kp=512,
                                      bit_flip=0.02)
        obs_all.append(obs)
        for s in (js, ts):
            s.add_keyframe(scene.R_cw[i], scene.t_cw[i], obs["uv"],
                           JH.pack_bits(obs["desc"]), obs["octave"],
                           obs["valid"])
    # landmarks seen by neighbouring keyframes: a covisibility graph
    for s in (js, ts):
        for i in range(11):
            a, b = obs_all[i], obs_all[i + 1]
            shared = np.intersect1d(a["landmark_id"][a["valid"]],
                                    b["landmark_id"][b["valid"]])[:60]
            fa = np.array([np.nonzero(a["landmark_id"] == lm)[0][0]
                           for lm in shared])
            fb = np.array([np.nonzero(b["landmark_id"] == lm)[0][0]
                           for lm in shared])
            ids = s.add_map_points(scene.landmarks[shared].astype(np.float32),
                                   JH.pack_bits(a["desc"][fa]), first_kf=i)
            s.add_observations(ids, i, fa)
            s.add_observations(ids, i + 1, fb)
        for i in range(12):
            s.update_connections(i)
    for i in range(12):
        jdb.add(i)
        tdb.add(i)
    return scene, jdb, tdb


def test_candidate_lists_match_on_the_orbit_scene():
    scene, jdb, tdb = _orbit_databases()
    assert np.abs(jdb.bow - tdb.bow).max() <= 1e-6
    assert np.array_equal(jdb.has_bow, tdb.has_bow)
    assert len(tdb.store.covisible_keyframes(3)) >= 1
    for view, seed in ((2, 999), (7, 5), (10, 77)):
        obs = synthetic.observe_frame(scene, view, JCAM, max_kp=512,
                                      bit_flip=0.03, seed=seed)
        words_j, bow_j = jdb.compute_bow(obs["desc"], obs["valid"])
        words_t, bow_t = tdb.compute_bow(obs["desc"], obs["valid"])
        assert np.array_equal(words_j, words_t)
        assert np.abs(bow_j - bow_t).max() <= 1e-6
        cands = tdb.detect_relocalization_candidates(bow_t)
        assert cands == jdb.detect_relocalization_candidates(bow_j)
        assert len(cands) >= 1
    for kf in (0, 5, 11):
        assert tdb.detect_loop_candidates(kf) == \
            jdb.detect_loop_candidates(kf)
    # maybe_retrain is ported (tests/test_torch_loop.py holds a training):
    # below its 24 keyframes neither package trains
    assert tdb.maybe_retrain() is False and jdb.maybe_retrain() is False
    assert np.abs(jdb.bow - tdb.bow).max() <= 1e-6


def test_database_add_races_no_score():
    """The mapping worker adds rows while the tracking thread scores: every
    score list is one the database could give between two adds (a row is
    either absent, -1, or complete), and the final state is the serial one."""
    _, _, tdb = _orbit_databases()
    rows = tdb.bow[:12].copy()
    query = rows[4]
    want = np.minimum(query[None], rows).sum(-1)
    fresh = tpr.KeyFrameDatabase(tdb.store, device="cpu")
    seen, stop = [], threading.Event()

    def score():
        while not stop.is_set():
            seen.append(fresh._scores(query))

    reader = threading.Thread(target=score)
    reader.start()
    for rep in range(20):
        for kf in range(12):
            fresh.add(kf, bow=rows[kf])
    stop.set()
    reader.join()
    seen.append(fresh._scores(query))
    assert len(seen) > 1
    for s in seen:
        have = s[:12] >= 0
        assert np.abs(s[:12][have] - want[have]).max(initial=0.0) <= 1e-6
        assert np.all(s[12:] == -1.0)
    assert np.all(seen[-1][:12] >= 0)
    assert np.array_equal(fresh._bow_dev.numpy(), fresh.bow)


# ---------------------------------------------------------------------------
# PnP
# ---------------------------------------------------------------------------
def _pnp_scene():
    """The scene of tests/test_pnp_sim3.py::test_pnp_ransac_recovers_pose."""
    rng = np.random.default_rng(1)
    N = 256
    xw = rng.uniform([-2, -2, 3], [2, 2, 8], (N, 3)).astype(np.float32)
    w = np.random.default_rng(2).normal(0, 0.2, 3).astype(np.float32)
    from ar_orbslam2_tpu.core import lie
    R = np.asarray(lie.so3_exp(jnp.asarray(w)))
    t = np.random.default_rng(2).normal(0, 0.3, 3).astype(np.float32)
    t[2] = abs(t[2])
    xc = xw @ R.T + t
    uv = np.stack([500 * xc[:, 0] / xc[:, 2] + 320,
                   500 * xc[:, 1] / xc[:, 2] + 240], -1).astype(np.float32)
    uv += rng.normal(0, 0.3, uv.shape).astype(np.float32)
    n_out = N // 5
    uv[:n_out] = rng.uniform([0, 0], [640, 480], (n_out, 2))
    return xw, uv.astype(np.float32), R, t, n_out


def test_dlt_pose_matches_jax_on_well_conditioned_samples():
    """12 distinct points with exact projections: the normal matrix has one
    null vector, well separated, and both LAPACKs find it."""
    _, _, R, t, _ = _pnp_scene()
    rng = np.random.default_rng(3)
    xw = rng.uniform(-1, 1, (256, 3)).astype(np.float32)
    t = (t + np.array([0, 0, 3.0])).astype(np.float32)
    xc = xw @ R.T + t
    xn = (xc[:, :2] / xc[:, 2:]).astype(np.float32)
    samples = np.stack([rng.choice(256, 48, replace=False)
                        for _ in range(32)])
    R_t, t_t = tpnp._dlt_pose(torch.as_tensor(xw[samples]),
                              torch.as_tensor(xn[samples]))
    R_j, t_j = jax.vmap(jpnp._dlt_pose)(jnp.asarray(xw[samples]),
                                        jnp.asarray(xn[samples]))
    assert np.abs(R_t.numpy() - np.asarray(R_j)).max() <= 1e-4
    assert np.abs(t_t.numpy() - np.asarray(t_j)).max() <= 1e-4
    assert np.abs(R_t.numpy() - R).max() < 1e-3
    assert np.abs(t_t.numpy() - t).max() < 1e-3


def test_pnp_ransac_with_the_jax_draw():
    """Same draw, same winner. A 6-point sample's 12x12 normal matrix is
    nearly singular twice over in float32, so one sample's pose differs by
    up to ~1e-3 between any two eigensolvers (the JAX function's own jitted
    and eager runs count 197 and 193 inliers here): the raw winner is held
    to 5e-3 and to <= 3% of the chi2 decisions; after the motion-only BA
    that relocalization runs on the winner's inliers (here on one inlier
    set for both), the two packages' poses agree to 1e-4."""
    from ar_orbslam2_tpu.estimation.pose_opt import (
        pose_optimization as jpose_opt)
    from ar_orbslam2_tpu_torch.estimation.pose_opt import (
        pose_optimization as tpose_opt)
    xw, uv, R, t, n_out = _pnp_scene()
    N = 256
    valid = np.ones(N, bool)
    key = jax.random.PRNGKey(0)
    jx, juv, joct, jval = (jnp.asarray(xw), jnp.asarray(uv),
                           jnp.zeros(N, jnp.int32), jnp.asarray(valid))
    out_j = jpnp.pnp_ransac(jx, juv, joct, jval, JCAM, key)
    p = valid.astype(np.float32) / valid.sum()
    samples = np.array(jax.random.choice(
        key, N, (256, jpnp.MIN_SAMPLE), replace=True, p=jnp.asarray(p)))
    tx, tuv, toct, tval = (torch.as_tensor(xw), torch.as_tensor(uv),
                           torch.zeros(N, dtype=torch.int32),
                           torch.as_tensor(valid))
    out_t = tpnp.pnp_ransac(tx, tuv, toct, tval, CAM,
                            samples=torch.as_tensor(samples))
    assert bool(out_t["ok"]) and bool(out_j["ok"])
    assert abs(int(out_t["n_inliers"]) - int(out_j["n_inliers"])) <= 0.03 * N
    differ = out_t["inlier"].numpy() != np.asarray(out_j["inlier"])
    assert differ.sum() <= 0.03 * N
    assert np.abs(out_t["R"].numpy() - np.asarray(out_j["R"])).max() <= 5e-3
    assert np.abs(out_t["t"].numpy() - np.asarray(out_j["t"])).max() <= 5e-3
    assert np.abs(out_t["R"].numpy() - R).max() < 0.02
    res_j = jpose_opt(out_j["R"], out_j["t"], jx, juv, joct,
                      jval & out_j["inlier"], JCAM)
    # (one inlier set for both: the optimum depends on it)
    res_t = tpose_opt(out_t["R"], out_t["t"], tx, tuv, toct,
                      torch.as_tensor(np.array(out_j["inlier"])), CAM)
    assert np.abs(res_t["R"].numpy() - np.asarray(res_j["R"])).max() <= 1e-4
    assert np.abs(res_t["t"].numpy() - np.asarray(res_j["t"])).max() <= 1e-4
    # the port's own draw: valid rows only, and a pose as good
    gen = torch.Generator().manual_seed(5)
    half = torch.as_tensor(np.arange(N) % 2 == 0)
    drawn = tpnp.draw_samples(half, 64, gen)
    assert drawn.shape == (64, tpnp.MIN_SAMPLE) and bool(half[drawn].all())
    own = tpnp.pnp_ransac(tx, tuv, toct, tval, CAM, generator=gen)
    assert bool(own["ok"]) and int(own["n_inliers"]) > 0.7 * (N - n_out)


def test_pnp_on_coplanar_landmarks():
    """A fault of the reference that the port repairs: on coplanar
    landmarks (the bench scene is a textured plane) the 12-parameter DLT is
    degenerate, so neither the JAX function nor the port's general
    hypotheses (the first 256 scores) explain more than a few matches; with
    the plane-homography hypothesis of every sample the port recovers the
    pose.
    In general position (the scene above) the general hypotheses still win."""
    rng = np.random.default_rng(1)
    N, n_out = 448, 64
    xw = rng.uniform([-1.5, -1.2, 3], [1.5, 1.2, 3], (N, 3))
    xw[:, 2] += rng.normal(0, 1e-2, N)          # a BA'd plane: 1 cm of depth
    xw = xw.astype(np.float32)
    th = 0.2
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]], np.float32)
    t = np.array([0.3, -0.1, 0.2], np.float32)
    xc = xw @ R.T + t
    uv = np.stack([500 * xc[:, 0] / xc[:, 2] + 320,
                   500 * xc[:, 1] / xc[:, 2] + 240], -1)
    uv += rng.normal(0, 0.5, uv.shape)
    uv[:n_out] = rng.uniform([0, 0], [640, 480], (n_out, 2))
    uv = uv.astype(np.float32)
    out_j = jpnp.pnp_ransac(jnp.asarray(xw), jnp.asarray(uv),
                            jnp.zeros(N, jnp.int32), jnp.ones(N, bool),
                            JCAM, jax.random.PRNGKey(0))
    assert int(out_j["n_inliers"]) < 0.1 * (N - n_out)
    args = (torch.as_tensor(xw), torch.as_tensor(uv),
            torch.zeros(N, dtype=torch.int32),
            torch.ones(N, dtype=torch.bool), CAM)
    gen = torch.Generator().manual_seed(0)
    samples = tpnp.draw_samples(args[3], 256, gen)
    out = tpnp.pnp_ransac(*args, samples=samples)
    assert out["scores"].shape == (512,) and int(out["best"]) >= 256
    assert int(out["scores"][:256].max()) < 0.1 * (N - n_out)
    assert bool(out["ok"]) and int(out["n_inliers"]) > 0.95 * (N - n_out)
    assert not bool(out["inlier"][:n_out].any())
    assert np.abs(out["R"].numpy() - R).max() < 0.02
    assert np.abs(out["t"].numpy() - t).max() < 0.05
    # general position: the first 256 (general) hypotheses hold the winner
    xw3, uv3, _, _, _ = _pnp_scene()
    gen3 = tpnp.pnp_ransac(torch.as_tensor(xw3), torch.as_tensor(uv3),
                           torch.zeros(256, dtype=torch.int32),
                           torch.ones(256, dtype=torch.bool), CAM,
                           generator=gen)
    assert int(gen3["best"]) < 256


# ---------------------------------------------------------------------------
# the relocalizer on a carried map, and the slice as a whole
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reloc_scene():
    return synthetic.make_scene(n_landmarks=1500, n_frames=24, seed=3,
                                trajectory="orbit", arc=0.8)


def _frame(feats, frame_id, device="cpu"):
    return Frame(uv=feats["uv"].astype(np.float32),
                 desc_bits=feats["desc"].astype(np.uint8),
                 octave=feats["octave"].astype(np.int32),
                 valid=feats["valid"].astype(bool), frame_id=frame_id,
                 device=device)


def test_relocalizer_matches_jax_on_a_carried_map(reloc_scene):
    from ar_orbslam2_tpu.system.frame import Frame as JFrame
    scene = reloc_scene
    jslam = JSlamSystem(JCAM, _jax_cfg())
    for i in range(16):
        jslam.track_monocular(features=_feats(scene, i),
                              timestamp=scene.timestamps[i])
    assert jslam.tracking.state == "OK" and jslam.store.n_keyframes() >= 2
    slam = interop.from_state(CAM, _port_cfg(), interop.export_state(jslam),
                              device="cpu")
    assert np.array_equal(slam.kfdb.has_bow, jslam.kfdb.has_bow)
    assert np.array_equal(slam.kfdb._bow_dev.numpy(), jslam.kfdb.bow)

    feats = _feats(scene, 5)
    jrel, trel = jslam.tracking.relocalizer, slam.tracking.relocalizer
    key = {"k": jrel._key}

    def jax_draw(valid):            # the draw JAX's relocalize will make
        key["k"], sub = jax.random.split(key["k"])
        p = valid.astype(np.float32)
        p = p / max(p.sum(), 1.0)
        return torch.as_tensor(np.asarray(jax.random.choice(
            sub, len(valid), (256, jpnp.MIN_SAMPLE), replace=True,
            p=jnp.asarray(p))))
    trel.draw = jax_draw

    jf = JFrame(uv=feats["uv"].astype(np.float32),
                desc_bits=feats["desc"].astype(np.uint8),
                octave=feats["octave"].astype(np.int32),
                valid=feats["valid"].astype(bool), frame_id=100)
    tf = _frame(feats, 100)
    n_j = jrel.relocalize(jf)
    n_t = trel.relocalize(tf)
    assert n_j is not None and n_t == n_j
    stats = trel.last_stats
    assert stats["candidates"] == jrel._candidates(jf)
    assert stats["ok"] and stats["final_inliers"] == n_t
    assert stats["syncs"] == 2 + 4 * stats["tried"]
    assert np.array_equal(tf.mp, jf.mp)
    assert (tf.mp >= 0).sum() >= 50
    assert np.abs(tf.R - jf.R).max() <= 1e-4
    assert np.abs(tf.t - jf.t).max() <= 1e-4


def _jax_draw(key):
    """The draw JAX's relocalize makes for each PnP, from the key it holds
    in key["k"] (split once per PnP, as the JAX Relocalizer does)."""
    def draw(valid):
        key["k"], sub = jax.random.split(key["k"])
        p = valid.astype(np.float32)
        p = p / max(p.sum(), 1.0)
        return torch.as_tensor(np.array(jax.random.choice(
            sub, len(valid), (256, jpnp.MIN_SAMPLE), replace=True,
            p=jnp.asarray(p))))
    return draw


@pytest.mark.parametrize("decoy", ["few_matches", "pnp_fails"])
def test_relocalizer_walks_several_candidates_like_jax(reloc_scene, decoy,
                                                       monkeypatch):
    """Two candidates, the first a decoy keyframe that both packages
    reject and walk past, the second the real one. Its 200 landmarks
    carry random descriptors (too few matches: no PnP), or the query's
    own descriptors at random positions (matched; the PnP finds no pose:
    the failed-PnP branch). The JAX draw is injected; the key the JAX
    Relocalizer ends with counts its PnP runs, which the port's draws
    must match."""
    from ar_orbslam2_tpu.system.frame import Frame as JFrame
    scene = reloc_scene
    jslam = JSlamSystem(JCAM, _jax_cfg())
    for i in range(16):
        jslam.track_monocular(features=_feats(scene, i),
                              timestamp=scene.timestamps[i])
    slam = interop.from_state(CAM, _port_cfg(), interop.export_state(jslam),
                              device="cpu")
    feats = _feats(scene, 5)
    jf = JFrame(uv=feats["uv"].astype(np.float32),
                desc_bits=feats["desc"].astype(np.uint8),
                octave=feats["octave"].astype(np.int32),
                valid=feats["valid"].astype(bool), frame_id=100)
    jrel, trel = jslam.tracking.relocalizer, slam.tracking.relocalizer
    good = jrel._candidates(jf)[0]

    rng = np.random.default_rng(4)
    n = 200
    if decoy == "few_matches":
        bits = (rng.random((n, 256)) < 0.5).astype(np.uint8)
    else:
        bits = feats["desc"][np.nonzero(feats["valid"])[0][:n]]
    pos = rng.uniform([-3, -3, 3], [3, 3, 9], (n, 3)).astype(np.float32)
    uv = np.zeros((512, 2), np.float32)
    uv[:n] = rng.uniform([0, 0], [640, 480], (n, 2))
    kp_desc = np.zeros((512, 32), np.uint8)
    kp_desc[:n] = TH.pack_bits(bits)
    kp_valid = np.arange(512) < n
    for st in (jslam.store, slam.store):        # the same calls: same ids
        k = st.add_keyframe(np.eye(3, dtype=np.float32),
                            np.zeros(3, np.float32), uv, kp_desc,
                            np.zeros(512, np.int32), kp_valid)
        ids = st.add_map_points(pos, TH.pack_bits(bits), first_kf=k)
        st.add_observations(ids, k, np.arange(n))
    for db in (jslam.kfdb, slam.kfdb):
        monkeypatch.setattr(db, "detect_relocalization_candidates",
                            lambda bow, k=k: [k, good])

    key = {"k": jrel._key}
    trel.draw = _jax_draw(key)
    tf = _frame(feats, 100)
    n_j = jrel.relocalize(jf)
    n_t = trel.relocalize(tf)
    stats = trel.last_stats
    assert n_j is not None and n_t == n_j
    assert stats["candidates"] == [k, good] and stats["tried"] == 2
    assert stats["kf"] == good and stats["ok"]
    # reads: bow + scores, one match per candidate, one per PnP (few
    # matches: the real candidate's alone; a failed PnP: two), the refine
    # and the top-up of the one that succeeded
    n_pnp = 1 if decoy == "few_matches" else 2
    assert stats["syncs"] == 2 + 2 + n_pnp + 2
    assert np.array_equal(np.asarray(key["k"]), np.asarray(jrel._key))
    assert np.array_equal(tf.mp, jf.mp)
    assert np.abs(tf.R - jf.R).max() <= 1e-4
    assert np.abs(tf.t - jf.t).max() <= 1e-4


@pytest.mark.parametrize("fused_async", [False, True])
def test_relocalization_recovers_from_lost(reloc_scene, fused_async):
    """The JAX package's test of the same name, on the port: a forced LOST
    tracker revisits an early viewpoint and relocalizes within 0.1 of the
    pose it tracked there in the first pass."""
    scene = reloc_scene
    slam = SlamSystem(CAM, _port_cfg(fused_async, fused_async), device="cpu")
    for i in range(16):
        slam.track_monocular(features=_feats(scene, i),
                             timestamp=scene.timestamps[i])
    assert slam.tracking.state == "OK"
    assert slam.store.n_keyframes() >= 2
    if fused_async:
        slam.tracking.async_mapper.join()
    assert slam.kfdb.has_bow[slam.store.keyframe_ids()].all()
    slam.tracking.state = "LOST"
    slam.tracking.velocity = None
    slam.tracking.last_frame = None
    ok = False
    for i in [5, 6, 7]:
        T = slam.track_monocular(features=_feats(scene, i),
                                 timestamp=scene.timestamps[i] + 10.0)
        if T is not None:
            ok = True
            old = [m for m in slam.tracking.metrics
                   if m["frame_id"] == i and "t" in m]
            assert old
            c_old = -(old[0]["R"].T @ old[0]["t"])
            c_new = -(T[:3, :3].T @ T[:3, 3])
            assert np.linalg.norm(c_new - c_old) < 0.1
            break
    assert ok, "relocalization failed"
    t = slam.tracking
    assert t.state == "OK" and t.n_resets == 0
    assert t.last_reloc_frame_id == t.metrics[-1]["frame_id"]
    assert t.metrics[-1]["reloc"]["ok"]
    assert t.relocalizer.n_success == 1
    # and tracking goes on from the relocalized frame
    T = slam.track_monocular(features=_feats(scene, 8),
                             timestamp=scene.timestamps[8] + 10.0)
    assert T is not None and t.state == "OK"
    slam.shutdown()


def test_lost_without_candidates_stays_lost_and_keeps_the_map(reloc_scene):
    """A frame with no features (a grey image) cannot relocalize: the
    tracker stays LOST; with more keyframes than the early-loss limit the
    map is kept."""
    scene = reloc_scene
    cfg = _port_cfg()
    cfg.tracking = TrackingConfig(**dict(SIZES["tracking"],
                                         reset_if_lost_before_kfs=1))
    slam = SlamSystem(CAM, cfg, device="cpu")
    for i in range(12):
        slam.track_monocular(features=_feats(scene, i),
                             timestamp=scene.timestamps[i])
    n_kf = slam.store.n_keyframes()
    assert slam.tracking.state == "OK" and n_kf > 1
    blank = dict(uv=np.zeros((512, 2), np.float32),
                 desc=np.zeros((512, 256), np.uint8),
                 octave=np.zeros(512, np.int32), valid=np.zeros(512, bool))
    for j in range(2):
        assert slam.track_monocular(features=blank, timestamp=20.0 + j) is None
        assert slam.tracking.state == "LOST"
    assert slam.tracking.n_resets == 0 and slam.store.n_keyframes() == n_kf
    stats = slam.tracking.relocalizer.last_stats
    assert not stats["ok"] and stats["matches"] == 0
    # no score above 0: the newest keyframes are tried instead
    newest = [int(k) for k in slam.store.keyframe_ids()[::-1][:5]]
    assert stats["candidates"] == newest
    T = slam.track_monocular(features=_feats(scene, 9), timestamp=30.0)
    assert T is not None and slam.tracking.state == "OK"
