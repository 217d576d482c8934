"""The port's loop closer against the JAX package on the CPU, and the slice
as a whole.

One port run of the full-circle orbit (tests/test_loop_reloc.py's loop
scene, 512 keypoints, per-frame path, loop closing and relocalization on)
is made once per module. It must close a loop with a plausible scale, and
it keeps the state from just before the keyframe that closed its first
loop. That state goes into a JAX SlamSystem; interop carries the JAX
system's state (map, database, loop closer, loop edges) into a port
system, and the two loop closers then run the same keyframe: candidates,
the brute-force match, the SearchBySim3 top-up, the refined Sim3, the
projection top-up, the correction and the essential graph.

Tolerances: integer outputs exact (candidates, matches, the correspondence
pairs, inlier and total counts, kf_mp, loop edges, covisibility); the
refined S12 1e-4; poses and landmarks after the correction and the
essential graph 1e-4 (the dense solver path at 64 keyframes, held to 1e-4
on its own in tests/test_torch_sim3.py). The RANSAC draw is the
JAX package's, handed to the port (the generators differ); the raw RANSAC
winner is not compared here (tests/test_torch_sim3.py holds it), the
refinement from the JAX winner is.
"""
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ar_orbslam2_tpu.core.camera import Camera as JCamera
from ar_orbslam2_tpu.data import synthetic
from ar_orbslam2_tpu.loop import loop_closing as jloop
from ar_orbslam2_tpu.loop import place_recognition as jpr
from ar_orbslam2_tpu.mapping.local_mapping import (
    LocalMapperConfig as JMapperConfig)
from ar_orbslam2_tpu.mapstore.map import MapConfig as JMapConfig
from ar_orbslam2_tpu.system.slam import SlamConfig as JSlamConfig
from ar_orbslam2_tpu.system.slam import SlamSystem as JSlamSystem
from ar_orbslam2_tpu.system.tracking import TrackingConfig as JTrackingConfig
from ar_orbslam2_tpu_torch import interop
from ar_orbslam2_tpu_torch.core.camera import Camera
from ar_orbslam2_tpu_torch.loop import loop_closing as tloop
from ar_orbslam2_tpu_torch.loop import place_recognition as tpr
from ar_orbslam2_tpu_torch.mapping.async_mapper import AsyncMapper
from ar_orbslam2_tpu_torch.mapping.local_mapping import LocalMapperConfig
from ar_orbslam2_tpu_torch.mapstore.checkpoint import _ARRAYS
from ar_orbslam2_tpu_torch.mapstore.map import MapConfig
from ar_orbslam2_tpu_torch.system.slam import SlamConfig, SlamSystem
from ar_orbslam2_tpu_torch.system.tracking import TrackingConfig

CAM = Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)
JCAM = JCamera(fx=500.0, fy=500.0, cx=320.0, cy=240.0)
SIZES = dict(map=dict(max_keyframes=64, max_map_points=20_000, max_kp=512),
             tracking=dict(max_kp=512, n_local_mp=2048,
                           max_frames_between_kf=5),
             mapper=dict(ba_max_points=2048, n_triangulation_neighbors=5,
                         n_fuse_neighbors=5))
# tests/test_loop_reloc.py's loop-closer settings
LOOP = dict(min_kf_gap=8, consistency_threshold=1, run_global_ba=True)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The port's stages are chains of small ops: more intra-op threads buy
    nothing and fight the other test workers for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port_cfg(**kw):
    base = dict(map=MapConfig(**SIZES["map"]),
                tracking=TrackingConfig(**SIZES["tracking"]),
                mapper=LocalMapperConfig(**SIZES["mapper"]),
                use_fused_tracking=False, async_mapping=False)
    base.update(kw)
    return SlamConfig(**base)


def _jax_cfg():
    return JSlamConfig(map=JMapConfig(**SIZES["map"]),
                       tracking=JTrackingConfig(**SIZES["tracking"]),
                       mapper=JMapperConfig(**SIZES["mapper"]),
                       use_fused_tracking=False, async_mapping=False)


def _feats(scene, i):
    obs = synthetic.observe_frame(scene, i, JCAM, max_kp=512, noise_px=0.3,
                                  bit_flip=0.02)
    return dict(uv=obs["uv"], desc=obs["desc"], octave=obs["octave"],
                valid=obs["valid"])


@pytest.fixture(scope="module")
def orbit_run():
    """The port on the full-circle orbit, with the state kept from just
    before the keyframe that closed the first loop."""
    scene = synthetic.make_scene(n_landmarks=2500, n_frames=64, seed=11,
                                 trajectory="orbit", arc=2 * np.pi * 0.999)
    slam = SlamSystem(CAM, _port_cfg(), device="cpu")
    lc = slam.tracking.loop_closer
    lc.cfg = tloop.LoopCloserConfig(**LOOP)
    insert = lc.insert_keyframe
    before = {}

    def watched(kf):
        state = interop.export_state(slam)
        closed = insert(kf)
        if closed and "state" not in before:
            before.update(state=state, kf=kf)
        return closed
    lc.insert_keyframe = watched
    tracked = 0
    for i in range(scene.n_frames):
        T = slam.track_monocular(features=_feats(scene, i),
                                 timestamp=scene.timestamps[i])
        tracked += T is not None
    slam.shutdown()
    return dict(scene=scene, slam=slam, tracked=tracked, **before)


def test_port_closes_the_orbit_loop(orbit_run):
    slam, scene = orbit_run["slam"], orbit_run["scene"]
    lc = slam.tracking.loop_closer
    assert orbit_run["tracked"] > scene.n_frames * 0.7
    assert len(lc.loops) >= 1, "no loop closed on a full-circle revisit"
    assert 0.5 < lc.loops[0]["s12"] < 2.0
    assert lc.loops[0]["n_total"] >= 40
    # the correction launched a global BA, and shutdown applied it
    assert lc.gba.n_launched >= 1 and lc.gba.n_applied >= 1
    assert not lc.gba.running()
    assert lc.kfdb is slam.kfdb is slam.tracking.relocalizer.kfdb
    for kf, cands in slam.store.kf_loop_edges.items():
        for c in cands:
            assert kf in slam.store.kf_loop_edges[c]
    st = lc.stats_log[-1]
    for stage in ("detect", "bf_match", "ransac", "search_by_sim3",
                  "optimize_sim3", "topup", "correction", "essential_graph",
                  "gba_launch"):
        assert st[f"t_{stage}_ms"] >= 0.0


def _jax_system(state):
    """A JAX SlamSystem holding an exported state (test helper: the
    direction interop does not carry)."""
    jslam = JSlamSystem(JCAM, _jax_cfg())
    s = jslam.store
    for name in _ARRAYS:
        getattr(s, name)[...] = state["map"][name]
    s.next_kf = int(state["next_kf"])
    s.mp_replaced[...] = state["mp_replaced"]
    s.mp_free = [int(i) for i in state["mp_free"]]
    s.kf_loop_edges = {int(k): set(v) for k, v in
                       state["loop_edges"].items()}
    s.bump()
    jslam.mapper.recent = dict(state["mapper_recent"])
    db, lc = state["kfdb"], jslam.tracking.loop_closer
    lc.kfdb.vocab = jpr.VocabTensor(bits=db["vocab_bits"])
    lc.kfdb.bow[...] = db["bow"]
    lc.kfdb.has_bow[...] = db["has_bow"]
    lc.kfdb._bow_dev = None
    lc.kfdb.trained = db["trained"]
    lc.kfdb._trained_at = db["trained_at"]
    lc.cfg = jloop.LoopCloserConfig(**LOOP)
    ls = state["loop_closer"]
    lc.last_loop_kf = ls["last_loop_kf"]
    lc.consistent_groups = [(set(g), c) for g, c in ls["consistent_groups"]]
    lc.loops = [dict(loop) for loop in ls["loops"]]
    return jslam


@pytest.fixture(scope="module")
def carried(orbit_run):
    """(JAX system, port system carried from it by interop, kf)."""
    jslam = _jax_system(orbit_run["state"])
    slam = interop.from_state(CAM, _port_cfg(), interop.export_state(jslam),
                              device="cpu")
    slam.tracking.loop_closer.cfg = tloop.LoopCloserConfig(**LOOP)
    return jslam, slam, orbit_run["kf"]


def test_loop_closer_matches_jax_on_a_carried_map(carried):
    jslam, slam, kf = carried
    jlc, tlc = jslam.tracking.loop_closer, slam.tracking.loop_closer
    js, ts = jslam.store, slam.store
    # the database and the loop closer came across
    assert np.array_equal(tlc.kfdb.has_bow, jlc.kfdb.has_bow)
    assert tlc.last_loop_kf == jlc.last_loop_kf
    jlc.kfdb.add(kf)
    tlc.kfdb.add(kf)
    np.testing.assert_allclose(tlc.kfdb.bow[kf], jlc.kfdb.bow[kf],
                               atol=1e-6)

    # DetectLoop: the same candidates and consistency groups
    cands = jlc._detect_loop(kf)
    assert tlc._detect_loop(kf) == cands and cands
    assert tlc.consistent_groups == jlc.consistent_groups

    # the stages of ComputeSim3 one by one, from the same inputs
    cand = cands[0]
    jb1, jb2 = jlc._kf_landmark_bundle(kf), jlc._kf_landmark_bundle(cand)
    tb1, tb2 = tlc._kf_landmark_bundle(kf), tlc._kf_landmark_bundle(cand)
    for k in ("mp", "live", "xc", "uv", "octave"):
        np.testing.assert_array_equal(tb1[k], jb1[k])
    jidx = np.asarray(jloop._bf_match_kernel(
        jb1["signs"], jnp.asarray(jb1["live"]), jb2["signs"],
        jnp.asarray(jb2["live"])))
    d1, d2 = tlc._device_bundle(tb1), tlc._device_bundle(tb2)
    rows = np.nonzero(jidx >= 0)[0]
    pairs = np.stack([rows, jidx[rows]], 1)
    key, sub = jax.random.split(jlc._key)
    jr = jloop.sim3_ransac(JCAM, *jlc._pad_sim3_pairs(jb1, jb2, pairs), sub)
    ransac = {k: torch.as_tensor(np.array(jr[k]))
              for k in ("R12", "t12", "s12")}
    np.testing.assert_array_equal(
        tlc._search_by_sim3(d1, d2, pairs, ransac),
        jlc._search_by_sim3(jb1, jb2, pairs, jr))

    # ComputeSim3 whole, with JAX's draw
    keys = {"k": jlc._key}

    def jax_draw(valid):            # the draw JAX's _compute_sim3 makes
        keys["k"], k1 = jax.random.split(keys["k"])
        p = valid.astype(np.float32)
        p = p / max(p.sum(), 1.0)
        return np.array(jax.random.choice(
            k1, len(valid), (256, 3), replace=True, p=jnp.asarray(p)))
    tlc.draw = jax_draw
    jsim = jlc._compute_sim3(kf, cand)
    stats = {}
    tsim = tlc._compute_sim3(kf, cand, stats)
    assert jsim is not None and tsim is not None
    assert tsim["n_inliers"] == jsim["n_inliers"]
    assert tsim["n_total"] == jsim["n_total"] >= 40
    for k in ("R12", "t12", "s12"):
        np.testing.assert_allclose(tsim[k], jsim[k], atol=1e-4)
    for a, b in zip(tlc._loop_match, jlc._loop_match):
        np.testing.assert_array_equal(a, b)
    assert stats["bf_matches"] == len(rows)

    # CorrectLoop from the same Sim3 (the background GBA is held in the
    # whole-run test and tests/test_torch_loop_gba.py)
    for lc in (jlc, tlc):
        lc.cfg = type(lc.cfg)(**dict(LOOP, run_global_ba=False))
    jlc._correct_loop(kf, cand, jsim)
    tlc._correct_loop(kf, cand, dict(jsim))
    ids = js.keyframe_ids()
    np.testing.assert_array_equal(ts.keyframe_ids(), ids)
    np.testing.assert_allclose(ts.kf_R[ids], js.kf_R[ids], atol=1e-4)
    np.testing.assert_allclose(ts.kf_t[ids], js.kf_t[ids], atol=1e-4)
    mps = js.map_point_ids()
    np.testing.assert_array_equal(ts.map_point_ids(), mps)
    np.testing.assert_allclose(ts.mp_pos[mps], js.mp_pos[mps], atol=1e-4)
    np.testing.assert_array_equal(ts.kf_mp, js.kf_mp)
    np.testing.assert_array_equal(ts.covis, js.covis)
    assert ts.kf_loop_edges == js.kf_loop_edges
    assert ts.kf_loop_edges[kf] == {cand}
    assert tlc.loops[-1]["kf"] == kf and tlc.loops[-1]["cand"] == cand


def test_interop_carries_the_loop_closer_both_ways(orbit_run):
    """JAX -> port -> export: the loop closer, the loop edges and the
    trained-vocabulary flags survive the round trip."""
    jslam = _jax_system(orbit_run["state"])
    jlc = jslam.tracking.loop_closer
    jlc.kfdb.trained, jlc.kfdb._trained_at = True, 12
    jlc.consistent_groups = [({0, 1, 2}, 1)]
    jslam.store.kf_loop_edges = {3: {0}, 0: {3}}
    first = interop.export_state(jslam)
    slam = interop.from_state(CAM, _port_cfg(), first, device="cpu")
    tlc = slam.tracking.loop_closer
    assert tlc.kfdb.trained and tlc.kfdb._trained_at == 12
    assert tlc.consistent_groups == [({0, 1, 2}, 1)]
    assert slam.store.kf_loop_edges == {3: {0}, 0: {3}}
    np.testing.assert_array_equal(tlc.kfdb.vocab.bits,
                                  first["kfdb"]["vocab_bits"])
    again = interop.export_state(slam)
    for key in ("loop_edges", "loop_closer"):
        assert repr(again[key]) == repr(first[key])
    for k in ("bow", "has_bow", "vocab_bits", "trained", "trained_at"):
        np.testing.assert_array_equal(again["kfdb"][k], first["kfdb"][k])


def test_maybe_retrain_matches_jax(orbit_run):
    """The k-medians retraining on a carried map: the same codebook bits
    and the same re-encoded database (a 256-word codebook keeps it
    quick)."""
    state = orbit_run["state"]
    jslam = _jax_system(state)
    slam = interop.from_state(CAM, _port_cfg(), state, device="cpu")
    jdb, tdb = jslam.tracking.loop_closer.kfdb, slam.kfdb
    bits = jpr.VocabTensor(n_words=256, seed=5).signs > 0
    for db, vocab in ((jdb, jpr.VocabTensor(bits=np.asarray(bits))),
                      (tdb, tpr.VocabTensor(bits=np.asarray(bits),
                                            device="cpu"))):
        db.vocab = vocab
        db.bow = np.zeros((db.bow.shape[0], 256), np.float32)
        db.trained, db._trained_at = False, 0
    tdb._bow_dev = torch.zeros((tdb.bow.shape[0], 256))
    jdb._bow_dev = None
    n_kf = slam.store.n_keyframes()
    assert not tdb.maybe_retrain(min_kfs=n_kf + 1)
    assert jdb.maybe_retrain(min_kfs=n_kf, n_iters=3)
    assert tdb.maybe_retrain(min_kfs=n_kf, n_iters=3)
    np.testing.assert_array_equal(tdb.vocab.bits,
                                  (np.asarray(jdb.vocab.signs) > 0))
    np.testing.assert_allclose(tdb.bow, jdb.bow, atol=1e-6)
    np.testing.assert_allclose(tdb._bow_dev.numpy(), jdb.bow, atol=1e-6)
    assert tdb.trained and tdb._trained_at == n_kf
    # the next training waits until the map has quadrupled
    assert not tdb.maybe_retrain(min_kfs=n_kf)


def test_database_is_shared_through_a_reset():
    """The reference's LoopCloser.reset replaces its database and leaves
    the relocalizer on the old one (ROADMAP.md §3); the port empties the
    one shared database in place."""
    jslam = JSlamSystem(JCAM, _jax_cfg())
    jslam.tracking.reset()
    assert jslam.tracking.relocalizer.kfdb is not \
        jslam.tracking.loop_closer.kfdb          # the reference's fault
    slam = SlamSystem(CAM, _port_cfg(), device="cpu")
    t = slam.tracking
    db = slam.kfdb
    assert t.relocalizer.kfdb is db and t.loop_closer.kfdb is db
    rng = np.random.default_rng(0)
    for kf in range(3):
        slam.store.add_keyframe(
            np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
            rng.uniform(0, 400, (512, 2)).astype(np.float32),
            rng.integers(0, 256, (512, 32)).astype(np.uint8),
            np.zeros(512, np.int32), np.ones(512, bool))
        t._register_kf_in_db(kf)
    assert db.has_bow[:3].all()
    t.reset()
    assert t.relocalizer.kfdb is db and t.loop_closer.kfdb is db
    assert not db.has_bow.any() and not db._bow_dev.any()
    assert db.trained and db._trained_at == float("inf")


def test_default_configs_construct_with_the_loop_closer():
    """SlamConfig() and the configuration the JAX bench builds
    (async_mapping=True) construct, with every part wired."""
    for cfg in (SlamConfig(), SlamConfig(async_mapping=True)):
        slam = SlamSystem(CAM, cfg, device="cpu")
        t = slam.tracking
        assert t.loop_closer is not None and t.relocalizer is not None
        assert t.loop_closer.kfdb is slam.kfdb is t.relocalizer.kfdb
        assert t.loop_closer.gba.device.type == "cpu"
        if cfg.async_mapping:
            assert t.async_mapper.loop_closer is t.loop_closer
        slam.shutdown()
    # the depth sensors construct with the scale of a loop fixed; only an
    # unknown sensor raises
    for sensor in ("STEREO", "RGBD"):
        slam = SlamSystem(CAM._replace(bf=50.0), SlamConfig(sensor=sensor),
                          device="cpu")
        assert slam.tracking.loop_closer.cfg.fix_scale
        assert slam.tracking.relocalizer is not None
        assert slam.cfg.tracking.depth_threshold_m == 40.0 * 50.0 / 500.0
        slam.shutdown()
    with pytest.raises(ValueError, match="unknown sensor"):
        SlamConfig(sensor="MONO")


def test_worker_hands_keyframes_to_the_loop_closer():
    """The mapping worker maps a keyframe, then runs the loop closer on it
    (the relocalizer's database is reached through the loop closer)."""
    calls = []
    lock = threading.Lock()

    class Mapper:
        device = torch.device("cpu")
        store = types.SimpleNamespace(kf_seq=np.arange(8))

        def process_keyframe(self, kf):
            with lock:
                calls.append(("map", kf))

    class Closer:
        def insert_keyframe(self, kf):
            with lock:
                calls.append(("loop", kf))

    class Reloc:
        kfdb = None

    am = AsyncMapper(Mapper(), loop_closer=Closer(), relocalizer=Reloc())
    for kf in (3, 4):
        am.submit(kf, Mapper.store.kf_seq[kf])
    am.submit_task(lambda: 5)
    am.join()
    assert calls == [("map", 3), ("loop", 3), ("map", 4), ("loop", 4),
                     ("map", 5), ("loop", 5)]
    assert am.n_processed == 3 and am.error is None


def test_render_room_loop_revisits_its_start_looking_outward():
    """chip_smoke.py phase 8's scene: the camera walks 1.1 turns of a
    circle in a textured room, level, its optical axis radially outward;
    after one turn it is back in the first pose and sees the first image
    again (but for the sensor noise), while a quarter turn on it sees
    other walls."""
    from ar_orbslam2_tpu_torch.data import synthetic as tsyn
    cam = Camera(fx=125.0, fy=125.0, cx=80.0, cy=60.0, width=160, height=120)
    n = 23                                   # 18 degrees a frame
    imgs, R, t = tsyn.render_room_loop(cam, n_frames=n, tex_size=256)
    assert imgs.shape == (n, 120, 160) and imgs.dtype == np.uint8
    c = -(np.swapaxes(R, -1, -2) @ t[..., None])[..., 0]
    a = 2 * np.pi * 1.1 * np.arange(n) / (n - 1)
    np.testing.assert_allclose(c, np.c_[1.5 * np.cos(a), 1.5 * np.sin(a),
                                        np.full(n, 1.5)], atol=1e-5)
    np.testing.assert_allclose(R[:, 2, :], np.c_[np.cos(a), np.sin(a),
                                                 np.zeros(n)], atol=1e-6)
    np.testing.assert_allclose(R[20], R[0], atol=1e-5)  # one turn: frame 20
    diff = [np.abs(imgs[k].astype(int) - imgs[0]).mean() for k in (20, 5)]
    assert diff[0] < 3.0 < 20.0 < diff[1]
    assert (imgs > 0).mean() > 0.99                     # walls everywhere


def test_render_plane_loop_revisits_its_start():
    """chip_smoke.py phase 10's stereo plane loop: the camera goes once
    around a circle, keeps one (tilted) viewing direction, never leaves
    the plane, and the right image is the left camera moved by the
    baseline along its x axis."""
    from ar_orbslam2_tpu_torch.data import synthetic as tsyn
    cam = Camera(fx=125.0, fy=125.0, cx=80.0, cy=60.0, width=160, height=120,
                 bf=12.5)
    left, right, R, t = tsyn.render_stereo_plane_loop(
        cam, n_frames=24, radius=1.0, tilt=0.35, tex_size=512)
    assert left.shape == right.shape == (24, 120, 160)
    assert left.dtype == right.dtype == np.uint8
    c = -(np.swapaxes(R, -1, -2) @ t[..., None])[..., 0]
    assert np.linalg.norm(c[-1] - c[0]) < 0.01          # the loop
    assert np.linalg.norm(c[12] - c[0]) > 1.9           # half a turn away
    np.testing.assert_allclose(R, np.broadcast_to(R[0], R.shape), atol=1e-6)
    # tilted 0.35 rad from the plane's normal (world +z)
    assert abs(np.arccos(R[0][2, 2]) - 0.35) < 1e-5
    assert (left > 0).mean() > 0.99 and (right > 0).mean() > 0.99
    assert 3.0 < np.abs(left.astype(int) - right).mean() < 60.0
