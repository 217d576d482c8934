"""The port's fused tracking path (system/fused.py, system/graph.py)
against the JAX package, on the CPU.

Both packages get the same inputs: a map built once by the port's per-frame
path on the CPU (from feature-level or rendered observations made from a
numpy seed), copied array for array into a JAX MapStore, and the same
next-frame features or images. The JAX side runs its windowed search through
its XLA reference (what it does off the TPU); the port's kernel wrapper runs
its plain version (CPU tensors), and the graph runner calls the step
eagerly.

Tolerances: every integer output (match/inlier counts, bindings, counters,
flags) is exact; poses agree to 1e-5 (rotation entries and translation in
the median-depth-1 gauge; the observed gap is ~1e-6: same matches, same LM
iterations, f32 in both). Over a chunk from pixels each frame starts from
the previous frame's pose, so the gap compounds: 1e-4 there, as for the
carried per-frame tracking of test_torch_slam.py (observed 1.5e-5).
"""
import numpy as np
import pytest
import torch

from ar_orbslam2_tpu.core.camera import Camera as JCamera
from ar_orbslam2_tpu.data import synthetic
from ar_orbslam2_tpu.frontend.orb import OrbConfig as JOrbConfig
from ar_orbslam2_tpu.mapstore.map import MapConfig as JMapConfig
from ar_orbslam2_tpu.mapstore.map import MapStore as JMapStore
from ar_orbslam2_tpu.system import fused as jfused
from ar_orbslam2_tpu.system.tracking import TrackingConfig as JTrackingConfig
from ar_orbslam2_tpu_torch import interop
from ar_orbslam2_tpu_torch.core.camera import Camera
from ar_orbslam2_tpu_torch.frontend.orb import OrbConfig
from ar_orbslam2_tpu_torch.mapping.local_mapping import LocalMapperConfig
from ar_orbslam2_tpu_torch.mapstore.checkpoint import _ARRAYS
from ar_orbslam2_tpu_torch.mapstore.map import MapConfig
from ar_orbslam2_tpu_torch.system import fused as pfused
from ar_orbslam2_tpu_torch.system.graph import GraphRunner
from ar_orbslam2_tpu_torch.system.slam import SlamConfig, SlamSystem
from ar_orbslam2_tpu_torch.system.tracking import TrackingConfig

P, L = 256, 512
MAP = dict(max_keyframes=32, max_map_points=4096, max_kp=P)
TRK = dict(max_kp=P, n_local_mp=L, max_frames_between_kf=5)
MAPPER = dict(ba_max_points=L, n_triangulation_neighbors=4,
              n_fuse_neighbors=4)
POSE_TOL = 1e-5
CHUNK_POSE_TOL = 1e-4
INT_KEYS = ("motion_matches", "motion_inliers", "motion_ok", "fb_matches",
            "fb_inliers", "fb_ok", "pre_ok", "n_inliers", "n_visible",
            "n_bound", "n_kp")


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The port's steps are chains of tiny ops: more intra-op threads buy
    nothing and fight the other test workers for the cores."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(**kw):
    base = dict(use_fused_tracking=False, async_mapping=False,
                enable_loop_closing=False, enable_relocalization=False)
    base.update(kw)
    return SlamConfig(map=MapConfig(**MAP), tracking=TrackingConfig(**TRK),
                      mapper=LocalMapperConfig(**MAPPER), **base)


def _jax_store(state):
    """A JAX-package MapStore holding an exported map, array for array."""
    s = JMapStore(JMapConfig(**MAP))
    for name in _ARRAYS:
        getattr(s, name)[...] = state["map"][name]
    s.next_kf = state["next_kf"]
    s.mp_replaced[...] = state["mp_replaced"]
    s.mp_free = list(state["mp_free"])
    s.bump()
    return s


def _pair(cam, state, port_slam):
    """(port FusedFrontend, JAX FusedFrontend) rebuilt from the same last
    frame over the same map."""
    tr, lf = state["tracking"], state["last_frame"]
    pfe = pfused.FusedFrontend(port_slam.store, cam, TrackingConfig(**TRK),
                               OrbConfig(n_features=P), "cpu")
    jfe = jfused.FusedFrontend(_jax_store(state), JCamera(*cam),
                               JTrackingConfig(**TRK),
                               JOrbConfig(n_features=P))
    for fe in (pfe, jfe):
        fe.rebuild(tr["ref_kf"], lf["mp"], lf["R"], lf["t"],
                   velocity=tr["velocity"], prev_oct=lf["octave"])
    return pfe, jfe


def _assert_state_equal(pstate, jstate, pose_tol=0.0, skip=()):
    for k, jv in jstate.items():
        if k in skip:
            continue
        pv = pstate[k].cpu().numpy()
        jv = np.asarray(jv)
        assert pv.shape == jv.shape and pv.dtype == jv.dtype, k
        if pose_tol and k in ("prev_R", "prev_t", "vel_R", "vel_t"):
            np.testing.assert_allclose(pv, jv, atol=pose_tol, err_msg=k)
        else:
            np.testing.assert_array_equal(pv, jv, err_msg=k)


def _assert_record_equal(prec, jrec, pose_tol=POSE_TOL):
    for k in INT_KEYS:
        np.testing.assert_array_equal(
            np.asarray(prec[k].cpu() if torch.is_tensor(prec[k])
                       else prec[k]).astype(np.int64),
            np.asarray(jrec[k]).astype(np.int64), err_msg=k)
    for k in ("R", "t"):
        pv = prec[k].cpu().numpy() if torch.is_tensor(prec[k]) else prec[k]
        np.testing.assert_allclose(pv, np.asarray(jrec[k]), atol=pose_tol,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# feature-level scene: megastep, refresh, rebuild, counters
# ---------------------------------------------------------------------------
FCAM = Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0)
N_BUILD = 8          # frames the port tracks before the state is carried


def _observe(scene, i):
    obs = synthetic.observe_frame(scene, i, JCamera(*FCAM), max_kp=P,
                                  noise_px=0.3, bit_flip=0.02)
    return dict(uv=obs["uv"], desc=obs["desc"], octave=obs["octave"],
                valid=obs["valid"])


@pytest.fixture(scope="module")
def feature_world():
    scene = synthetic.make_scene(n_landmarks=600, n_frames=N_BUILD + 3,
                                 seed=3, trajectory="orbit", arc=0.5)
    slam = SlamSystem(FCAM, _cfg(), device="cpu")
    for i in range(N_BUILD):
        slam.track_monocular(features=_observe(scene, i),
                             timestamp=scene.timestamps[i])
    assert slam.tracking.state == "OK"
    assert slam.tracking.velocity is not None
    state = interop.export_state(slam)
    pfe, jfe = _pair(FCAM, state, slam)
    return scene, slam, state, pfe, jfe


def _feats(scene, i):
    import jax.numpy as jnp
    o = _observe(scene, i)

    def pad(a, fill=0):
        out = np.full((P,) + a.shape[1:], fill, a.dtype)
        out[:len(a)] = a[:P]
        return out
    host = dict(uv=pad(o["uv"].astype(np.float32)),
                desc_bits=pad(o["desc"].astype(np.uint8)),
                octave=pad(o["octave"].astype(np.int32)),
                valid=pad(o["valid"].astype(bool), False),
                angle=np.zeros(P, np.float32))
    order = ("uv", "desc_bits", "octave", "valid", "angle")
    return ([torch.from_numpy(host[k]) for k in order],
            [jnp.asarray(host[k]) for k in order])


def test_rebuild_matches_jax(feature_world):
    """One rebuild from the same last frame: every state entry, the slot
    table, the anchor and the local keyframe set are equal."""
    _, _, _, pfe, jfe = feature_world
    _assert_state_equal(pfe.state, jfe.state)
    np.testing.assert_array_equal(pfe.bundle_ids, jfe.bundle_ids)
    assert pfe.local_kf == jfe.local_kf
    assert pfe.anchor_kf == jfe.anchor_kf
    np.testing.assert_array_equal(pfe.anchor_R, jfe.anchor_R)
    assert int((pfe.state["prev_slot"] >= 0).sum()) > 50


def _variant(state, which, xp):
    """The three branches of the megastep from one rebuilt state."""
    st = dict(state)
    if which == "fallback":      # a wild velocity: the motion search fails
        st["vel_t"] = st["vel_t"] + xp.asarray([3.0, -2.0, 1.0],
                                               dtype=xp.float32)
    elif which == "no_vel":
        st["have_vel"] = xp.asarray(False)
    return st


@pytest.mark.parametrize("which", ["motion", "fallback", "no_vel"])
def test_megastep_matches_jax(feature_world, which):
    import jax.numpy as jnp
    scene, _, _, pfe, jfe = feature_world
    pf, jf = _feats(scene, N_BUILD)
    pst = _variant(pfe.state, which, torch)
    jst = _variant(jfe.state, which, jnp)
    before = {k: v.clone() for k, v in pst.items()}
    pnew, prec = pfused.track_megastep(FCAM, pst, *pf)
    jnew, jrec = jfused.track_megastep(JCamera(*FCAM), jst, *jf)
    _assert_record_equal(prec, jrec)
    _assert_state_equal(pnew, jnew, pose_tol=POSE_TOL, skip=("lm_signs",))
    for k, v in before.items():          # functional: the input is untouched
        assert torch.equal(pst[k], v), k
    assert bool(prec["pre_ok"]) and int(prec["n_inliers"]) >= 30
    assert bool(prec["motion_ok"]) == (which == "motion")
    if which == "motion":        # the skipped branch reads 0, as lax.cond's
        assert int(prec["fb_matches"]) == 0 and int(prec["fb_inliers"]) == 0
    else:
        assert bool(prec["fb_ok"]) and int(prec["fb_matches"]) >= 15


@pytest.mark.parametrize("which", ["motion", "fallback"])
def test_host_branch_arms_match_select(feature_world, which):
    """The two arms a host-side branch would run ("run", "skip") give what
    the always-compute-and-select megastep gives."""
    scene, _, _, pfe, _ = feature_world
    pf, _ = _feats(scene, N_BUILD)
    st = _variant(pfe.state, which, torch)
    uv, desc, octave, valid, angle = pf
    with torch.no_grad():
        _, sel = pfused._megastep_core(FCAM, st, *pf)
        mid = pfused._megastep_motion(FCAM, st, uv, desc, octave, valid)
        arm = "skip" if bool(mid["motion_ok"]) else "run"
        _, rec = pfused._megastep_rest(FCAM, st, mid, desc, octave, valid,
                                       angle, fallback=arm)
    assert arm == ("skip" if which == "motion" else "run")
    for k in sel:
        assert torch.equal(sel[k], rec[k]), k


def _ortho_error(R):
    R = np.asarray(R, np.float64)
    return float(np.abs(R.T @ R - np.eye(3)).max())


def test_carried_pose_stays_on_so3_where_the_reference_drifts(feature_world):
    """A fault of the reference that the port does not copy. The fused path
    carries prev_R from frame to frame and takes its transpose for its
    inverse in the velocity model, so an orthonormality error comes back in
    the next prediction, the LM can only rotate it, and it grows by the
    golden ratio per frame. The same frame 40 times over a frozen bundle
    (a camera at rest): the JAX package's error grows from float rounding
    by orders of magnitude and its inliers collapse; the port puts R2 back
    on SO(3) in every step (lie.orthonormalize) and stays where it was."""
    scene, _, _, pfe, jfe = feature_world
    pf, jf = _feats(scene, N_BUILD)
    pst, jst = pfe.state, jfe.state
    first = None
    for _ in range(40):
        pst, prec = pfused.track_megastep(FCAM, pst, *pf)
        jst, jrec = jfused.track_megastep(JCamera(*FCAM), jst, *jf)
        first = first or (int(prec["n_inliers"]), int(jrec["n_inliers"]),
                          prec["t"].numpy())
    assert first[0] == first[1] >= 30
    assert _ortho_error(pst["prev_R"].numpy()) < 1e-6
    assert int(prec["n_inliers"]) >= first[0] - 2
    np.testing.assert_allclose(prec["t"].numpy(), first[2], atol=5e-3)
    # the reference: measured 3e-2 and 0 inliers here; any growth past 1e-4
    # shows the fault
    assert _ortho_error(jst["prev_R"]) > 1e-4 \
        or int(jrec["n_inliers"]) < first[1] // 2


def test_orthonormalize_is_a_no_op_on_rotations():
    from ar_orbslam2_tpu_torch.core import lie
    rng = np.random.default_rng(2)
    R = lie.so3_exp(torch.from_numpy(rng.normal(0, 1, (16, 3))
                                     .astype(np.float32)))
    np.testing.assert_allclose(lie.orthonormalize(R).numpy(), R.numpy(),
                               atol=3e-7)
    bent = R + torch.from_numpy(rng.normal(0, 1e-3, (16, 3, 3))
                                .astype(np.float32))
    fixed = lie.orthonormalize(bent).numpy().astype(np.float64)
    err = np.abs(np.swapaxes(fixed, -1, -2) @ fixed - np.eye(3)).max()
    assert err < 1e-6
    np.testing.assert_allclose(fixed, R.numpy(), atol=3e-3)


def test_record_packing_roundtrip(feature_world):
    scene, _, _, pfe, _ = feature_world
    pf, _ = _feats(scene, N_BUILD)
    _, rec = pfused.track_megastep(FCAM, pfe.state, *pf)
    row = pfused._pack_record(rec).numpy()[None]
    got = pfused._unpack_records(row)
    for k, v in rec.items():
        np.testing.assert_array_equal(got[k][0], v.numpy(), err_msg=k)


def test_refresh_step_matches_jax(feature_world):
    """_refresh_step on a permuted, partly evicted bundle: slots and
    counters exact, the re-anchored pose to 1e-6."""
    import jax.numpy as jnp
    _, _, _, pfe, jfe = feature_world
    rng = np.random.default_rng(5)
    perm = rng.permutation(L).astype(np.int32)
    remap = np.where(rng.random(L) < 0.2, -1, perm).astype(np.int32)
    acc_v = rng.integers(0, 9, L).astype(np.int32)
    acc_f = rng.integers(0, 5, L).astype(np.int32)
    host = {k: np.asarray(jfe.state[k]) for k in jfe.state}
    inv = np.argsort(perm)
    bundle = dict(pos=host["lm_pos"][inv], desc_packed=host["lm_desc"][inv],
                  normal=host["lm_normal"][inv], dmin=host["lm_dmin"][inv],
                  dmax=host["lm_dmax"][inv], valid=host["lm_valid"][inv])
    ang = 0.05
    aRn = np.array([[np.cos(ang), -np.sin(ang), 0],
                    [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    aRo, ato = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    atn = np.array([0.02, -0.01, 0.03], np.float32)
    pst = dict(pfe.state, acc_visible=torch.from_numpy(acc_v),
               acc_found=torch.from_numpy(acc_f))
    jst = dict(jfe.state, acc_visible=jnp.asarray(acc_v),
               acc_found=jnp.asarray(acc_f))
    t = torch.from_numpy
    pnew = pfused._refresh_step(
        pst, {k: t(v) for k, v in bundle.items()}, t(remap), t(aRo), t(ato),
        t(aRn), t(atn))
    jnew = jfused._refresh_step(
        jst, {k: jnp.asarray(v) for k, v in bundle.items()},
        jnp.asarray(remap), jnp.asarray(aRo), jnp.asarray(ato),
        jnp.asarray(aRn), jnp.asarray(atn))
    _assert_state_equal(pnew, jnew, pose_tol=1e-6)
    assert int(pnew["acc_visible"].sum()) == int(acc_v[remap >= 0].sum())


def test_fold_counters_matches_jax(feature_world):
    """The baseline-delta fold: twice with growing device totals, then
    once with stale (smaller) totals, which must add nothing."""
    _, slam, state, pfe, jfe = feature_world
    rng = np.random.default_rng(11)
    pstore, jstore = pfe.store, jfe.store
    v0 = pstore.mp_visible.copy()
    a = dict(acc_visible=rng.integers(0, 5, L).astype(np.int32),
             acc_found=rng.integers(0, 3, L).astype(np.int32))
    b = {k: v + rng.integers(0, 4, L).astype(np.int32) for k, v in a.items()}
    for got in (a, b, a):
        pfe._fold_counters(dict(got))
        jfe._fold_counters(dict(got))
        np.testing.assert_array_equal(pstore.mp_visible, jstore.mp_visible)
        np.testing.assert_array_equal(pstore.mp_found, jstore.mp_found)
    ok = pfe.bundle_ids >= 0
    assert int((pstore.mp_visible - v0).sum()) == int(b["acc_visible"][ok].sum())


def test_interop_carries_a_live_fused_frontend(feature_world):
    """export_state of a JAX system holding a FusedFrontend, from_state into
    the port: same device state, tables and tracking levels; then one
    megastep each from that state agrees."""
    import types

    import jax.numpy as jnp
    scene, slam, state, _, jfe = feature_world
    jt = types.SimpleNamespace(
        state="OK", ref_kf=state["tracking"]["ref_kf"],
        last_kf_frame_id=state["tracking"]["last_kf_frame_id"],
        velocity=state["tracking"]["velocity"], last_reloc_frame_id=-10 ** 6,
        _inl_peak=210.0, _inl_decay=190.5, _low_streak=1,
        last_rel=(np.eye(3, dtype=np.float32), np.ones(3, np.float32), 2),
        _fused_prev_pose=(np.asarray(jfe.state["prev_R"]),
                          np.asarray(jfe.state["prev_t"])),
        last_frame=None, fused=jfe)
    jslam = types.SimpleNamespace(
        store=jfe.store, tracking=jt,
        mapper=types.SimpleNamespace(recent={}), _next_frame_id=N_BUILD)
    snap = interop.export_state(jslam)
    port = interop.from_state(FCAM, _cfg(use_fused_tracking=True), snap,
                              device="cpu")
    fe = port.tracking.fused
    assert fe.ready()
    _assert_state_equal(fe.state, jfe.state)
    np.testing.assert_array_equal(fe.bundle_ids, jfe.bundle_ids)
    np.testing.assert_array_equal(fe._acc_base_vis, jfe._acc_base_vis)
    assert (fe.anchor_kf, fe._bundle_epoch) == (jfe.anchor_kf,
                                                jfe._bundle_epoch)
    t = port.tracking
    assert (t._inl_peak, t._inl_decay, t._low_streak) == (210.0, 190.5, 1)
    assert t.last_rel[2] == 2
    np.testing.assert_array_equal(t._fused_prev_pose[0],
                                  np.asarray(jfe.state["prev_R"]))
    pf, jf = _feats(scene, N_BUILD)
    _, prec = pfused.track_megastep(FCAM, fe.state, *pf)
    _, jrec = jfused.track_megastep(JCamera(*FCAM), jfe.state, *jf)
    _assert_record_equal(prec, jrec)


# ---------------------------------------------------------------------------
# graph runner on the CPU
# ---------------------------------------------------------------------------
def test_graph_runner_runs_the_step_eagerly_on_cpu():
    buf = torch.zeros(3)
    runner = GraphRunner(lambda: buf.add_(1.0), "cpu", restore=[buf])
    assert not runner.on_card
    runner.capture()                      # a no-op without a card
    for _ in range(4):
        runner.run()
    assert buf.tolist() == [4.0, 4.0, 4.0]
    assert (runner.captures, runner.replays, runner.graph) == (0, 0, None)


# ---------------------------------------------------------------------------
# rendered images: a chunk through the step loop against track_chunk
# ---------------------------------------------------------------------------
ICAM = Camera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
CHUNK = 3


@pytest.fixture(scope="module")
def image_world():
    jcam = JCamera(*ICAM)
    imgs, _, _ = synthetic.render_plane_sequence(jcam, n_frames=12, seed=0,
                                                 motion=0.3)
    slam = SlamSystem(ICAM, _cfg(), device="cpu")
    n = 0
    while n < len(imgs) - CHUNK:
        slam.track_monocular(imgs[n], timestamp=n / 30.0)
        n += 1
        if slam.tracking.state == "OK" and slam.tracking.velocity is not None:
            break
    assert slam.tracking.state == "OK", "the port did not initialise"
    state = interop.export_state(slam)
    pfe, jfe = _pair(ICAM, state, slam)
    return np.stack(imgs[n:n + CHUNK]), pfe, jfe


def test_chunk_matches_jax_track_chunk(image_world):
    """CHUNK frames from pixels: the port's in-place step loop
    (dispatch_chunk + collect_chunk, what the card replays as a graph), its
    functional track_chunk, and the JAX track_chunk scan."""
    import jax
    import jax.numpy as jnp
    images, pfe, jfe = image_world
    tcfg = TrackingConfig(**TRK)
    kw = dict(scale_factor=tcfg.scale_factor, n_levels=tcfg.n_levels,
              min_track_matches=tcfg.min_track_matches,
              min_inliers_track=tcfg.min_inliers_track, undistort=False)
    start = {k: v.clone() for k, v in pfe.state.items()}
    jstate, jrecs, jsnaps = jfused.track_chunk(
        JCamera(*ICAM), JOrbConfig(n_features=P), jfe.state,
        jnp.asarray(images), **kw)
    jrecs, jsnaps = jax.device_get((jrecs, jsnaps))
    fstate, frecs, fsnaps = pfused.track_chunk(
        ICAM, OrbConfig(n_features=P), start, torch.from_numpy(images), **kw)
    recs = pfe.step_chunk(images)                 # in place, one readback
    snaps = pfe._chunk_snaps

    assert int(jrecs["n_inliers"].min()) >= 30, "the chunk did not track"
    _assert_record_equal(recs, jrecs, CHUNK_POSE_TOL)
    _assert_record_equal(frecs, jrecs, CHUNK_POSE_TOL)
    for k in ("uv", "oct", "valid", "slot"):
        np.testing.assert_array_equal(snaps[k].numpy(), jsnaps[k], err_msg=k)
        np.testing.assert_array_equal(fsnaps[k].numpy(), jsnaps[k], err_msg=k)
    # descriptors from pixels: the pyramid levels agree to float rounding,
    # not bit for bit (test_torch_orb.py), so a BRIEF comparison on a
    # near-tie may flip: at most 4 of the chunk's 196,608 bits (observed 1)
    assert torch.equal(snaps["desc"], fsnaps["desc"])
    flipped = np.unpackbits(snaps["desc"].numpy() ^ jsnaps["desc"]).sum()
    assert flipped <= 4, flipped
    for k in ("R", "t"):
        np.testing.assert_allclose(snaps[k].numpy(), jsnaps[k],
                                   atol=CHUNK_POSE_TOL, err_msg=k)
    # orientation in degrees: the patch moments are summed in another
    # order and the level pixels differ by float rounding (observed 8.3e-3)
    np.testing.assert_allclose(snaps["angle"].numpy(), jsnaps["angle"],
                               atol=2e-2)
    _assert_state_equal(pfe.state, jstate, pose_tol=CHUNK_POSE_TOL,
                        skip=("lm_signs", "kp_angle"))
    _assert_state_equal(fstate, jstate, pose_tol=CHUNK_POSE_TOL,
                        skip=("lm_signs", "kp_angle"))
    # the counters rode the chunk's readback into the store
    assert pfe._acc_base_vis.sum() == int(pfe.state["acc_visible"].sum())
    assert pfe.runner.captures == 0 and pfe.n_captures == 0


def test_per_frame_step_matches_chunk(image_world):
    """extract + step (one frame, one readback) from the state the chunk
    started from gives the chunk's first record."""
    images, pfe, jfe = image_world
    other = pfused.FusedFrontend(pfe.store, ICAM, TrackingConfig(**TRK),
                                 OrbConfig(n_features=P), "cpu")
    host = {k: np.asarray(v) for k, v in jfe.state.items()
            if k != "lm_signs"}
    interop._load_fused(other, dict(
        state=host, version=pfe.version, anchor_kf=pfe.anchor_kf,
        _bundle_epoch=1, bundle_ids=pfe.bundle_ids, anchor_R=pfe.anchor_R,
        anchor_t=pfe.anchor_t, _acc_base_vis=np.zeros(L, np.int32),
        _acc_base_fnd=np.zeros(L, np.int32), local_kf=pfe.local_kf, vel=None))
    rec = other.step(other.extract(images[0]))
    full = pfused.track_chunk(
        ICAM, OrbConfig(n_features=P),
        pfused._expand_state({k: torch.from_numpy(np.array(v))
                              for k, v in host.items()}),
        torch.from_numpy(images[:1]))[1]
    for k in INT_KEYS:
        assert int(rec[k]) == int(full[k][0]), k
    np.testing.assert_allclose(rec["R"], full["R"][0].numpy(), atol=1e-6)
    frame = other.materialize_frame(0.5, 99)
    assert frame.frame_id == 99 and int((frame.mp >= 0).sum()) == int(
        rec["n_bound"])
    np.testing.assert_allclose(frame.R, rec["R"], atol=1e-5)


# ---------------------------------------------------------------------------
# a chunk that loses the scene: the hard-keyframe rescue, or LOST
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def loss_world():
    """Rendered images tracked per-frame by the port until the map holds
    three keyframes and a velocity; the exported state, and a chunk of the
    next two images and a uniform grey one (the scene is lost at its
    third frame)."""
    jcam = JCamera(*ICAM)
    imgs, _, _ = synthetic.render_plane_sequence(jcam, n_frames=30, seed=0,
                                                 motion=0.6)
    slam = SlamSystem(ICAM, _cfg(), device="cpu")
    n = 0
    while n < len(imgs) - 2:
        slam.track_monocular(imgs[n], timestamp=n / 30.0)
        n += 1
        t = slam.tracking
        if t.state == "OK" and t.velocity is not None \
                and slam.store.n_keyframes() >= 3:
            break
    assert slam.store.n_keyframes() >= 3, "the port made too few keyframes"
    chunk = np.stack([imgs[n], imgs[n + 1], np.full_like(imgs[0], 128)])
    return interop.export_state(slam), chunk


def _jax_slam(state):
    """A JAX SlamSystem holding an exported state (the direction interop
    does not carry), with the tracking levels the chunk path reads."""
    from ar_orbslam2_tpu.mapping.local_mapping import (
        LocalMapperConfig as JMapperConfig)
    from ar_orbslam2_tpu.system.slam import SlamConfig as JSlamConfig
    from ar_orbslam2_tpu.system.slam import SlamSystem as JSlamSystem
    jslam = JSlamSystem(JCamera(*ICAM), JSlamConfig(
        map=JMapConfig(**MAP), tracking=JTrackingConfig(**TRK),
        mapper=JMapperConfig(**MAPPER), use_fused_tracking=False,
        async_mapping=False, enable_loop_closing=False,
        enable_relocalization=False))
    s = jslam.store
    for name in _ARRAYS:
        getattr(s, name)[...] = state["map"][name]
    s.next_kf = state["next_kf"]
    s.mp_replaced[...] = state["mp_replaced"]
    s.mp_free = list(state["mp_free"])
    s.bump()
    jslam.mapper.recent = dict(state["mapper_recent"])
    t, tr = jslam.tracking, state["tracking"]
    t.state, t.ref_kf = tr["state"], tr["ref_kf"]
    t.last_kf_frame_id, t.velocity = tr["last_kf_frame_id"], tr["velocity"]
    t.last_reloc_frame_id, t._inl_peak = (tr["last_reloc_frame_id"],
                                          tr["inl_peak"])
    jslam._next_frame_id = state["next_frame_id"]
    return jslam


def _lossy_chunk(loss_world, decay):
    """Both packages' systems on the carried state, each with a fused
    frontend rebuilt from the last frame and the tracker's decaying
    inlier peak at `decay`, after the lossy chunk ran through both
    frontends. Returns (port, jslam, prec, jrec, base, stamps)."""
    state, chunk = loss_world
    port = interop.from_state(ICAM, _cfg(), state, device="cpu")
    jslam = _jax_slam(state)
    tr, lf = state["tracking"], state["last_frame"]
    pfe = pfused.FusedFrontend(port.store, ICAM, TrackingConfig(**TRK),
                               OrbConfig(n_features=P), "cpu")
    jfe = jfused.FusedFrontend(jslam.store, JCamera(*ICAM),
                               JTrackingConfig(**TRK),
                               JOrbConfig(n_features=P))
    for fe, t in ((pfe, port.tracking), (jfe, jslam.tracking)):
        fe.rebuild(tr["ref_kf"], lf["mp"], lf["R"], lf["t"],
                   velocity=tr["velocity"], prev_oct=lf["octave"])
        t.fused = fe
        t._inl_decay, t._low_streak = decay, 0
    prec, jrec = pfe.step_chunk(chunk), jfe.step_chunk(chunk)
    _assert_record_equal(prec, jrec, CHUNK_POSE_TOL)
    assert list(np.asarray(jrec["pre_ok"]).astype(bool)) == [True, True,
                                                             False]
    base = state["next_frame_id"]
    return (port, jslam, prec, jrec, base,
            [(base + c) / 30.0 for c in range(len(chunk))])


@pytest.mark.parametrize("decay", [200.0, 60.0], ids=["rescue", "lost"])
def test_chunk_loss_rescues_or_goes_lost_like_jax(loss_world, decay):
    """The fused chunk breaks at the grey frame. With a healthy decayed
    inlier peak (>= 4x the local gate: 120) both packages run the hard-
    keyframe rescue — a keyframe at the peak frame of the chunk, the state
    stays OK; below it both go LOST, drop the velocity and invalidate the
    fused state."""
    port, jslam, prec, jrec, base, stamps = _lossy_chunk(loss_world, decay)
    pfe, jfe = port.tracking.fused, jslam.tracking.fused
    n_kf = port.store.n_keyframes()
    got = [t.track_fused_chunk_async(rec, stamps, base) for t, rec in
           ((port.tracking, prec), (jslam.tracking, jrec))]
    assert got == [2, 2]
    pt, jt = port.tracking, jslam.tracking
    assert pt.state == jt.state == ("OK" if decay > 120 else "LOST")
    assert port.store.n_keyframes() == jslam.store.n_keyframes()
    if decay > 120:
        new = [int(st.kf_frame_id[st.keyframe_ids()[-1]])
               for st in (port.store, jslam.store)]
        assert port.store.n_keyframes() == n_kf + 1
        assert new[0] == new[1] and base <= new[0] < base + 2
        assert pt.metrics[-1]["kf_hard"] and jt.metrics[-1]["kf_hard"]
        assert pt.last_kf_frame_id == jt.last_kf_frame_id
    else:
        assert port.store.n_keyframes() == n_kf
        assert pt.velocity is None and jt.velocity is None
        assert not pfe.ready() and not jfe.ready()


def test_inlier_peak_decay_rescues_a_steady_decline_jax_loses(loss_world):
    """The port's departure on this path (tracking.INLIER_PEAK_DECAY):
    inliers that decline 3 % a frame from 280, fed through each package's
    own _record for 35 frames. The JAX package's peak decays 5 % a frame,
    keeps pace with the decline and ends at the last count, below the
    rescue's 4x gate (120), so the lossy chunk goes LOST; the port's
    decays 1 % a frame and stays above it, so the port runs the
    hard-keyframe rescue and stays OK. The peak since the last keyframe,
    the chunk's records and the frames consumed stay equal."""
    import types

    from ar_orbslam2_tpu_torch.system import tracking as ptracking
    port, jslam, prec, jrec, base, stamps = _lossy_chunk(loss_world, 0.0)
    pt, jt = port.tracking, jslam.tracking
    n_kf = port.store.n_keyframes()
    counts = [int(280 * 0.97 ** k) for k in range(35)]
    for k, n in enumerate(counts):
        frame = types.SimpleNamespace(frame_id=base - 35 + k,
                                      timestamp=0.0, R=None)
        for t in (pt, jt):
            t._record(frame, True, n)
    assert pt._inl_peak == jt._inl_peak == 280.0
    assert jt._inl_decay == counts[-1] < 120
    assert pt._inl_decay == pytest.approx(
        280.0 * ptracking.INLIER_PEAK_DECAY ** 34, rel=1e-6)
    assert pt._inl_decay >= 120
    got = [t.track_fused_chunk_async(rec, stamps, base) for t, rec in
           ((pt, prec), (jt, jrec))]
    assert got == [2, 2]
    assert (pt.state, jt.state) == ("OK", "LOST")
    assert port.store.n_keyframes() == n_kf + 1
    assert jslam.store.n_keyframes() == n_kf
    assert pt.metrics[-1]["kf_hard"]


def test_rescue_keyframe_must_hold_on_the_live_map(loss_world):
    """A reference fault the port repairs: the map moves under the chunk
    (every landmark by a different 0.3 m, as a loop correction and its
    fusion move a region), so the rescue keyframe's own bindings no
    longer hold its pose. The JAX
    package inserts it anyway, at the stale pose; the port drops it, gives
    the time trigger its old base back and rebuilds the bundle on the
    reference keyframe, still OK."""
    port, jslam, prec, jrec, base, stamps = _lossy_chunk(loss_world, 200.0)
    n_kf = port.store.n_keyframes()
    before = port.tracking.last_kf_frame_id
    live = port.store.mp_valid
    shift = np.random.default_rng(5).normal(0, 0.3, (int(live.sum()), 3))
    for st in (port.store, jslam.store):
        st.mp_pos[live] += shift.astype(np.float32)
        st.bump()
    got = [t.track_fused_chunk_async(rec, stamps, base) for t, rec in
           ((port.tracking, prec), (jslam.tracking, jrec))]
    assert got == [2, 2]
    pt = port.tracking
    assert jslam.store.n_keyframes() == n_kf + 1        # the stale keyframe
    assert port.store.n_keyframes() == n_kf and pt.state == "OK"
    assert pt.n_rescue_dropped == 1
    assert pt.last_kf_frame_id == before
    assert pt.fused.ready() and pt.fused.anchor_kf == pt.ref_kf
