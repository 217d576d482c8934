"""Fused per-frame tracking megastep — device-resident steady state.

Port of ar_orbslam2_tpu/system/fused.py. The entire OK-state tracking
pipeline

    ORB extraction -> motion-model search -> motion-only BA ->
    brute-force fallback search/BA -> local-map search -> final BA ->
    visibility counters -> velocity + binding update

runs on the device with every persistent piece of tracking state — the
local-map landmark bundle, the last frame's landmark bindings, the velocity
model, the visible/found counters and the current frame's feature arrays —
resident between frames. The host sees one small record per frame until a
keyframe or failure event, where one batched readback materialises the
frame for the host-side map pipeline.

Where the JAX package compiles ``extract_orb`` + ``_megastep_core`` with
``jit`` and scans a chunk with ``lax.scan``, this port captures ONE frame
step (extraction + megastep, reading a static image buffer and updating the
static state buffers in place) into a CUDA graph (system/graph.py) and
replays it once per frame of a chunk: the chunk's image stack is uploaded
once from pinned memory, a device-to-device copy feeds frame ``j`` into the
static input, the frame's record and snapshot are copied into row ``j`` of
the chunk's buffers, and one readback from pinned memory ends the chunk.
Nothing between the upload and the readback waits for the device. On the
CPU the same step function runs eagerly.

The device ``lax.cond`` around the brute-force fallback cannot live in a
captured graph: the step always computes the fallback and selects with
``torch.where``. The megastep is written in two halves (``_megastep_motion``
and ``_megastep_rest``) so that the alternative — two graphs around one host
read of ``motion_ok`` — can be built from the same code and measured
(chip_smoke.py does; a chunk could not use it without a wait per frame).

Parity map (same gates/thresholds as the reference):
  * motion path     = TrackWithMotionModel
  * fallback path   = TrackReferenceKeyFrame, generalized to the local bundle
  * local path      = TrackLocalMap / SearchLocalPoints
  * counters        = MapPoint::IncreaseVisible/IncreaseFound
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..core import camera as cam_mod
from ..core import lie
from ..estimation.pose_opt import pose_optimization_compact
from ..frontend.orb import extract_orb
from ..matching import matcher
from ..ops import hamming as H
from .graph import GraphRunner

# fixed compaction sizes for the per-frame pose LM (see
# pose_optimization_compact): matches can never exceed the keypoint
# budget (1024), and motion-model matches are far fewer in practice
_M_MOTION = 512
_M_LOCAL = 1024

# record layout: 12 float32 (R row-major, t) bit-cast to int32, then ints
_REC_INTS = ("motion_matches", "motion_inliers", "motion_ok", "fb_matches",
             "fb_inliers", "fb_ok", "pre_ok", "n_inliers", "n_visible",
             "n_bound", "n_kp")
_REC_BOOLS = ("motion_ok", "fb_ok", "pre_ok")
REC_WIDTH = 12 + len(_REC_INTS)

# per-frame snapshot: snapshot key -> state key ("desc" is packed on the way)
_SNAP_KEYS = dict(uv="kp_uv", oct="kp_oct", valid="kp_valid",
                  angle="kp_angle", slot="prev_slot", R="prev_R", t="prev_t")
# state entries a frame step rewrites
_STEP_KEYS = ("prev_slot", "prev_oct", "prev_R", "prev_t", "vel_R", "vel_t",
              "have_vel", "acc_visible", "acc_found", "kp_uv", "kp_desc",
              "kp_oct", "kp_valid", "kp_angle")
# state entries a bundle refresh rewrites
_REFRESH_KEYS = ("lm_pos", "lm_desc", "lm_signs", "lm_normal", "lm_dmin",
                 "lm_dmax", "lm_valid", "prev_slot", "prev_R", "prev_t",
                 "acc_visible", "acc_found")


def state_fields(L: int, P: int) -> dict:
    """name -> (shape, numpy dtype) of the uploaded tracking state (the JAX
    package's make_state pytree; ``lm_signs`` is expanded on the device)."""
    f32, i32, u8, b = np.float32, np.int32, np.uint8, np.bool_
    return dict(
        lm_pos=((L, 3), f32), lm_desc=((L, H.DESC_BYTES), u8),
        lm_normal=((L, 3), f32), lm_dmin=((L,), f32), lm_dmax=((L,), f32),
        lm_valid=((L,), b),
        prev_slot=((P,), i32), prev_oct=((P,), i32),
        prev_R=((3, 3), f32), prev_t=((3,), f32),
        vel_R=((3, 3), f32), vel_t=((3,), f32), have_vel=((), b),
        acc_visible=((L,), i32), acc_found=((L,), i32),
        kp_uv=((P, 2), f32), kp_desc=((P, H.DESC_BITS), u8),
        kp_oct=((P,), i32), kp_valid=((P,), b), kp_angle=((P,), f32))


def make_state(bundle: dict, prev_slot, prev_oct, prev_R, prev_t,
               vel_R, vel_t, have_vel: bool, kp_template: dict):
    """Assemble the tracking state as HOST numpy arrays (make_state of the
    JAX package, field for field). The caller uploads it in one copy."""
    L = bundle["pos"].shape[0]
    return dict(
        lm_pos=np.asarray(bundle["pos"], np.float32),
        lm_desc=np.asarray(bundle["desc_packed"], np.uint8),
        lm_normal=np.asarray(bundle["normal"], np.float32),
        lm_dmin=np.asarray(bundle["dmin"], np.float32),
        lm_dmax=np.asarray(bundle["dmax"], np.float32),
        lm_valid=np.asarray(bundle["valid"], bool),
        prev_slot=np.asarray(prev_slot, np.int32),
        prev_oct=np.asarray(prev_oct, np.int32),
        prev_R=np.asarray(prev_R, np.float32),
        prev_t=np.asarray(prev_t, np.float32),
        vel_R=np.asarray(vel_R, np.float32),
        vel_t=np.asarray(vel_t, np.float32),
        have_vel=np.asarray(have_vel, bool),
        acc_visible=np.zeros(L, np.int32),
        acc_found=np.zeros(L, np.int32),
        kp_uv=np.asarray(kp_template["uv"], np.float32),
        kp_desc=np.asarray(kp_template["desc"], np.uint8),
        kp_oct=np.asarray(kp_template["oct"], np.int32),
        kp_valid=np.asarray(kp_template["valid"], bool),
        kp_angle=np.asarray(kp_template["angle"], np.float32),
    )


def _expand_state(state):
    """Materialize the ±1 sign matrix from the packed descriptors after the
    single batched state upload. The packed form stays: the windowed-search
    kernel reads it; the signs feed the brute-force matmul."""
    return dict(state, lm_signs=H.signs_from_packed(state["lm_desc"]))


def _snap_slice(snaps, j):
    """One frame's snapshot slices."""
    return {k: v[j] for k, v in snaps.items()}


def _isum(mask):
    return mask.to(torch.int32).sum()


# ---------------------------------------------------------------------------
# the megastep, in two halves so that the host-branch variant can read
# motion_ok between them
# ---------------------------------------------------------------------------
def _megastep_motion(cam, state, uv, desc_bits, octave, valid,
                     min_track_matches=20, min_inliers_track=10,
                     undistort=False):
    """Pose prediction + motion-model track (TrackWithMotionModel)."""
    if undistort:
        uv = cam_mod.undistort_points(cam, uv)
    packed = H.pack_bits_device(desc_bits)
    lm_pos, lm_valid = state["lm_pos"], state["lm_valid"]
    have_vel = state["have_vel"]
    prev_R, prev_t = state["prev_R"], state["prev_t"]
    R_pred = torch.where(have_vel, state["vel_R"] @ prev_R, prev_R)
    t_pred = torch.where(have_vel, state["vel_R"] @ prev_t + state["vel_t"],
                         prev_t)
    slot = state["prev_slot"]
    slot0 = torch.clamp(slot, min=0).long()
    pvalid = (slot >= 0) & lm_valid[slot0] & have_vel
    m_pos = lm_pos[slot0]
    m_idx, _ = matcher.search_by_projection_frame(
        cam, R_pred, t_pred, m_pos, state["lm_desc"][slot0],
        state["prev_oct"], pvalid, uv, packed, octave, valid)
    m_matched = m_idx >= 0
    mj = torch.clamp(m_idx, min=0).long()
    m_res = pose_optimization_compact(
        R_pred, t_pred, m_pos, uv[mj], octave[mj], m_matched, cam, _M_MOTION)
    m_inl = _isum(m_res["inlier"] & m_matched)
    m_nm = _isum(m_matched)
    motion_ok = ((m_nm >= min_track_matches) & (m_inl >= min_inliers_track)
                 & have_vel)
    return dict(uv=uv, packed=packed, R_pred=R_pred, t_pred=t_pred,
                m_R=m_res["R"], m_t=m_res["t"], m_inl=m_inl, m_nm=m_nm,
                motion_ok=motion_ok)


def _fallback(cam, state, mid, desc_bits, octave, valid):
    """Brute force vs the local bundle + motion-only BA from the previous
    pose (TrackReferenceKeyFrame analog). Returns (R, t, n_inl, n_matches)."""
    f_idx, _ = matcher.search_brute_force(
        state["lm_signs"], state["lm_valid"], H.to_signs(desc_bits), valid,
        th=H.TH_LOW, nn_ratio=0.75)
    f_matched = f_idx >= 0
    fj = torch.clamp(f_idx, min=0).long()
    f_res = pose_optimization_compact(
        state["prev_R"], state["prev_t"], state["lm_pos"], mid["uv"][fj],
        octave[fj], f_matched, cam, _M_LOCAL)
    return (f_res["R"], f_res["t"], _isum(f_res["inlier"] & f_matched),
            _isum(f_matched))


def _megastep_rest(cam, state, mid, desc_bits, octave, valid, angle,
                   scale_factor=1.2, n_levels=8, min_inliers_track=10,
                   fallback="select"):
    """Fallback, local-map track, counters, binding + velocity update.

    fallback: "select" — always compute the fallback, keep it only where
    the motion model failed (its counts read 0 otherwise, as the
    reference's skipped branch gives); "run" / "skip" — the two arms of the
    reference's ``lax.cond`` for a caller that has read ``motion_ok``."""
    uv = mid["uv"]
    lm_pos, lm_valid = state["lm_pos"], state["lm_valid"]
    prev_R, prev_t = state["prev_R"], state["prev_t"]
    motion_ok = mid["motion_ok"]
    L, P = lm_pos.shape[0], uv.shape[0]
    zero = torch.zeros((), dtype=torch.int32, device=uv.device)
    if fallback == "skip":
        fR, ft, f_inl, f_nm = prev_R, prev_t, zero, zero
    else:
        fR, ft, f_inl, f_nm = _fallback(cam, state, mid, desc_bits, octave,
                                        valid)
        if fallback == "select":
            f_inl = torch.where(motion_ok, zero, f_inl)
            f_nm = torch.where(motion_ok, zero, f_nm)
    fb_ok = (f_nm >= 15) & (f_inl >= min_inliers_track)

    pre_ok = motion_ok | fb_ok
    R1 = torch.where(motion_ok, mid["m_R"],
                     torch.where(fb_ok, fR, mid["R_pred"]))
    t1 = torch.where(motion_ok, mid["m_t"],
                     torch.where(fb_ok, ft, mid["t_pred"]))

    # ---- local-map track (TrackLocalMap) ------------------------------
    l_idx, visible, _ = matcher.search_local_points(
        cam, R1, t1, lm_pos, state["lm_desc"], state["lm_normal"],
        state["lm_dmin"], state["lm_dmax"], lm_valid,
        uv, mid["packed"], octave, valid,
        n_levels=n_levels, scale_factor=scale_factor)
    l_matched = l_idx >= 0
    lj = torch.clamp(l_idx, min=0).long()
    l_res = pose_optimization_compact(R1, t1, lm_pos, uv[lj], octave[lj],
                                      l_matched, cam, _M_LOCAL)
    l_inlier = l_res["inlier"] & l_matched
    # Back onto SO(3) before the pose is carried: the velocity model below
    # takes prev_R^T for prev_R^-1, so an orthonormality error E of the
    # carried pose returns in the next prediction (vel_R prev_R = R2 (I +
    # E)), the LM can only rotate it, and E_k+1 = E_k + E_k-1 grows by the
    # golden ratio per frame: from float32 rounding to a lost track in
    # ~15 frames on a frozen bundle. The per-frame path projects at every
    # Frame.set_pose; this path never leaves the device between keyframes.
    R2, t2 = lie.orthonormalize(l_res["R"]), l_res["t"]

    # ---- counters (IncreaseVisible / IncreaseFound) -------------------
    vis_i = (visible & lm_valid).to(torch.int32)
    acc_visible = state["acc_visible"] + vis_i
    acc_found = state["acc_found"] + l_inlier.to(torch.int32)

    # ---- binding + velocity update ------------------------------------
    # invert lm->kp matches to kp->bundle-slot (mutual search => unique);
    # dropped rows land in the sink slot P, sliced off
    scatter_to = torch.where(l_inlier, l_idx, P).long()
    kp_slot = torch.full((P + 1,), -1, dtype=torch.int32, device=uv.device)
    kp_slot[scatter_to] = torch.arange(L, dtype=torch.int32,
                                       device=uv.device)
    kp_slot = kp_slot[:P]
    vel_R = R2 @ prev_R.T
    vel_t = t2 - vel_R @ prev_t

    new_state = dict(
        state,
        prev_slot=kp_slot, prev_oct=octave,
        prev_R=R2, prev_t=t2, vel_R=vel_R, vel_t=vel_t,
        have_vel=pre_ok,
        acc_visible=acc_visible, acc_found=acc_found,
        kp_uv=uv, kp_desc=desc_bits, kp_oct=octave, kp_valid=valid,
        kp_angle=angle)
    record = dict(
        R=R2, t=t2,
        motion_matches=mid["m_nm"], motion_inliers=mid["m_inl"],
        motion_ok=motion_ok, fb_matches=f_nm, fb_inliers=f_inl,
        fb_ok=fb_ok, pre_ok=pre_ok,
        n_inliers=_isum(l_inlier),
        n_visible=vis_i.sum(),
        n_bound=_isum(kp_slot >= 0),
        n_kp=_isum(valid))
    return new_state, record


def _megastep_core(cam, state, uv, desc_bits, octave, valid, angle,
                   scale_factor=1.2, n_levels=8,
                   min_track_matches=20, min_inliers_track=10,
                   undistort=False):
    """Body of one tracked frame (shared by the single-frame step and the
    chunk loop). No host read inside."""
    mid = _megastep_motion(cam, state, uv, desc_bits, octave, valid,
                           min_track_matches=min_track_matches,
                           min_inliers_track=min_inliers_track,
                           undistort=undistort)
    return _megastep_rest(cam, state, mid, desc_bits, octave, valid, angle,
                          scale_factor=scale_factor, n_levels=n_levels,
                          min_inliers_track=min_inliers_track)


@torch.no_grad()
def track_megastep(cam, state, uv, desc_bits, octave, valid, angle,
                   scale_factor=1.2, n_levels=8,
                   min_track_matches=20, min_inliers_track=10,
                   undistort=False):
    """One tracked frame, entirely on the state's device.

    Args:
      state: dict from make_state + _expand_state (device tensors).
      uv/desc_bits/octave/valid/angle: this frame's extraction outputs.
    Returns:
      (new_state, record) — record is a dict of 0-d tensors + the 3x3/3
      pose. The inputs are not modified.
    """
    return _megastep_core(cam, state, uv, desc_bits, octave, valid, angle,
                          scale_factor=scale_factor, n_levels=n_levels,
                          min_track_matches=min_track_matches,
                          min_inliers_track=min_inliers_track,
                          undistort=undistort)


@torch.no_grad()
def track_chunk(cam, orb_cfg, state, images,
                scale_factor=1.2, n_levels=8,
                min_track_matches=20, min_inliers_track=10,
                undistort=False):
    """Track a CHUNK of frames: (ORB extraction -> megastep) over a
    (C, H, W) image stack, eagerly, frame after frame. The functional form
    of the chunk (the JAX package's ``lax.scan``): returns (state, records,
    snaps) with a leading chunk axis on every record and snapshot entry.
    FusedFrontend.dispatch_chunk is its in-place, graph-replayed twin."""
    recs, snaps = [], []
    for img in images:
        feats = extract_orb(img, orb_cfg)
        state, rec = _megastep_core(
            cam, state, feats["uv"], feats["desc_bits"], feats["octave"],
            feats["valid"], feats["angle"],
            scale_factor=scale_factor, n_levels=n_levels,
            min_track_matches=min_track_matches,
            min_inliers_track=min_inliers_track, undistort=undistort)
        recs.append(rec)
        snap = {k: state[s] for k, s in _SNAP_KEYS.items()}
        snap["desc"] = H.pack_bits_device(state["kp_desc"])
        snaps.append(snap)
    stack = lambda rows: {k: torch.stack([r[k] for r in rows])
                          for k in rows[0]}
    return state, stack(recs), stack(snaps)


@torch.no_grad()
def _refresh_step(state, bundle, remap, aRo, ato, aRn, atn):
    """Device-side bundle swap: remap the previous frame's slot bindings
    into the NEW bundle, rigidly re-anchor the tracked pose from the old
    anchor-KF pose to its current (post-BA) pose, and carry the visit
    counters across the slot permutation. No readback, so a pipelined
    chunk in flight is never drained. Returns a new state dict."""
    L = bundle["pos"].shape[0]
    slot = state["prev_slot"]
    new_slot = torch.where(slot >= 0,
                           remap[torch.clamp(slot, min=0).long()], -1)
    # rigid world-frame hand-off: T_prev' = T_rel * T_anchor_new,
    # T_rel = T_prev * T_anchor_old^-1
    R_cr = state["prev_R"] @ aRo.T
    prev_R = R_cr @ aRn
    prev_t = R_cr @ atn + (state["prev_t"] - R_cr @ ato)
    # counters follow their landmark to its new slot (sink slot L = evicted)
    dest = torch.where(remap >= 0, remap, L).long()
    zeros = torch.zeros(L + 1, dtype=torch.int32, device=slot.device)
    acc_v = zeros.index_add(0, dest, state["acc_visible"])[:L]
    acc_f = zeros.index_add(0, dest, state["acc_found"])[:L]
    return dict(
        state,
        lm_pos=bundle["pos"], lm_desc=bundle["desc_packed"],
        lm_signs=H.signs_from_packed(bundle["desc_packed"]),
        lm_normal=bundle["normal"], lm_dmin=bundle["dmin"],
        lm_dmax=bundle["dmax"], lm_valid=bundle["valid"],
        prev_slot=new_slot.to(torch.int32), prev_R=prev_R, prev_t=prev_t,
        acc_visible=acc_v, acc_found=acc_f)


def _pack_record(rec):
    """Record dict -> (REC_WIDTH,) int32 row (floats bit-cast)."""
    pose = torch.cat([rec["R"].reshape(9), rec["t"]]).view(torch.int32)
    ints = torch.stack([rec[k].to(torch.int32) for k in _REC_INTS])
    return torch.cat([pose, ints])


def _unpack_records(rows: np.ndarray) -> dict:
    """(C, REC_WIDTH) int32 host rows -> dict of host arrays, chunk axis
    first (the JAX package's stacked record pytree)."""
    rows = np.ascontiguousarray(rows)
    pose = rows[:, :12].view(np.float32)
    out = dict(R=pose[:, :9].reshape(-1, 3, 3).copy(), t=pose[:, 9:].copy())
    for i, k in enumerate(_REC_INTS):
        col = rows[:, 12 + i]
        out[k] = col.astype(bool) if k in _REC_BOOLS else col.copy()
    return out


# ---------------------------------------------------------------------------
# pinned upload blob
# ---------------------------------------------------------------------------
class _Blob:
    """A set of named arrays in one flat buffer: pinned on the host, with
    a twin on the device. ``host[name]`` are numpy views to fill,
    ``dev[name]`` tensor views to read; ``upload()`` is ONE host-to-device
    copy that never waits for work already queued on the stream. Before the
    host side is refilled, ``wait()`` makes sure the last upload left it."""

    _ALIGN = 16

    def __init__(self, fields: dict, device):
        self.device = torch.device(device)
        offs, size = {}, 0
        for name, (shape, dtype) in fields.items():
            n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
            offs[name] = (size, n, shape, np.dtype(dtype))
            size += -(-max(n, 1) // self._ALIGN) * self._ALIGN
        cuda = self.device.type == "cuda"
        self._host = torch.zeros(size, dtype=torch.uint8, pin_memory=cuda)
        self._dev = torch.zeros(size, dtype=torch.uint8, device=self.device) \
            if cuda else self._host
        self._event = torch.cuda.Event() if cuda else None
        self._sent = False
        host_np = self._host.numpy()
        self.host, self.dev = {}, {}
        for name, (off, n, shape, dtype) in offs.items():
            self.host[name] = host_np[off:off + n].view(dtype).reshape(shape)
            tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
            self.dev[name] = self._dev[off:off + n].view(tdtype).reshape(shape)

    def wait(self):
        if self._sent:
            self._event.synchronize()
            self._sent = False

    def fill(self, values: dict):
        self.wait()
        for name, v in values.items():
            self.host[name][...] = v

    def upload(self):
        if self._event is not None:
            self._dev.copy_(self._host, non_blocking=True)
            self._event.record()
            self._sent = True


class _ChunkHandle:
    """What dispatch_chunk returns: the chunk's device outputs, the pinned
    readback and the host-side context captured at dispatch."""
    __slots__ = ("snaps", "host", "done", "count", "anchor", "epoch", "ids")


class FusedFrontend:
    """Host-side controller of the device-resident tracking loop.

    Owns the static device state buffers, the graph runner and the host-side
    slot->landmark-id mapping; the Tracking state machine calls step()/
    rebuild()/materialize() and never touches device tensors directly.
    """

    _RING = 3       # pinned upload/readback buffers: two chunks in flight + 1

    def __init__(self, store, cam, cfg, orb_cfg, device):
        self.store = store
        self.cam = cam
        self.cfg = cfg          # TrackingConfig
        self.orb_cfg = orb_cfg
        self.device = torch.device(device)
        self.state = None       # the static buffers while live, else None
        self.bundle_ids = None  # (L,) np.int64 — slot -> mp id
        self.version = -1       # store.version the bundle was built at
        self.local_kf = None
        self.anchor_kf = -1     # bundle anchor + its pose at snapshot time
        self.anchor_R = None
        self.anchor_t = None
        self.anchor_seq = -1    # its creation number (store.kf_seq)
        self.rec_anchor = None  # anchor of the last COLLECTED chunk
        self.rec_ids = None     # its slot->landmark table (at dispatch)
        self._bundle_epoch = 0  # bumped at every rebuild/refresh
        self._counter_lock = threading.Lock()
        L, P = cfg.n_local_mp, cfg.max_kp
        self._acc_base_vis = np.zeros(L, np.int32)
        self._acc_base_fnd = np.zeros(L, np.int32)
        self._chunk_snaps = None
        self._chunk_done = None
        self._vel = None
        # static device buffers (allocated once: a captured graph holds
        # their addresses; rebuild/refresh/step write INTO them)
        dev = self.device
        self._blob = _Blob(state_fields(L, P), dev)
        self._bufs = dict(self._blob.dev)
        self._bufs["lm_signs"] = torch.zeros((L, H.DESC_BITS),
                                             dtype=torch.int8, device=dev)
        f32, i32, u8, b = np.float32, np.int32, np.uint8, np.bool_
        self._refresh_blob = _Blob(dict(
            pos=((L, 3), f32), desc_packed=((L, H.DESC_BYTES), u8),
            normal=((L, 3), f32), dmin=((L,), f32), dmax=((L,), f32),
            valid=((L,), b), remap=((L,), i32), aRo=((3, 3), f32),
            ato=((3,), f32), aRn=((3, 3), f32), atn=((3,), f32)), dev)
        h, w = cam.height, cam.width
        self._img_in = torch.zeros((h, w), dtype=torch.uint8, device=dev)
        self._rec_row = torch.zeros(REC_WIDTH, dtype=torch.int32, device=dev)
        self._snap_desc = torch.zeros((P, H.DESC_BYTES), dtype=torch.uint8,
                                      device=dev)
        self._step_kw = dict(
            scale_factor=cfg.scale_factor, n_levels=cfg.n_levels,
            min_track_matches=cfg.min_track_matches,
            min_inliers_track=cfg.min_inliers_track,
            undistort=cam.has_distortion)
        restore = [self._bufs[k] for k in _STEP_KEYS] + [
            self._rec_row, self._snap_desc]
        self.runner = GraphRunner(self._frame_step, dev, restore=restore)
        self._pins: dict = {}           # pinned rings, by (kind, shape)
        self._n_dispatch = 0

    # ------------------------------------------------------------------
    # the captured step
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _frame_step(self):
        """Extraction + megastep of the image in the static input buffer,
        results written into the static state, record and snapshot
        buffers. Captured once on the card; called eagerly on the CPU."""
        st = self._bufs
        f = extract_orb(self._img_in, self.orb_cfg)
        new, rec = _megastep_core(self.cam, st, f["uv"], f["desc_bits"],
                                  f["octave"], f["valid"], f["angle"],
                                  **self._step_kw)
        self._commit(new, rec)

    def _commit(self, new, rec):
        st = self._bufs
        for k in _STEP_KEYS:
            st[k].copy_(new[k])
        self._rec_row.copy_(_pack_record(rec))
        self._snap_desc.copy_(H.pack_bits_device(new["kp_desc"]))

    # ------------------------------------------------------------------
    def warm(self):
        """Build the kernel, warm and capture the frame step on the calling
        thread. A no-op on the CPU and once captured."""
        self.runner.capture()

    @property
    def n_captures(self) -> int:
        return self.runner.captures

    def ready(self) -> bool:
        return (self.state is not None
                and self.version == self.store.version)

    def invalidate(self):
        """Fold counters and drop the device state (host takes over)."""
        if self.state is not None:
            self._fold_counters()
        self.state = None

    # ------------------------------------------------------------------
    def _pinned(self, kind, shape, dtype):
        """Next slot of a ring of pinned host tensors (plain host tensors on
        the CPU): (tensor, event). The event marks the slot's last transfer;
        the ring is one longer than the chunks that can be in flight."""
        key = (kind, tuple(shape), dtype)
        ring = self._pins.get(key)
        if ring is None:
            cuda = self.device.type == "cuda"
            ring = [(torch.zeros(shape, dtype=dtype, pin_memory=cuda),
                     torch.cuda.Event() if cuda else None)
                    for _ in range(self._RING)]
            self._pins[key] = ring
        return ring[self._n_dispatch % self._RING]

    def _upload_images(self, images_u8):
        """(C, H, W) uint8 host stack -> device, through pinned memory, not
        waiting for work already queued."""
        imgs = np.ascontiguousarray(images_u8, np.uint8)
        if self.device.type != "cuda":
            return torch.from_numpy(imgs)
        pin, sent = self._pinned("img", imgs.shape, torch.uint8)
        sent.synchronize()          # the slot's last upload has left it
        pin.numpy()[...] = imgs
        dev = pin.to(self.device, non_blocking=True)
        sent.record()
        return dev

    # ------------------------------------------------------------------
    def extract(self, image_u8):
        """Stage one image in the static input buffer (the extraction runs
        inside the frame step, on the device). Returns the staged tensor."""
        self._n_dispatch += 1
        self._img_in.copy_(self._upload_images(image_u8[None])[0])
        return self._img_in

    def step(self, feats=None):
        """Run the frame step on the staged image (``feats`` is what
        extract returned: the static input itself); ONE readback.

        Returns the host record dict (scalars + pose numpy arrays).
        """
        self.rec_anchor = None      # per-frame path: live anchor applies
        self.runner.run()
        return self.read_record()

    def read_record(self):
        """The last frame step's record, read back (one sync)."""
        rows = self._rec_row.cpu().numpy()[None]
        return {k: v[0] for k, v in _unpack_records(rows).items()}

    def dispatch_chunk(self, images_u8):
        """Enqueue a chunk's tracking on the device WITHOUT waiting:
        advances the device state and returns a handle. One upload of the
        image stack (pinned, asynchronous), then per frame a device copy
        into the static input, the step (a graph replay on the card) and
        device copies of the frame's record and snapshot into row j of the
        chunk's own buffers, then one asynchronous readback of the records
        and the post-chunk visit counters into pinned memory. The chunk's
        buffers are allocated per chunk, so a later chunk never overwrites
        a snapshot the mapping worker still holds. The handle captures the
        bundle-anchor snapshot the chunk tracks against (a device-side
        refresh may swap the live anchor before the chunk is collected)."""
        self._n_dispatch += 1
        dev, st = self.device, self._bufs
        C = len(images_u8)
        L = self.cfg.n_local_mp
        imgs = self._upload_images(images_u8)
        out = torch.empty(C * REC_WIDTH + 2 * L, dtype=torch.int32,
                          device=dev)
        rows = out[:C * REC_WIDTH].view(C, REC_WIDTH)
        snaps = {k: torch.empty((C,) + tuple(st[s].shape), dtype=st[s].dtype,
                                device=dev) for k, s in _SNAP_KEYS.items()}
        snaps["desc"] = torch.empty((C,) + tuple(self._snap_desc.shape),
                                    dtype=torch.uint8, device=dev)
        for j in range(C):
            self._img_in.copy_(imgs[j])
            self.runner.run()
            rows[j].copy_(self._rec_row)
            for k, s in _SNAP_KEYS.items():
                snaps[k][j].copy_(st[s])
            snaps["desc"][j].copy_(self._snap_desc)
        out[C * REC_WIDTH:C * REC_WIDTH + L].copy_(st["acc_visible"])
        out[C * REC_WIDTH + L:].copy_(st["acc_found"])
        h = _ChunkHandle()
        h.snaps, h.count = snaps, C
        if dev.type == "cuda":
            h.host, _ = self._pinned("out", out.shape, torch.int32)
            h.host.copy_(out, non_blocking=True)
            h.done = torch.cuda.Event()
            h.done.record()
        else:
            h.host, h.done = out, None
        h.anchor = (self.anchor_kf, self.anchor_R, self.anchor_t,
                    self.anchor_seq)
        h.epoch, h.ids = self._bundle_epoch, self.bundle_ids
        self._chunk_snaps, self._chunk_done = snaps, h.done
        return h

    def collect_chunk(self, handle):
        """Block on a dispatch_chunk handle; returns host records,
        re-points the snapshot buffer at that chunk, and exposes the
        chunk's anchor snapshot as rec_anchor (for KF-relative records)
        and its slot->landmark table as rec_ids (a device-side refresh
        may have swapped the LIVE bundle_ids since the dispatch — the
        chunk's snapshots hold OLD-bundle slot indices). The post-chunk
        visit counters ride the SAME readback and are folded into the
        store here — unless a refresh swapped the slot space since the
        dispatch (the refresh remapped the live counters; these stale
        ones are already accounted for)."""
        h = handle
        self._chunk_snaps, self._chunk_done = h.snaps, h.done
        self.rec_anchor = h.anchor
        self.rec_ids = h.ids
        if h.done is not None:
            h.done.synchronize()                # the ONE wait per chunk
        flat = h.host.numpy()
        C, L = h.count, self.cfg.n_local_mp
        recs = _unpack_records(flat[:C * REC_WIDTH].reshape(C, REC_WIDTH))
        acc_v = flat[C * REC_WIDTH:C * REC_WIDTH + L].copy()
        acc_f = flat[C * REC_WIDTH + L:].copy()
        if h.epoch == self._bundle_epoch:
            self._fold_counters(dict(acc_visible=acc_v, acc_found=acc_f))
        return recs

    def step_chunk(self, images_u8):
        """Track a stack of frames (dispatch + collect); ONE upload + ONE
        readback of the records. Per-frame feature snapshots stay on the
        device (self._chunk_snaps) for mid-chunk keyframe materialization."""
        return self.collect_chunk(self.dispatch_chunk(images_u8))

    # ------------------------------------------------------------------
    def _read(self, tensors: dict, done=None) -> dict:
        """One batched readback of a dict of device tensors. ``done``: the
        event after which they are complete, when they were written on
        another stream than the caller's. The host arrays are copies on the
        CPU too, where ``.cpu()`` would alias the state buffers that the
        next step or rebuild overwrites."""
        if done is not None:
            torch.cuda.current_stream(self.device).wait_event(done)
        return {k: v.to("cpu", copy=True).numpy() for k, v in tensors.items()}

    def _frame_from(self, got, timestamp, frame_id):
        from .frame import Frame
        frame = Frame(uv=got["uv"], desc_bits=H.unpack_bits(got["desc"]),
                      octave=got["oct"], valid=got["valid"],
                      angle=got["angle"], timestamp=timestamp,
                      frame_id=frame_id, device=self.device)
        frame.set_pose(got["R"], got["t"])
        return frame

    def materialize_from(self, snaps, j, timestamp, frame_id, bundle_ids,
                         done=None):
        """Worker-thread materialization: build a Frame from an explicit
        snapshot handle + the bundle-id table CAPTURED at decision time
        (the live bundle may have been swapped by a refresh since). No
        counter fold — collect_chunk already folds per chunk. ``done`` is
        the chunk's completion event: the worker's stream waits for it
        before it reads the snapshot."""
        got = self._read(_snap_slice(snaps, j), done)
        frame = self._frame_from(got, timestamp, frame_id)
        slot = got["slot"]
        bound = slot >= 0
        mp = np.where(bound, bundle_ids[np.maximum(slot, 0)], -1)
        mp = self.store.resolve_replacements(mp)
        live = (mp >= 0) & self.store.mp_valid[np.maximum(mp, 0)]
        frame.mp[:] = np.where(live, mp, -1)
        return frame

    def materialize_chunk_frame(self, j, timestamp, frame_id):
        """Materialize frame j of the last chunk (ONE batched readback of
        that frame's snapshot slices + the counter fold). Slot bindings
        resolve through the ids table CAPTURED AT THE CHUNK'S DISPATCH
        (rec_ids): the live bundle_ids may have been swapped by a
        pipelined refresh since."""
        ids = self.rec_ids if self.rec_ids is not None else self.bundle_ids
        src = dict(_snap_slice(self._chunk_snaps, j),
                   acc_visible=self.state["acc_visible"],
                   acc_found=self.state["acc_found"])
        got = self._read(src)
        self._fold_counters(got)
        frame = self._frame_from(got, timestamp, frame_id)
        slot = got["slot"]
        bound = slot >= 0
        mp = np.where(bound, ids[np.maximum(slot, 0)], -1)
        mp = self.store.resolve_replacements(mp)
        live = bound & (mp >= 0) & self.store.mp_valid[np.maximum(mp, 0)]
        frame.mp[:] = np.where(live, mp, -1)
        return frame

    # ------------------------------------------------------------------
    def materialize_frame(self, timestamp, frame_id):
        """ONE batched readback of the current frame + bindings/counters
        (keyframe or failure event): returns the Frame."""
        st = self.state
        src = {k: st[s] for k, s in _SNAP_KEYS.items()}
        src.update(desc=self._snap_desc, vel_R=st["vel_R"],
                   vel_t=st["vel_t"], acc_visible=st["acc_visible"],
                   acc_found=st["acc_found"])
        got = self._read(src)
        self._fold_counters(got)
        frame = self._frame_from(got, timestamp, frame_id)
        slot = got["slot"]
        bound = slot >= 0
        mp = np.where(bound, self.bundle_ids[np.maximum(slot, 0)], -1)
        live = bound & (mp >= 0) & self.store.mp_valid[np.maximum(mp, 0)]
        frame.mp[:] = np.where(live, mp, -1)
        self._vel = (got["vel_R"], got["vel_t"])
        return frame

    def refresh_bundle(self, anchor_kf: int, rel_pose=None):
        """Re-anchor the device bundle to the CURRENT map after an async
        mapping step finished (store.version changed while tracking kept
        riding the old bundle snapshot). ONE readback + ONE upload.

        rel_pose: optional (R_cr, t_cr, ref_kf, ref_seq) of the LAST
        tracked frame relative to its reference keyframe at record time.
        When given, the tracked pose is RE-ANCHORED to the reference KF's
        current (post-BA) pose — Tracking::UpdateLastFrame parity —
        unless that keyframe's slot was culled or reused since."""
        st = self.state
        got = self._read(dict(
            slot=st["prev_slot"], R=st["prev_R"], t=st["prev_t"],
            oct=st["kp_oct"], vel_R=st["vel_R"], vel_t=st["vel_t"],
            have_vel=st["have_vel"],
            acc_visible=st["acc_visible"], acc_found=st["acc_found"]))
        self._fold_counters(got)
        slot = got["slot"]
        mp = np.where(slot >= 0, self.bundle_ids[np.maximum(slot, 0)], -1)
        mp = self.store.resolve_replacements(mp)
        vel = (got["vel_R"], got["vel_t"]) if bool(got["have_vel"]) else None
        prev_R, prev_t = got["R"], got["t"]
        if rel_pose is not None:
            R_cr, t_cr, ref, seq = rel_pose
            if self.store.slot_is(ref, seq):
                prev_R = (R_cr @ self.store.kf_R[ref]).astype(np.float32)
                prev_t = (R_cr @ self.store.kf_t[ref]
                          + t_cr).astype(np.float32)
        self.rebuild(anchor_kf, mp, prev_R, prev_t, velocity=vel,
                     prev_oct=got["oct"])

    def _gather_bundle(self, anchor_kf):
        s, cfg = self.store, self.cfg
        local = [anchor_kf] + [int(k) for k in s.covisible_keyframes(
            anchor_kf, n_best=2 * cfg.n_local_kf - 1)]
        mp_ids = s.local_map_points(np.asarray(local, np.int64))
        bundle = s.gather_map_points(mp_ids, pad_to=cfg.n_local_mp)
        ids = np.asarray(bundle["ids"])
        # slot lookup: landmark id -> bundle slot
        pos_of = np.full(s.cfg.max_map_points, -1, np.int64)
        live = ids >= 0
        pos_of[ids[live]] = np.nonzero(live)[0]
        host_bundle = dict(
            pos=np.asarray(bundle["pos"], np.float32),
            desc_packed=np.asarray(bundle["desc"], np.uint8),
            normal=np.asarray(bundle["normal"], np.float32),
            dmin=np.asarray(bundle["dmin"], np.float32),
            dmax=np.asarray(bundle["dmax"], np.float32),
            valid=np.asarray(bundle["valid"], bool))
        return local, ids, pos_of, host_bundle

    def refresh_bundle_device(self, anchor_kf: int):
        """Pipelined bundle refresh: swap the device bundle to the
        CURRENT map WITHOUT reading anything back — a host gather, ONE
        pinned upload and the device-side _refresh_step, all queued on the
        tracking stream. Because nothing blocks, the caller may have a
        chunk in flight: the refresh chains after it and re-anchors THAT
        chunk's final pose/bindings, so tracking continuity is exact even
        though the host never sees the state.

        Caller must hold store.lock (consistent map snapshot vs the
        async mapping worker)."""
        s = self.store
        L = self.cfg.n_local_mp
        local, ids_new, pos_of, host_bundle = self._gather_bundle(anchor_kf)
        # old slot -> new slot through landmark-replacement forwarding
        old_ids = s.resolve_replacements(self.bundle_ids)
        remap = np.where(old_ids >= 0,
                         pos_of[np.maximum(old_ids, 0)], -1).astype(np.int32)
        # Rigid hand-off must track the OLD anchor's own pose update
        # (snapshot -> current): T_prev' = (T_prev T_old_snap^-1) T_old_now.
        old = self.anchor_kf
        if s.slot_is(old, self.anchor_seq):
            aRc = s.kf_R[old].astype(np.float32)
            atc = s.kf_t[old].astype(np.float32)
        else:
            # old anchor culled (its slot maybe reused): no rigid
            # correction available — keep the
            # tracked pose as-is (identity hand-off)
            aRc, atc = self.anchor_R, self.anchor_t
        aRn = s.kf_R[anchor_kf].astype(np.float32)
        atn = s.kf_t[anchor_kf].astype(np.float32)
        rb = self._refresh_blob
        with self._counter_lock:
            rb.fill(dict(host_bundle, remap=remap, aRo=self.anchor_R,
                         ato=self.anchor_t, aRn=aRc, atn=atc))
            rb.upload()
            d = rb.dev
            new = _refresh_step(
                self._bufs, {k: d[k] for k in host_bundle}, d["remap"],
                d["aRo"], d["ato"], d["aRn"], d["atn"])
            for k in _REFRESH_KEYS:             # into the static buffers
                self._bufs[k].copy_(new[k])
            # counter baselines follow the same slot permutation
            ok = remap >= 0
            for base in ("_acc_base_vis", "_acc_base_fnd"):
                new_base = np.zeros(L, np.int32)
                np.add.at(new_base, remap[ok], getattr(self, base)[ok])
                setattr(self, base, new_base)
            self._bundle_epoch += 1
            self.bundle_ids = ids_new
        self.version = s.version
        self.local_kf = local
        self.anchor_kf = int(anchor_kf)
        self.anchor_R = aRn.copy()
        self.anchor_t = atn.copy()
        self.anchor_seq = int(s.kf_seq[anchor_kf])

    def _fold_counters(self, got=None):
        """Fold device visible/found accumulators into the MapStore.

        Baseline-delta scheme: the device accumulators are NEVER reset
        (resetting them raced with pipelined chunk dispatches that had
        already consumed the pre-reset values); the host remembers the
        totals it last folded and adds only the delta."""
        if self.state is None or self.bundle_ids is None:
            return
        if got is None:
            got = self._read(dict(acc_visible=self.state["acc_visible"],
                                  acc_found=self.state["acc_found"]))
        with self._counter_lock:
            vis = np.asarray(got["acc_visible"])
            fnd = np.asarray(got["acc_found"])
            ids = self.bundle_ids
            ok = ids >= 0
            sel = ids[ok]
            dv = np.maximum(vis - self._acc_base_vis, 0)
            df = np.maximum(fnd - self._acc_base_fnd, 0)
            self.store.mp_visible[sel] += dv[ok]
            self.store.mp_found[sel] += df[ok]
            self._acc_base_vis = np.maximum(vis, self._acc_base_vis)
            self._acc_base_fnd = np.maximum(fnd, self._acc_base_fnd)

    # ------------------------------------------------------------------
    def rebuild(self, anchor_kf: int, prev_mp, prev_R, prev_t,
                velocity=None, prev_oct=None):
        """(Re)build the device bundle + state after a map-changing event:
        one batched upload into the static state buffers.

        anchor_kf: keyframe whose covisibility neighborhood defines the
          local map (the freshly created KF, or the init reference).
        prev_mp: (P,) np.int64 landmark id per keypoint of the last
          tracked frame (drives next frame's motion search).
        prev_R/prev_t: last tracked frame's pose, post-BA.
        """
        s, cfg = self.store, self.cfg
        local, ids, pos_of, host_bundle = self._gather_bundle(anchor_kf)
        prev_mp = np.asarray(prev_mp)
        prev_slot = np.where(prev_mp >= 0,
                             pos_of[np.maximum(prev_mp, 0)],
                             -1).astype(np.int32)
        if velocity is None:
            velocity = self._vel
        have_vel = velocity is not None
        vel_R = velocity[0] if have_vel else np.eye(3, dtype=np.float32)
        vel_t = velocity[1] if have_vel else np.zeros(3, np.float32)
        P = cfg.max_kp
        if prev_oct is None:
            prev_oct = s.kf_octave[anchor_kf]
        template = dict(uv=np.zeros((P, 2), np.float32),
                        desc=np.zeros((P, H.DESC_BITS), np.uint8),
                        oct=np.asarray(prev_oct, np.int32),
                        valid=np.zeros(P, bool),
                        angle=np.zeros(P, np.float32))
        state_host = make_state(
            host_bundle, prev_slot, np.asarray(prev_oct, np.int32),
            np.asarray(prev_R, np.float32), np.asarray(prev_t, np.float32),
            vel_R, vel_t, have_vel, template)
        # ONE upload, straight into the static state (queued after any chunk
        # still in flight, whose mutations it overwrites)
        self._blob.fill(state_host)
        self._blob.upload()
        self._bufs["lm_signs"].copy_(
            H.signs_from_packed(self._bufs["lm_desc"]))
        self._snap_desc.zero_()
        self.state = self._bufs
        self.bundle_ids = ids
        self.version = s.version
        self.local_kf = local
        # anchor pose AS OF THIS SNAPSHOT: poses tracked against this
        # bundle live in ITS map frame; KF-relative records must use this
        # pose, not the store's current one — async BA may move the
        # anchor mid-bundle
        self.anchor_kf = int(anchor_kf)
        self.anchor_R = s.kf_R[anchor_kf].copy()
        self.anchor_t = s.kf_t[anchor_kf].copy()
        self.anchor_seq = int(s.kf_seq[anchor_kf])
        self.rec_anchor = None
        self.rec_ids = None     # snapshots from before this rebuild are dead
        self._bundle_epoch += 1
        L = self.cfg.n_local_mp
        self._acc_base_vis = np.zeros(L, np.int32)
        self._acc_base_fnd = np.zeros(L, np.int32)
