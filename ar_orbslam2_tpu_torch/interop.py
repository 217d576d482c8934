"""Carry a running system's state into a port SlamSystem.

The JAX package and this port keep the same host state under the same
attribute names: the MapStore arrays (the checkpoint list,
mapstore/checkpoint.py), Tracking's scalars and velocity, and the last
frame. ``export_state`` reads that state from either package's SlamSystem
into plain numpy (it reads attributes only and imports neither framework's
device code); ``from_state`` builds a port SlamSystem from it. With the two,
both packages can track the same next frames from the same map.

A live fused frontend is carried too: the device state pytree (as numpy),
the slot->landmark table, the bundle anchor, the counter baselines, and
Tracking's fused bookkeeping (``_fused_prev_pose``, the ``_inl_*`` levels,
``last_rel``). The JAX package keeps ±1 signs beside the packed landmark
descriptors; the port re-expands them on its device.

The place-recognition database goes across as well (the bow matrix, its
row mask, the codebook's bits and whether and when it was trained) with the
relocalizer's settings, so both packages rank the same candidates for the
same frame; and the loop closer's state (the last loop keyframe, the
consistency groups, the closed loops) with the store's loop edges, so both
packages detect, verify and correct the same loops from one map.

Localization mode (``only_tracking``, the ``vo`` regime) and the last
frame's stereo right-u and depth go across, so depth-sensor runs continue
from a carried state. So does the port's keyframe-slot state (creation
numbers, the free slots, the erasure records); a state from the JAX
package, which never reuses a slot, gets the state it implies (creation
number = id).
"""
from __future__ import annotations

import copy

import numpy as np

from .mapstore.checkpoint import _ARRAYS, restore_slots
from .ops import hamming as H
from .system.frame import Frame
from .system.slam import SlamSystem

_FRAME_FIELDS = ("R", "t", "mp", "uv", "desc_bits", "octave", "valid",
                 "angle", "uvr", "depth")
_FUSED_SCALARS = ("version", "anchor_kf", "_bundle_epoch")
_FUSED_ARRAYS = ("bundle_ids", "anchor_R", "anchor_t", "_acc_base_vis",
                 "_acc_base_fnd")


def _np(a):
    return None if a is None else np.array(a, copy=True)


def export_state(slam) -> dict:
    """Snapshot a SlamSystem (either package) as numpy arrays/scalars."""
    s, t = slam.store, slam.tracking
    lf = t.last_frame
    state = dict(
        map={name: np.array(getattr(s, name), copy=True) for name in _ARRAYS},
        mp_replaced=np.array(s.mp_replaced, copy=True),
        mp_free=list(s.mp_free),
        next_kf=int(s.next_kf),
        store_version=int(s.version),
        slots=None if not hasattr(s, "kf_seq") else dict(
            kf_seq=np.array(s.kf_seq, copy=True),
            n_created=int(s.n_kf_created), kf_free=list(s.kf_free),
            erased_parent=dict(s.kf_erased_parent), tombs=dict(s.kf_tombs)),
        tracking=dict(
            state=t.state, ref_kf=int(t.ref_kf),
            only_tracking=bool(getattr(t, "only_tracking", False)),
            vo=bool(getattr(t, "vo", False)),
            last_kf_frame_id=int(t.last_kf_frame_id),
            velocity=None if t.velocity is None
            else tuple(_np(v) for v in t.velocity),
            last_reloc_frame_id=int(t.last_reloc_frame_id),
            inl_peak=float(getattr(t, "_inl_peak", 0.0)),
            inl_decay=float(getattr(t, "_inl_decay", 0.0)),
            low_streak=int(getattr(t, "_low_streak", 0)),
            last_rel=None if getattr(t, "last_rel", None) is None
            else (_np(t.last_rel[0]), _np(t.last_rel[1]),
                  int(t.last_rel[2]),
                  int(t.last_rel[3]) if len(t.last_rel) > 3 else None),
            fused_prev_pose=None
            if getattr(t, "_fused_prev_pose", None) is None
            else tuple(_np(v) for v in t._fused_prev_pose)),
        fused=_export_fused(getattr(t, "fused", None)),
        kfdb=_export_kfdb(slam),
        loop_edges={int(k): sorted(int(x) for x in v)
                    for k, v in s.kf_loop_edges.items()},
        loop_closer=_export_loop_closer(getattr(t, "loop_closer", None)),
        mapper_recent=dict(slam.mapper.recent),
        next_frame_id=int(slam._next_frame_id),
        last_frame=None)
    if lf is not None:
        frame = {k: _np(getattr(lf, k)) for k in _FRAME_FIELDS}
        frame.update(frame_id=int(lf.frame_id), timestamp=float(lf.timestamp),
                     ref_kf=int(getattr(lf, "ref_kf", -1)),
                     ref_seq=getattr(lf, "ref_seq", None),
                     R_cr=_np(getattr(lf, "R_cr", None)),
                     t_cr=_np(getattr(lf, "t_cr", None)))
        state["last_frame"] = frame
    return state


def _export_kfdb(slam):
    """The keyframe database (the loop closer's when the system has one:
    after a reset of the JAX package it is not the relocalizer's) and the
    relocalizer's settings (either package), or None without a
    database."""
    t = slam.tracking
    lc = getattr(t, "loop_closer", None)
    kfdb = lc.kfdb if lc is not None else getattr(slam, "kfdb", None)
    if kfdb is None:
        return None
    reloc = getattr(t, "relocalizer", None)
    signs = kfdb.vocab.signs
    signs = signs.cpu().numpy() if hasattr(signs, "cpu") else np.asarray(signs)
    return dict(bow=np.array(kfdb.bow, copy=True),
                has_bow=np.array(kfdb.has_bow, copy=True),
                vocab_bits=(signs > 0).astype(np.uint8),
                trained=bool(kfdb.trained),
                trained_at=float(kfdb._trained_at),
                max_candidates=None if reloc is None
                else int(reloc.max_candidates))


def _load_kfdb(slam, db: dict):
    """Put an exported database into a port SlamSystem that has one."""
    from .loop.place_recognition import VocabTensor
    kfdb = slam.kfdb
    if not np.array_equal(db["vocab_bits"], kfdb.vocab.bits):
        kfdb.vocab = VocabTensor(bits=db["vocab_bits"], device=kfdb.device)
    kfdb.load(db["bow"], db["has_bow"])
    if "trained" in db:
        kfdb.trained = bool(db["trained"])
        kfdb._trained_at = db["trained_at"]
    reloc = slam.tracking.relocalizer
    if reloc is not None and db.get("max_candidates") is not None:
        reloc.max_candidates = int(db["max_candidates"])


def _export_loop_closer(lc):
    """A loop closer's state (either package) as plain Python/numpy, or
    None."""
    if lc is None:
        return None
    return dict(
        last_loop_kf=int(lc.last_loop_kf),
        consistent_groups=[(sorted(int(k) for k in g), int(c))
                           for g, c in lc.consistent_groups],
        loops=[{k: np.array(v, copy=True) if isinstance(v, np.ndarray)
                else v for k, v in loop.items()} for loop in lc.loops],
        gba=dict(n_launched=lc.gba.n_launched, n_applied=lc.gba.n_applied,
                 n_aborted=lc.gba.n_aborted))


def _load_loop_closer(lc, state: dict):
    lc.last_loop_kf = int(state["last_loop_kf"])
    lc.consistent_groups = [(set(int(k) for k in g), int(c))
                            for g, c in state["consistent_groups"]]
    lc.loops = [dict(loop) for loop in state["loops"]]
    for k, v in state["gba"].items():
        setattr(lc.gba, k, int(v))


def _export_fused(fe):
    """A live FusedFrontend (either package) as numpy, or None."""
    if fe is None or fe.state is None:
        return None
    out = dict(state={k: np.array(v.cpu() if hasattr(v, "cpu") else v,
                                  copy=True)
                      for k, v in fe.state.items() if k != "lm_signs"},
               local_kf=None if fe.local_kf is None
               else [int(k) for k in fe.local_kf],
               vel=None if getattr(fe, "_vel", None) is None
               else tuple(_np(v) for v in fe._vel))
    for k in _FUSED_SCALARS:
        out[k] = int(getattr(fe, k))
    for k in _FUSED_ARRAYS:
        out[k] = _np(getattr(fe, k))
    return out


def _load_fused(fe, fused: dict):
    """Put an exported fused state into a port FusedFrontend: one upload
    into its static buffers, then the host-side tables."""
    fe._blob.fill(fused["state"])
    fe._blob.upload()
    fe._bufs["lm_signs"].copy_(H.signs_from_packed(fe._bufs["lm_desc"]))
    fe._snap_desc.copy_(H.pack_bits_device(fe._bufs["kp_desc"]))
    fe.state = fe._bufs
    for k in _FUSED_SCALARS:
        setattr(fe, k, int(fused[k]))
    for k in _FUSED_ARRAYS:
        setattr(fe, k, _np(fused[k]))
    fe.local_kf = fused["local_kf"]
    fe._vel = fused["vel"]
    fe.rec_anchor = None
    fe.rec_ids = None


def from_state(cam, cfg, state: dict, device=None, seed=0) -> SlamSystem:
    """A port SlamSystem holding `state` (from export_state, or the same
    keys built by hand: a map saved by the JAX package's save_map supplies
    every array of ``state["map"]``)."""
    slam = SlamSystem(cam, cfg, device=device, seed=seed)
    s, t = slam.store, slam.tracking
    for name in _ARRAYS:
        getattr(s, name)[...] = state["map"][name]
    s.next_kf = int(state["next_kf"])
    slots = state.get("slots")
    if slots is not None:
        restore_slots(s, slots["kf_seq"], slots["n_created"],
                      slots["kf_free"])
        s.kf_erased_parent = dict(slots["erased_parent"])
        s.kf_tombs = dict(slots["tombs"])
    else:
        restore_slots(s)
    if state.get("mp_replaced") is not None:
        s.mp_replaced[...] = state["mp_replaced"]
    if state.get("mp_free") is not None:
        s.mp_free = [int(i) for i in state["mp_free"]]
    else:
        s.mp_free = [int(i) for i in np.nonzero(~s.mp_valid)[0][::-1]]
    if state.get("loop_edges") is not None:
        s.kf_loop_edges = {int(k): set(int(x) for x in v)
                           for k, v in state["loop_edges"].items()}
    s.bump()

    tr = state["tracking"]
    t.state = tr["state"]
    t.ref_kf = int(tr["ref_kf"])
    t.last_kf_frame_id = int(tr["last_kf_frame_id"])
    t.only_tracking = bool(tr.get("only_tracking", False))
    t.vo = bool(tr.get("vo", False))
    vel = tr.get("velocity")
    t.velocity = None if vel is None else tuple(
        np.asarray(v, np.float32) for v in vel)
    slam.mapper.recent = copy.copy(state.get("mapper_recent", {}))
    slam._next_frame_id = int(state.get("next_frame_id", 0))

    lf = state.get("last_frame")
    if lf is not None:
        frame = Frame(uv=lf["uv"], desc_bits=lf["desc_bits"],
                      octave=lf["octave"], valid=lf["valid"],
                      angle=lf["angle"], uvr=lf.get("uvr"),
                      depth=lf.get("depth"), timestamp=lf["timestamp"],
                      frame_id=lf["frame_id"], R=lf["R"], t=lf["t"],
                      mp=np.asarray(lf["mp"], np.int64).copy(),
                      device=slam.device)
        frame.ref_kf = int(lf.get("ref_kf", -1))
        frame.ref_seq = lf.get("ref_seq")
        if frame.ref_seq is None and frame.ref_kf >= 0:
            frame.ref_seq = int(s.kf_seq[frame.ref_kf])
        frame.R_cr = lf.get("R_cr")
        frame.t_cr = lf.get("t_cr")
        t.last_frame = frame
        slam.last_frame = frame

    t.last_reloc_frame_id = int(tr.get("last_reloc_frame_id",
                                       t.last_reloc_frame_id))
    t._inl_peak = float(tr.get("inl_peak", 0.0))
    t._inl_decay = float(tr.get("inl_decay", 0.0))
    t._low_streak = int(tr.get("low_streak", 0))
    rel = tr.get("last_rel")
    if rel is not None:
        # the JAX package keeps (R_cr, t_cr, ref): creation number = id
        R_cr, t_cr, ref = rel[:3]
        seq = rel[3] if len(rel) > 3 and rel[3] is not None \
            else int(s.kf_seq[ref])
        rel = (R_cr, t_cr, ref, seq)
    t.last_rel = rel
    t._fused_prev_pose = tr.get("fused_prev_pose")
    if state.get("kfdb") is not None and slam.kfdb is not None:
        _load_kfdb(slam, state["kfdb"])
    lc = getattr(t, "loop_closer", None)
    if state.get("loop_closer") is not None and lc is not None:
        _load_loop_closer(lc, state["loop_closer"])
    fused = state.get("fused")
    if fused is not None and t.fused is not None:
        _load_fused(t.fused, fused)
        if t.fused.anchor_kf >= 0:
            t.fused.anchor_seq = int(s.kf_seq[t.fused.anchor_kf])
        # s.bump() above moved the store's version: a bundle that was
        # current for the exported map is current for the carried one
        current = fused["version"] == state.get("store_version")
        t.fused.version = s.version if current else -1
    return slam
