"""Carry a running system's state into a port SlamSystem.

The JAX package and this port keep the same host state under the same
attribute names: the MapStore arrays (the checkpoint list,
mapstore/checkpoint.py), Tracking's scalars and velocity, and the last
frame. ``export_state`` reads that state from either package's SlamSystem
into plain numpy (it reads attributes only and imports neither framework's
device code); ``from_state`` builds a port SlamSystem from it. With the two,
both packages can track the same next frames from the same map.
"""
from __future__ import annotations

import copy

import numpy as np

from .mapstore.checkpoint import _ARRAYS
from .system.frame import Frame
from .system.slam import SlamSystem

_FRAME_FIELDS = ("R", "t", "mp", "uv", "desc_bits", "octave", "valid",
                 "angle")


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
        tracking=dict(
            state=t.state, ref_kf=int(t.ref_kf),
            last_kf_frame_id=int(t.last_kf_frame_id),
            velocity=None if t.velocity is None
            else tuple(_np(v) for v in t.velocity)),
        mapper_recent=dict(slam.mapper.recent),
        next_frame_id=int(slam._next_frame_id),
        last_frame=None)
    if lf is not None:
        frame = {k: _np(getattr(lf, k)) for k in _FRAME_FIELDS}
        frame.update(frame_id=int(lf.frame_id), timestamp=float(lf.timestamp),
                     ref_kf=int(getattr(lf, "ref_kf", -1)),
                     R_cr=_np(getattr(lf, "R_cr", None)),
                     t_cr=_np(getattr(lf, "t_cr", None)))
        state["last_frame"] = frame
    return state


def from_state(cam, cfg, state: dict, device="cpu", seed=0) -> SlamSystem:
    """A port SlamSystem holding `state` (from export_state, or the same
    keys built by hand: a map saved by the JAX package's save_map supplies
    every array of ``state["map"]``)."""
    slam = SlamSystem(cam, cfg, device=device, seed=seed)
    s, t = slam.store, slam.tracking
    for name in _ARRAYS:
        getattr(s, name)[...] = state["map"][name]
    s.next_kf = int(state["next_kf"])
    if state.get("mp_replaced") is not None:
        s.mp_replaced[...] = state["mp_replaced"]
    if state.get("mp_free") is not None:
        s.mp_free = [int(i) for i in state["mp_free"]]
    else:
        s.mp_free = [int(i) for i in np.nonzero(~s.mp_valid)[0][::-1]]
    s.bump()

    tr = state["tracking"]
    t.state = tr["state"]
    t.ref_kf = int(tr["ref_kf"])
    t.last_kf_frame_id = int(tr["last_kf_frame_id"])
    vel = tr.get("velocity")
    t.velocity = None if vel is None else tuple(
        np.asarray(v, np.float32) for v in vel)
    slam.mapper.recent = copy.copy(state.get("mapper_recent", {}))
    slam._next_frame_id = int(state.get("next_frame_id", 0))

    lf = state.get("last_frame")
    if lf is not None:
        frame = Frame(uv=lf["uv"], desc_bits=lf["desc_bits"],
                      octave=lf["octave"], valid=lf["valid"],
                      angle=lf["angle"], timestamp=lf["timestamp"],
                      frame_id=lf["frame_id"], R=lf["R"], t=lf["t"],
                      mp=np.asarray(lf["mp"], np.int64).copy(),
                      device=slam.device)
        frame.ref_kf = int(lf.get("ref_kf", -1))
        frame.R_cr = lf.get("R_cr")
        frame.t_cr = lf.get("t_cr")
        t.last_frame = frame
        slam.last_frame = frame
    return slam
