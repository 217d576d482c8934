"""What decides ``correct``: the program's outputs from the timed window,
judged by the plain references, each number against its limit.

Numbers (each is a reading; ``limits/<cell>.json`` holds the limit of
each one a cell compares and the readings it was set from):

  * ``failed_frames``: window frames that got no pose (an answer that
    never came). Limit 0.
  * ``orb_bit_err_pct``: on sampled window frames, the keypoints and
    descriptors the timed path extracted (a chunk's on-device snapshot)
    against ``reference.orb`` on the same image at the same keypoint
    budget: of all keypoints of either side, the share of descriptor bits
    that differ, a keypoint missing from the other side counting as 256
    differing bits.
  * ``ate_mm``, ``rpe_mm``, ``rot_deg``: the window's returned poses
    against the rendered truth, under the similarity that maps the
    window's estimated trajectory onto the truth (``geometry.align``):
    RMS centre error, RMS frame-to-frame displacement error, RMS
    orientation error.
  * ``kf_ate_mm``: the live keyframes' poses after the run (the mapping
    stage's output) against the truth of their frames, likewise aligned.
  * ``landmark_err_mm``: the median distance from the live landmarks,
    moved by the keyframes' similarity, to the nearest true surface.
"""
from __future__ import annotations

import numpy as np

from . import geometry as G
from . import orb as ORB

BITS = 256


def unpack_desc(packed):
    """(N, 32) uint8 descriptors, LSB first -> (N, 256) bits."""
    return np.unpackbits(np.asarray(packed, np.uint8), axis=-1,
                         bitorder="little")


def raw_keys(uv_raw, octave, scale_factor):
    """(octave, x, y) keys of keypoints on their level's pixel grid."""
    s = scale_factor ** np.asarray(octave, np.float64)
    uv = np.asarray(uv_raw, np.float64)
    return [(int(o), int(x), int(y)) for o, x, y in
            zip(octave, np.rint(uv[:, 0] / s), np.rint(uv[:, 1] / s))]


def program_keys(cam, uv_undist, octave, scale_factor):
    """Keys of the program's keypoints, which it keeps as undistorted
    pixels: the camera's distortion is reapplied first."""
    return raw_keys(G.distort_px(cam, uv_undist), octave, scale_factor)


def orb_mismatch(keys, desc, ref, scale_factor):
    """(differing bits, bits compared) of one frame: keypoints `keys` with
    descriptors `desc` (N, 256) bits against the reference's output."""
    rk = raw_keys(ref["uv"], ref["octave"], scale_factor)
    pi = {k: i for i, k in enumerate(keys)}
    ri = {k: i for i, k in enumerate(rk)}
    common = [k for k in pi if k in ri]
    diff = sum(int((desc[pi[k]] != ref["desc"][ri[k]]).sum())
               for k in common)
    missing = (len(pi) - len(common)) + (len(ri) - len(common))
    return diff + BITS * missing, BITS * (len(common) + missing)


def orb_reading(frames, images, cam, orb_params, low_dtype=None):
    """``orb_bit_err_pct`` over ``frames``: [(frame index, program dict
    with uv (undistorted), octave, desc bits)]. With ``low_dtype`` the
    program's outputs are ignored and the reference computed in that
    precision takes their place (the control)."""
    import torch
    sf = orb_params["scale_factor"]
    diff = total = 0
    for idx, prog in frames:
        ref = ORB.extract(images[idx], dtype=torch.float64, **orb_params)
        if low_dtype is None:
            keys = program_keys(cam, prog["uv"], prog["octave"], sf)
            desc = prog["desc"]
        else:
            low = ORB.extract(images[idx], dtype=low_dtype, **orb_params)
            keys = raw_keys(low["uv"], low["octave"], sf)
            desc = low["desc"]
        d, t = orb_mismatch(keys, desc, ref, sf)
        diff += d
        total += t
    return 100.0 * diff / max(total, 1)


def pose_readings(R_cw_true, t_cw_true, R_cw_est, t_cw_est):
    """ate_mm, rpe_mm, rot_deg of one trajectory (truth in metres)."""
    Rt, ct = G.camera_frames(R_cw_true, t_cw_true)
    Re, ce = G.camera_frames(R_cw_est, t_cw_est)
    sim = G.align(Rt, ct, Re, ce)
    return dict(ate_mm=1e3 * G.ate(sim, ct, ce),
                rpe_mm=1e3 * G.rpe(sim, ct, ce),
                rot_deg=G.rotation_error_deg(sim, Rt, Re))


def map_readings(R_cw_true, t_cw_true, kf_R, kf_t, points, surface_distance):
    """kf_ate_mm and landmark_err_mm of a map: keyframe poses with their
    frames' truth, landmark positions (M, 3)."""
    Rt, ct = G.camera_frames(R_cw_true, t_cw_true)
    Re, ce = G.camera_frames(kf_R, kf_t)
    sim = G.align(Rt, ct, Re, ce)
    out = dict(kf_ate_mm=1e3 * G.ate(sim, ct, ce))
    if len(points):
        out["landmark_err_mm"] = 1e3 * float(np.median(
            surface_distance(G.apply(sim, points))))
    return out


def judge(readings: dict, limits: dict):
    """(correct, lines): each compared number beside its limit, in the
    limits file's order. A number the run could not read fails."""
    ok = True
    lines = []
    for name, spec in limits["numbers"].items():
        value = readings.get(name)
        passed = value is not None and np.isfinite(value) \
            and value <= spec["limit"]
        ok &= bool(passed)
        lines.append((name, value, spec["limit"], bool(passed)))
    return ok, lines
