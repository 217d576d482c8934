"""Faults planted under a run to show that the check catches them.

The pose faults change what a ``track_monocular_batch`` call returns, where
the answer is produced; ``control.py`` applies them to the calls of a
sound run (the same as planting them, without a run each), and the tests
plant them in a run on the CPU, whose check must then fail. ``frozen_map``
breaks the mapping stage and needs a run of its own."""
from __future__ import annotations


def freeze(poses):
    """A step that returns its state unchanged: every frame of a call
    gets the pose of the call's first frame."""
    return [None if p is None else poses[0] for p in poses]


def halve(poses):
    """Half of each call left out: its second half gets no pose."""
    half = len(poses) // 2
    return poses[:half] + [None] * (len(poses) - half)


def reverse(poses):
    """An answer altered where it is produced: a call's poses come back in
    the reverse order of its frames (a readback that mixes up rows)."""
    return poses[::-1]


POSE_FAULTS = {"frozen_pose": freeze, "half_batch": halve,
               "altered_pose": reverse}


def plant_pose_fault(slam, fn):
    """Make every ``track_monocular_batch`` call of `slam` return
    ``fn(poses)``."""
    inner = slam.track_monocular_batch

    def batch(images, timestamps=None, chunk=8):
        return fn(inner(images, timestamps=timestamps, chunk=chunk))
    slam.track_monocular_batch = batch


def frozen_map():
    """The mapping stage's local BA returns its state unchanged (keyframes
    and landmarks keep the poses and positions they were made with).
    Patches the program's module; returns the function that undoes it."""
    import torch
    from ar_orbslam2_tpu_torch.mapping import local_mapping
    inner = local_mapping.bundle_adjust

    def bundle_adjust(cam_R, cam_t, cam_fixed, cam_valid, pts, pt_valid,
                      obs_cam, obs_uv, obs_octave, obs_valid, cam, **kw):
        return dict(cam_R=cam_R, cam_t=cam_t, pts=pts,
                    obs_inlier=obs_valid.clone(),
                    cost=torch.zeros((), device=pts.device))
    local_mapping.bundle_adjust = bundle_adjust

    def undo():
        local_mapping.bundle_adjust = inner
    return undo
