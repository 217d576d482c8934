"""Per-frame feature container.

Port of ar_orbslam2_tpu/system/frame.py (the reference Frame): fixed-
capacity padded host arrays with a validity mask; no occupancy grid —
spatial gating happens as masks inside the windowed searches. Device copies
live on the frame's ``device`` (the SlamSystem's).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import hamming as H


@dataclass
class Frame:
    """One camera frame: padded features + (once tracked) pose/bindings.

    uv are undistorted level-0 pixel coordinates.
    """
    uv: np.ndarray                # (P, 2) float32
    desc_bits: np.ndarray         # (P, 256) uint8 in {0,1}
    octave: np.ndarray            # (P,) int32
    valid: np.ndarray             # (P,) bool
    angle: np.ndarray | None = None      # (P,) float32 degrees
    uvr: np.ndarray | None = None        # (P,) stereo right-u (<0 mono)
    depth: np.ndarray | None = None      # (P,) depth (<0 unknown)
    timestamp: float = 0.0
    frame_id: int = -1
    # pose (world->camera); None until tracked
    R: np.ndarray | None = None
    t: np.ndarray | None = None
    # landmark binding per feature (-1 = none)
    mp: np.ndarray = field(default=None)
    device: torch.device | str = "cpu"

    def __post_init__(self):
        P = self.uv.shape[0]
        if self.mp is None:
            self.mp = np.full(P, -1, np.int64)
        if self.angle is None:
            self.angle = np.zeros(P, np.float32)
        self.ref_kf = -1
        self.ref_seq = None     # the reference keyframe's creation number
        self.R_cr = None
        self.t_cr = None
        self._signs = None
        self._packed = None
        self._dev = {}

    def dev(self, name):
        """Cached device copy of an immutable per-frame array (uv, octave,
        valid, angle, desc_packed, uvr, depth) — uploaded once per frame."""
        hit = self._dev.get(name)
        if hit is None:
            hit = torch.as_tensor(np.ascontiguousarray(getattr(self, name)),
                                  device=self.device)
            self._dev[name] = hit
        return hit

    @property
    def n_kp(self) -> int:
        return int(self.valid.sum())

    @property
    def signs(self):
        """Device ±1 descriptor matrix (cached)."""
        if self._signs is None:
            self._signs = H.to_signs(self.desc_bits, device=self.device)
        return self._signs

    @property
    def desc_packed(self):
        """(P, 32) packed descriptors for MapStore storage (cached)."""
        if self._packed is None:
            self._packed = H.pack_bits(self.desc_bits)
        return self._packed

    def set_pose(self, R, t):
        from ..core.lie import project_so3
        self.R = project_so3(np.asarray(R, np.float32))
        self.t = np.asarray(t, np.float32)

