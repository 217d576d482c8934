"""Pinhole camera model with radial-tangential distortion.

Port of ar_orbslam2_tpu/core/camera.py. A camera is a small NamedTuple of
scalars (field names mirror the reference YAML keys). All point ops are
batch-friendly torch functions: points are (..., 3) / pixels (..., 2).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Camera(NamedTuple):
    """Intrinsics + distortion. Field names mirror the reference YAML keys
    (Camera.fx .. Camera.k3, Camera.bf) so config files carry over."""
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    bf: float = 0.0        # stereo baseline * fx (0 for monocular)
    width: int = 640
    height: int = 480

    @property
    def K(self) -> np.ndarray:
        """3x3 float32 intrinsics (host array; callers move it to their
        device with torch.as_tensor)."""
        return np.array([[self.fx, 0.0, self.cx],
                         [0.0, self.fy, self.cy],
                         [0.0, 0.0, 1.0]], np.float32)

    @property
    def has_distortion(self) -> bool:
        return any(abs(float(v)) > 0 for v in
                   (self.k1, self.k2, self.p1, self.p2, self.k3))


def project(cam: Camera, xc):
    """Camera-frame points (..., 3) -> pixel coords (..., 2). No distortion
    (matching the reference, which projects into the undistorted image)."""
    z = xc[..., 2]
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = cam.fx * xc[..., 0] / zs + cam.cx
    v = cam.fy * xc[..., 1] / zs + cam.cy
    return torch.stack([u, v], -1)


def normalize_pixels(cam: Camera, uv):
    """Pixels -> normalized image coordinates (z=1 plane), no distortion."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    return torch.stack([x, y], -1)


def distort_normalized(cam: Camera, xy):
    """Apply radial-tangential distortion to normalized coords (..., 2)."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return torch.stack([xd, yd], -1)


def undistort_points(cam: Camera, uv, iters: int = 8):
    """Undistort raw pixel keypoints (fixed-point iteration, vectorized).

    Parity: reference Frame::UndistortKeyPoints (cv::undistortPoints'
    compensation loop), branch-free.
    """
    xy_d = normalize_pixels(cam, uv)
    xy = xy_d
    for _ in range(iters):
        d = distort_normalized(cam, xy) - xy
        xy = xy_d - d
    u = cam.fx * xy[..., 0] + cam.cx
    v = cam.fy * xy[..., 1] + cam.cy
    return torch.stack([u, v], -1)


def undistorted_bounds(cam: Camera):
    """Undistorted image-corner bounds (min_x, max_x, min_y, max_y).
    Parity: Frame::ComputeImageBounds (src/Frame.cc)."""
    if not cam.has_distortion:
        return 0.0, float(cam.width), 0.0, float(cam.height)
    corners = torch.tensor([[0.0, 0.0], [cam.width, 0.0],
                            [0.0, cam.height], [cam.width, cam.height]],
                           dtype=torch.float32)
    und = undistort_points(cam, corners)
    return (float(und[:, 0].min()), float(und[:, 0].max()),
            float(und[:, 1].min()), float(und[:, 1].max()))
