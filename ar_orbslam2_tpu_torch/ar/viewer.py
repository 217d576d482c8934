"""Headless AR overlay — virtual cubes anchored to detected planes.

Port of ar_orbslam2_tpu/ar/viewer.py, a redesign of ViewerAR
(Examples/ROS/ORB_SLAM2/src/AR/ViewerAR.cc — the fork's headline app):
instead of a Pangolin GL thread, the overlay is rendered offscreen — camera
image as background, cube edges projected through the live pose and drawn
with cv2 (or a numpy line rasterizer when OpenCV is unavailable),
tracked-point dots, status text. The image is the JAX package's, pixel for
pixel. Frames can be streamed to PNG/MP4 (headless by design). The plane
fit runs on ``device``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .plane import Plane, detect_plane

_CUBE = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (0.0, 1.0)
                  for z in (-0.5, 0.5)], np.float64)
_EDGES = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6),
          (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)]


@dataclass
class Cube:
    T_ow: np.ndarray            # object -> world
    size: float = 0.05


@dataclass
class ViewerAR:
    """State + rendering for the AR overlay (SetImagePose/Run parity —
    the menu actions become methods: add_cube, clear)."""
    cam: object = None
    cubes: list = field(default_factory=list)
    plane: Plane | None = None
    status: str = "SLAM NOT INITIALIZED"
    device: object = None

    # ------------------------------------------------------------------
    def add_cube(self, tracked_points, tracked_valid, Tcw=None,
                 size=0.05, seed=0):
        """Parity: menu 'Add Cube' -> DetectPlane + anchor a cube."""
        cam_center = None
        if Tcw is not None:
            R, t = Tcw[:3, :3], Tcw[:3, 3]
            cam_center = -(R.T @ t)
        plane = detect_plane(tracked_points, tracked_valid,
                             cam_center=cam_center, seed=seed,
                             device=self.device)
        if plane is None:
            return None
        self.plane = plane
        T = plane.T_pw.copy()
        cube = Cube(T_ow=T, size=size)
        self.cubes.append(cube)
        return cube

    def clear(self):
        """Parity: menu 'Clear All'."""
        self.cubes.clear()
        self.plane = None

    # ------------------------------------------------------------------
    def _project(self, Tcw, xw):
        R, t = Tcw[:3, :3], Tcw[:3, 3]
        xc = xw @ R.T + t
        z = np.maximum(xc[:, 2], 1e-6)
        u = self.cam.fx * xc[:, 0] / z + self.cam.cx
        v = self.cam.fy * xc[:, 1] / z + self.cam.cy
        return np.stack([u, v], -1), xc[:, 2]

    def render(self, image_u8, Tcw, tracked_uv=None, state="OK",
               n_tracked=0):
        """Compose one AR frame. Parity: ViewerAR::Run body (background
        image + DrawCube(s) + DrawTrackedPoints + AddTextToImage)."""
        try:
            import cv2
        except ImportError:
            cv2 = None
        im = np.asarray(image_u8)
        if im.ndim == 2:
            im = np.repeat(im[:, :, None], 3, axis=2)
        im = im.copy()
        self.status = ("SLAM ON" if state == "OK" and Tcw is not None
                       else "SLAM LOST" if state == "LOST"
                       else "SLAM NOT INITIALIZED")
        if tracked_uv is not None and cv2 is not None:
            for u, v in np.asarray(tracked_uv):
                cv2.circle(im, (int(u), int(v)), 1, (0, 255, 0), -1)
        if Tcw is not None:
            for cube in self.cubes:
                verts = _CUBE * cube.size
                xw = verts @ cube.T_ow[:3, :3].T + cube.T_ow[:3, 3]
                uv, z = self._project(Tcw, xw)
                if (z <= 0).any():
                    continue
                for a, b in _EDGES:
                    pa = (int(uv[a, 0]), int(uv[a, 1]))
                    pb = (int(uv[b, 0]), int(uv[b, 1]))
                    if cv2 is not None:
                        cv2.line(im, pa, pb, (0, 64, 255), 2)
                    else:
                        _draw_line(im, pa, pb, (0, 64, 255))
        txt = f"{self.status} | cubes: {len(self.cubes)} | pts: {n_tracked}"
        if cv2 is not None:
            bar = np.zeros((22, im.shape[1], 3), im.dtype)
            cv2.putText(bar, txt, (6, 15), cv2.FONT_HERSHEY_PLAIN, 1.0,
                        (255, 255, 255), 1)
            im = np.concatenate([im, bar], 0)
        return im


def _draw_line(im, pa, pb, color):
    """Minimal line rasterizer for when OpenCV is unavailable."""
    h, w = im.shape[:2]
    x0, y0 = pa
    x1, y1 = pb
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1))
    xs = np.linspace(x0, x1, n + 1).astype(int)
    ys = np.linspace(y0, y1, n + 1).astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    im[ys[ok], xs[ok]] = color
