"""Marker-based AR anchoring (ArUco-style square markers).

Port of ar_orbslam2_tpu/ar/marker.py. The fork's north star mentions AR
*marker* pose tracking, which upstream lacks. Detection uses cv2.aruco on
the host; the pose comes from the system's own math: homography
decomposition (planar IPPE-style) on the host, refined by the motion-only
BA (estimation/pose_opt.py) on the device, not cv2.solvePnP.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device


def marker_object_points(size: float):
    """4 corners of a square marker in its own frame (z=0 plane),
    ordered like cv2.aruco corners (TL, TR, BR, BL)."""
    h = size / 2.0
    return np.array([[-h, h, 0.0], [h, h, 0.0],
                     [h, -h, 0.0], [-h, -h, 0.0]], np.float64)


def detect_markers(image_u8, dictionary="DICT_4X4_50"):
    """Detect ArUco markers; returns list of (id, corners (4,2))."""
    try:
        import cv2
        aruco = cv2.aruco
    except (ImportError, AttributeError):
        return []
    d = aruco.getPredefinedDictionary(getattr(aruco, dictionary))
    try:
        detector = aruco.ArucoDetector(d)
        corners, ids, _ = detector.detectMarkers(image_u8)
    except AttributeError:              # older OpenCV API
        corners, ids, _ = aruco.detectMarkers(image_u8, d)
    if ids is None:
        return []
    return [(int(i), c.reshape(4, 2)) for i, c in zip(ids.ravel(), corners)]


def pose_from_homography(cam, obj_xy, img_uv):
    """Planar pose from 4+ coplanar correspondences via K^-1 H
    decomposition. obj_xy (N,2) marker-plane coords; img_uv (N,2) pixels.
    Returns (R (3,3), t (3,)) world(marker) -> camera."""
    A = []
    for (x, y), (u, v) in zip(obj_xy, img_uv):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    A = np.asarray(A, np.float64)
    _, _, Vt = np.linalg.svd(A)
    H = Vt[-1].reshape(3, 3)
    K = np.asarray(cam.K, np.float64)
    B = np.linalg.inv(K) @ H
    lam = 1.0 / max(np.linalg.norm(B[:, 0]), 1e-12)
    # H is known up to sign: the marker must be in front of the camera
    if B[2, 2] * lam < 0:
        lam = -lam
    r1 = B[:, 0] * lam
    r2 = B[:, 1] * lam
    t = B[:, 2] * lam
    r3 = np.cross(r1, r2)
    Rm = np.stack([r1, r2, r3], -1)
    # orthonormalize
    U, _, Vt2 = np.linalg.svd(Rm)
    R = U @ Vt2
    if np.linalg.det(R) < 0:
        R = U @ np.diag([1.0, 1.0, -1.0]) @ Vt2
    return R.astype(np.float32), t.astype(np.float32)


def marker_pose(cam, corners_uv, size: float, refine=True, device=None):
    """Marker pose T_cm (marker -> camera) from its 4 corners; optionally
    refined with the motion-only BA (pose_optimization: one round of 10
    LM iterations, octave 0, one chi² gate) on `device`."""
    obj = marker_object_points(size)
    R, t = pose_from_homography(cam, obj[:, :2], corners_uv)
    if refine:
        from ..estimation.pose_opt import pose_optimization
        dev = resolve_device(device)

        def up(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
        res = pose_optimization(
            up(R), up(t), up(obj), up(corners_uv),
            torch.zeros(4, dtype=torch.int32, device=dev),
            torch.ones(4, dtype=torch.bool, device=dev), cam,
            n_rounds=1, n_iters=10)
        R, t = res["R"].cpu().numpy(), res["t"].cpu().numpy()
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = R, t
    return T


class MarkerAnchor:
    """Anchor virtual content to a marker seen once while SLAM is running:
    stores T_mw (marker -> world) so content persists when the marker
    leaves the view — the SLAM map carries it."""

    def __init__(self, cam, marker_size=0.1, dictionary="DICT_4X4_50",
                 device=None):
        self.cam = cam
        self.size = marker_size
        self.dictionary = dictionary
        self.device = resolve_device(device)
        self.anchors: dict[int, np.ndarray] = {}    # id -> T_mw

    def update(self, image_u8, Tcw):
        """Detect markers in this frame; (re)anchor any seen marker using
        the current SLAM pose. Returns ids updated."""
        if Tcw is None:
            return []
        seen = []
        Twc = np.eye(4, dtype=np.float64)
        Twc[:3, :3] = Tcw[:3, :3].T
        Twc[:3, 3] = -(Tcw[:3, :3].T @ Tcw[:3, 3])
        for mid, corners in detect_markers(image_u8, self.dictionary):
            T_cm = marker_pose(self.cam, corners, self.size,
                               device=self.device)
            self.anchors[mid] = (Twc @ T_cm).astype(np.float32)
            seen.append(mid)
        return seen
