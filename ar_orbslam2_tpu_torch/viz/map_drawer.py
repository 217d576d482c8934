"""Map visualization — MapDrawer parity, headless top-down render.

Port of ar_orbslam2_tpu/viz/map_drawer.py (the image is the JAX package's,
pixel for pixel, on the same map). Parity: MapDrawer::DrawMapPoints/
DrawKeyFrames/DrawCurrentCamera (src/MapDrawer.cc): landmarks as dots,
keyframe centres as discs, covisibility edges as lines — rasterized to a
PNG-able array instead of GL. Reads the host MapStore; keyframe slots are
reused, but ``keyframe_ids()`` stays sorted, which the edge lookup needs.
"""
from __future__ import annotations

import numpy as np


def _to_px(xy, lo, hi, size):
    s = (np.asarray(xy) - lo) / np.maximum(hi - lo, 1e-9)
    return np.clip((s * (size - 1)).astype(int), 0, size - 1)


def draw_map(store, size=640, axes=(0, 2), current_kf=None,
             draw_covis=True):
    """Top-down (x-z by default) map render -> (size, size, 3) uint8."""
    im = np.full((size, size, 3), 255, np.uint8)
    mp = store.map_point_ids()
    kf = store.keyframe_ids()
    if len(mp) == 0 and len(kf) == 0:
        return im
    a0, a1 = axes
    pts = store.mp_pos[mp][:, [a0, a1]] if len(mp) else np.zeros((0, 2))
    centers = np.stack([
        -(store.kf_R[k].T @ store.kf_t[k])[[a0, a1]] for k in kf]) \
        if len(kf) else np.zeros((0, 2))
    allxy = np.concatenate([pts, centers], 0)
    lo = np.percentile(allxy, 2, axis=0) - 0.2
    hi = np.percentile(allxy, 98, axis=0) + 0.2
    # landmarks: dark dots
    if len(pts):
        px = _to_px(pts, lo, hi, size)
        im[px[:, 1], px[:, 0]] = (40, 40, 40)
    # covisibility edges: light lines
    if draw_covis and len(kf):
        try:
            import cv2
        except ImportError:
            cv2 = None
        cpx = _to_px(centers, lo, hi, size)
        if cv2 is not None:
            for i, k in enumerate(kf):
                nbrs = store.covisible_keyframes(int(k), n_best=5)
                for nb in nbrs:
                    j = np.searchsorted(kf, nb)
                    if j < len(kf) and kf[j] == nb:
                        cv2.line(im, tuple(cpx[i]), tuple(cpx[j]),
                                 (200, 220, 200), 1)
            for i, k in enumerate(kf):
                color = (0, 0, 255) if (current_kf is not None
                                        and int(k) == current_kf) \
                    else (255, 0, 0)
                cv2.circle(im, tuple(cpx[i]), 3, color, -1)
    return im
