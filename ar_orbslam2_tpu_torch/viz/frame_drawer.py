"""Per-frame debug overlay — FrameDrawer parity, headless.

Port of ar_orbslam2_tpu/viz/frame_drawer.py (the image is the JAX
package's, pixel for pixel). Parity: FrameDrawer::DrawFrame
(src/FrameDrawer.cc:≈40): current image + keypoint overlays (green =
tracked landmark, blue = new) + a status bar (state, #KFs, #MPs,
#matches). Returns an image instead of feeding a Pangolin panel. The
frame's arrays (uv, valid, mp) are host numpy arrays.
"""
from __future__ import annotations

import numpy as np


def draw_frame(image_u8, frame, state="OK", n_kf=0, n_mp=0):
    try:
        import cv2
    except ImportError:
        cv2 = None
    im = np.asarray(image_u8)
    if im.ndim == 2:
        im = np.repeat(im[:, :, None], 3, axis=2)
    im = im.copy()
    tracked = frame.mp >= 0
    if cv2 is not None:
        for (u, v), is_tracked in zip(frame.uv[frame.valid],
                                      tracked[frame.valid]):
            color = (0, 255, 0) if is_tracked else (255, 128, 0)
            cv2.rectangle(im, (int(u) - 2, int(v) - 2),
                          (int(u) + 2, int(v) + 2), color, 1)
        n_match = int(tracked.sum())
        txt = (f"{state} | KFs: {n_kf}, MPs: {n_mp}, "
               f"Matches: {n_match}")
        bar = np.zeros((22, im.shape[1], 3), im.dtype)
        cv2.putText(bar, txt, (6, 15), cv2.FONT_HERSHEY_PLAIN, 1.0,
                    (255, 255, 255), 1)
        im = np.concatenate([im, bar], 0)
    return im
