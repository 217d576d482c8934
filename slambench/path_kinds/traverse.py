"""Camera path ``traverse``: the centre moves along ``direction`` at the
speed that moves a surface ``distance_m`` metres away by ``px_per_frame``
pixels a frame under the camera's fx, facing ``facing`` turned by
``yaw_deg`` sin(2 pi i / ``yaw_period_frames``) about world z."""
import math

import numpy as np

from slambench.scenes import look_at


def poses(path, n, cam):
    start = np.asarray(path["start"], np.float64)
    direction = np.asarray(path["direction"], np.float64)
    direction /= np.linalg.norm(direction)
    facing = np.asarray(path["facing"], np.float64)
    facing /= np.linalg.norm(facing)
    step = path["px_per_frame"] * path["distance_m"] / cam.fx
    amp = math.radians(path["yaw_deg"])
    Rs, ts = [], []
    for i in range(n):
        eye = start + i * step * direction
        a = amp * math.sin(2 * math.pi * i / path["yaw_period_frames"])
        c, s = math.cos(a), math.sin(a)
        f = np.array([c * facing[0] - s * facing[1],
                      s * facing[0] + c * facing[1], facing[2]])
        R, t = look_at(eye, eye + f)
        Rs.append(R)
        ts.append(t)
    return np.stack(Rs), np.stack(ts)
