"""Camera path ``lissajous``: the centre at ``center`` + amplitude_k
sin(2 pi i / period_k) along the lateral, vertical and depth axes of the
view, always looking at ``look_at``."""
import math

import numpy as np

from slambench.scenes import look_at


def poses(path, n, cam):
    c0 = np.asarray(path["center"], np.float64)
    target = np.asarray(path["look_at"], np.float64)
    depth = (target - c0) / np.linalg.norm(target - c0)
    lateral = np.cross([0.0, 0.0, 1.0], depth)
    lateral /= np.linalg.norm(lateral)
    vertical = np.cross(depth, lateral)
    amp = path["amplitude_m"]
    per = path["period_frames"]
    Rs, ts = [], []
    for i in range(n):
        eye = c0.copy()
        for axis, vec in (("lateral", lateral), ("vertical", vertical),
                          ("depth", depth)):
            eye += amp[axis] * math.sin(2 * math.pi * i / per[axis]) * vec
        R, t = look_at(eye, target)
        Rs.append(R)
        ts.append(t)
    return np.stack(Rs), np.stack(ts)
