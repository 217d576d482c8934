"""Scene ``box``: an axis-aligned room ``lo``..``hi`` (metres, world z
up); each of its six faces carries its own texture."""
import math

import numpy as np
import torch

from slambench.scenes import make_textures, seed64


class Scene:
    """Faces 0-5: x = lo, x = hi, y = lo, y = hi, z = lo, z = hi."""

    def __init__(self, spec, seed, centres, device):
        self.lo = np.asarray(spec["lo"], np.float64)
        self.hi = np.asarray(spec["hi"], np.float64)
        self.texel = float(spec["texel_m"])
        ext = self.hi - self.lo
        self.th = int(math.ceil(max(ext) / self.texel))
        self.tw = self.th
        self.n_faces = 6
        self.textures = make_textures(
            [seed64(seed, 1, f) for f in range(6)], self.th, self.tw, device)

    def distance(self, p):
        """(N, 3) points -> distance to the nearest face's plane."""
        p = np.asarray(p, np.float64)
        return np.min(np.abs(np.concatenate([p - self.lo, self.hi - p],
                                            -1)), -1)

    def hit(self, eye, d):
        """eye (B, 3), d (B, H, W, 3) world rays -> (face, a, b) texel
        coordinates on that face."""
        lo = torch.as_tensor(self.lo, dtype=d.dtype, device=d.device)
        hi = torch.as_tensor(self.hi, dtype=d.dtype, device=d.device)
        e = eye[:, None, None, :]
        bound = torch.where(d > 0, hi, lo)
        t = (bound - e) / d
        t = torch.where(torch.isfinite(t) & (t > 0), t,
                        torch.full_like(t, math.inf))
        axis = torch.argmin(t, -1)
        tmin = torch.gather(t, -1, axis[..., None])[..., 0]
        p = e + d * tmin[..., None]
        pos = torch.gather(d, -1, axis[..., None])[..., 0] > 0
        face = 2 * axis + pos.long()
        # in-plane coordinates: the two axes other than the face's own
        ia = torch.where(axis == 0, 1, 0)
        ib = torch.where(axis == 2, 1, 2)
        a = (torch.gather(p, -1, ia[..., None])[..., 0]
             - torch.gather(lo.expand_as(p), -1, ia[..., None])[..., 0])
        b = (torch.gather(p, -1, ib[..., None])[..., 0]
             - torch.gather(lo.expand_as(p), -1, ib[..., None])[..., 0])
        return face, a / self.texel, b / self.texel
