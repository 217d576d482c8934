"""Scene ``corridor``: walls at y = +-width/2, floor z = 0, ceiling
z = height, unbounded along x; every ``segment_m`` of each surface carries
its own texture, drawn from (seed, surface, segment)."""
import math

import numpy as np
import torch

from slambench.scenes import make_textures, seed64


class Scene:
    """Surfaces 0-3: wall y = -w/2, wall y = +w/2, floor, ceiling; along x
    the segment k = floor(x / segment_m) of a surface has its own texture."""

    def __init__(self, spec, seed, centres, device):
        self.half = 0.5 * float(spec["width_m"])
        self.height = float(spec["height_m"])
        self.seg = float(spec["segment_m"])
        self.texel = float(spec["texel_m"])
        reach = float(spec["view_reach_m"])
        xs = np.asarray(centres)[:, 0]
        self.k0 = int(math.floor((xs.min() - reach) / self.seg))
        k1 = int(math.floor((xs.max() + reach) / self.seg))
        self.n_seg = k1 - self.k0 + 1
        self.tw = int(math.ceil(self.seg / self.texel))
        self.th = int(math.ceil(max(self.height, 2 * self.half) / self.texel))
        self.n_faces = 4 * self.n_seg
        seeds = [seed64(seed, 2, s, k - self.k0 + (1 << 20))
                 for s in range(4) for k in range(self.k0, k1 + 1)]
        self.textures = make_textures(seeds, self.th, self.tw, device)

    def distance(self, p):
        p = np.asarray(p, np.float64)
        return np.min(np.stack([np.abs(p[:, 1] + self.half),
                                np.abs(p[:, 1] - self.half),
                                np.abs(p[:, 2]),
                                np.abs(p[:, 2] - self.height)], -1), -1)

    def hit(self, eye, d):
        e = eye[:, None, None, :]
        ty = torch.where(d[..., 1] > 0, (self.half - e[..., 1]) / d[..., 1],
                         (-self.half - e[..., 1]) / d[..., 1])
        tz = torch.where(d[..., 2] > 0, (self.height - e[..., 2]) / d[..., 2],
                         (0.0 - e[..., 2]) / d[..., 2])
        inf = torch.full_like(ty, math.inf)
        ty = torch.where(torch.isfinite(ty) & (ty > 0), ty, inf)
        tz = torch.where(torch.isfinite(tz) & (tz > 0), tz, inf)
        wall = ty <= tz
        tmin = torch.minimum(ty, tz)
        p = e + d * tmin[..., None]
        surf = torch.where(wall, (d[..., 1] > 0).long(),
                           2 + (d[..., 2] > 0).long())
        seg = torch.floor(p[..., 0] / self.seg)
        k = (seg.long() - self.k0).clamp(0, self.n_seg - 1)
        a = (p[..., 0] - seg * self.seg) / self.texel
        b = torch.where(wall, p[..., 2], p[..., 1] + self.half) / self.texel
        return surf * self.n_seg + k, a, b
