"""Plain ORB extraction: the benchmark's reference for the frontend.

Written from the definition the port documents for its extractor (the
reference ORB-SLAM2 ORBextractor with a fixed-shape keypoint selection),
in plain torch on the CPU, in the precision it is given. It imports
nothing of the program. Per pyramid level:

  * the level is the previous level downsampled by ``scale_factor`` with an
    antialiased bilinear (triangle) filter, to round(h / s^l) x
    round(w / s^l) pixels;
  * FAST-9/16 score: the largest t for which 9 contiguous pixels of the
    radius-3 Bresenham ring are all brighter, or all darker, than the
    centre by t; a corner scores > ``min_th``, 3 px from the border;
  * per 32 x 32 cell: corners >= ``ini_th`` are kept, or, in a cell whose
    best corner is below ``ini_th``, every corner > ``min_th``;
  * 3 x 3 non-maximum suppression (ties survive), then a 19 px border;
  * selection: the 4 best of each cell (ties by position in the cell,
    row-major), then the level's quota in order of cell rank, response
    (higher first), cell index;
  * orientation: intensity centroid over the radius-15 disc, in degrees;
  * descriptor: the 256 ORB pairs, rotated by the orientation and rounded
    half to even, compared (a < b) on the level blurred by a 7 x 7
    Gaussian of sigma 2 (reflect-101 border).

The per-level quota splits ``n_features`` geometrically over the levels,
the last level taking the remainder.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

EDGE = 19
FAST_BORDER = 3
HALF_PATCH = 15
CELL = 32
PER_CELL = 4
RING = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2),
        (-3, -1))

_PATTERN = None


def brief_pattern() -> np.ndarray:
    """(256, 4) int: x_a, y_a, x_b, y_b."""
    global _PATTERN
    if _PATTERN is None:
        path = os.path.join(os.path.dirname(__file__), "brief_pattern.txt")
        _PATTERN = np.loadtxt(path, dtype=np.int64, comments="#")
        if _PATTERN.shape != (256, 4):
            raise ValueError(f"{path}: {_PATTERN.shape} pairs, not (256, 4)")
    return _PATTERN


def level_quotas(n_features, scale_factor, n_levels):
    inv = 1.0 / scale_factor
    n0 = n_features * (1 - inv) / (1 - inv ** n_levels)
    out = [int(round(n0 * inv ** lvl)) for lvl in range(n_levels - 1)]
    out.append(max(n_features - sum(out), 0))
    return out


def level_shapes(h, w, scale_factor, n_levels):
    return [(int(round(h / scale_factor ** lvl)),
             int(round(w / scale_factor ** lvl))) for lvl in range(n_levels)]


def _triangle_weights(n_in, n_out):
    """(n_out, n_in) float64: antialiased linear resampling, pixel centres
    at i + 0.5, support scaled by the downsampling ratio."""
    scale = n_in / n_out
    support = scale if scale >= 1.0 else 1.0
    inv = 1.0 / scale if scale >= 1.0 else 1.0
    w = np.zeros((n_out, n_in))
    for i in range(n_out):
        centre = scale * (i + 0.5)
        lo = max(int(centre - support + 0.5), 0)
        hi = min(int(centre + support + 0.5), n_in)
        j = np.arange(lo, hi)
        taps = np.maximum(0.0, 1.0 - np.abs((j - centre + 0.5) * inv))
        w[i, lo:hi] = taps / taps.sum()
    return w


def resize(img, shape):
    """Antialiased bilinear downsample of a 2-D tensor, in its dtype."""
    wy = torch.as_tensor(_triangle_weights(img.shape[0], shape[0]),
                         dtype=img.dtype)
    wx = torch.as_tensor(_triangle_weights(img.shape[1], shape[1]),
                         dtype=img.dtype)
    return wy @ (img @ wx.T)


def fast_scores(img, min_th):
    h, w = img.shape
    pad = torch.nn.functional.pad(img, (3, 3, 3, 3))
    ring = torch.stack([pad[3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                        for dy, dx in RING])
    diff = ring - img[None]
    best = None
    for sign in (1, -1):
        d = sign * diff
        for start in range(16):
            arc = d[[(start + k) % 16 for k in range(9)]].amin(0)
            best = arc if best is None else torch.maximum(best, arc)
    yy = torch.arange(h)[:, None]
    xx = torch.arange(w)[None, :]
    inside = ((yy >= FAST_BORDER) & (yy < h - FAST_BORDER)
              & (xx >= FAST_BORDER) & (xx < w - FAST_BORDER))
    return torch.where((best > min_th) & inside, best,
                       torch.zeros((), dtype=img.dtype))


def _cells(score):
    h, w = score.shape
    hc, wc = -(-h // CELL), -(-w // CELL)
    pad = torch.nn.functional.pad(score, (0, wc * CELL - w, 0, hc * CELL - h))
    return pad.reshape(hc, CELL, wc, CELL).permute(0, 2, 1, 3).reshape(
        hc * wc, CELL * CELL), hc, wc


def candidate_map(img, ini_th, min_th):
    """The level's score map after the threshold rule, suppression and
    border: > 0 exactly at the candidate keypoints."""
    score = fast_scores(img, min_th)
    h, w = score.shape
    cells, hc, wc = _cells(score)
    cmax = cells.amax(1).reshape(hc, wc)
    cmax = cmax.repeat_interleave(CELL, 0).repeat_interleave(CELL, 1)[:h, :w]
    zero = torch.zeros((), dtype=score.dtype)
    score = torch.where((score >= ini_th) | (cmax < ini_th), score, zero)
    padded = torch.nn.functional.pad(score, (1, 1, 1, 1))
    neigh = torch.stack([padded[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)]).amax(0)
    score = torch.where(score >= neigh, score, zero)
    yy = torch.arange(h)[:, None]
    xx = torch.arange(w)[None, :]
    inside = (yy >= EDGE) & (yy < h - EDGE) & (xx >= EDGE) & (xx < w - EDGE)
    return torch.where(inside, score, zero)


def select(score, quota):
    """(ys, xs) int64 of the level's keypoints, in selection order."""
    cells, hc, wc = _cells(score)
    vals = cells.double().numpy()
    cand = []                       # (rank, -response, cell, y, x)
    for c in range(hc * wc):
        v = vals[c]
        order = np.lexsort((np.arange(v.size), -v))[:PER_CELL]
        for rank, k in enumerate(order):
            if v[k] > 0:
                cand.append((rank, -v[k], c,
                             (c // wc) * CELL + k // CELL,
                             (c % wc) * CELL + k % CELL))
    cand.sort(key=lambda r: (r[0], r[1], r[2]))
    pick = cand[:quota]
    return (np.array([p[3] for p in pick], np.int64),
            np.array([p[4] for p in pick], np.int64))


def _disc_moments(dtype):
    r = np.arange(-HALF_PATCH, HALF_PATCH + 1)
    dy, dx = np.meshgrid(r, r, indexing="ij")
    umax = np.round(np.sqrt(HALF_PATCH ** 2 - np.arange(HALF_PATCH + 1) ** 2))
    mask = np.abs(dx) <= umax[np.abs(dy)]
    return (torch.as_tensor(dx * mask, dtype=dtype),
            torch.as_tensor(dy * mask, dtype=dtype))


def orientations(img, ys, xs):
    """Intensity-centroid angle in degrees, [0, 360)."""
    mx, my = _disc_moments(img.dtype)
    ar = torch.arange(-HALF_PATCH, HALF_PATCH + 1)
    rows = torch.as_tensor(ys)[:, None, None] + ar[None, :, None]
    cols = torch.as_tensor(xs)[:, None, None] + ar[None, None, :]
    patch = img[rows, cols]
    m10 = (patch * mx).sum((1, 2))
    m01 = (patch * my).sum((1, 2))
    deg = torch.atan2(m01, m10) * (180.0 / math.pi)
    return torch.remainder(deg, 360.0)


def blur7(img):
    x = np.arange(-3, 4)
    k = np.exp(-(x ** 2) / (2 * 2.0 ** 2))
    k = torch.as_tensor(k / k.sum(), dtype=img.dtype)
    h, w = img.shape
    p = torch.nn.functional.pad(img[None, None], (0, 0, 3, 3),
                                mode="reflect")[0, 0]
    v = sum(p[i:i + h] * k[i] for i in range(7))
    p = torch.nn.functional.pad(v[None, None], (3, 3, 0, 0),
                                mode="reflect")[0, 0]
    return sum(p[:, i:i + w] * k[i] for i in range(7))


def descriptors(blur, ys, xs, angle_deg):
    """(N, 256) uint8 bits."""
    pat = torch.as_tensor(brief_pattern(), dtype=blur.dtype)
    th = angle_deg * (math.pi / 180.0)
    c, s = torch.cos(th)[:, None], torch.sin(th)[:, None]

    def offsets(x, y):
        col = torch.round(x[None] * c - y[None] * s).long()
        row = torch.round(x[None] * s + y[None] * c).long()
        return row, col

    h, w = blur.shape
    ys = torch.as_tensor(ys)[:, None]
    xs = torch.as_tensor(xs)[:, None]

    def sample(row, col):
        return blur[(ys + row).clamp(0, h - 1), (xs + col).clamp(0, w - 1)]

    ra, ca = offsets(pat[:, 0], pat[:, 1])
    rb, cb = offsets(pat[:, 2], pat[:, 3])
    return (sample(ra, ca) < sample(rb, cb)).to(torch.uint8)


@torch.no_grad()
def extract(image_u8, n_features=1000, scale_factor=1.2, n_levels=8,
            ini_th=20, min_th=7, dtype=torch.float64):
    """ORB of a (H, W) uint8 image. Returns a dict of host arrays over the
    keypoints of every level, in level order: ``uv`` (N, 2) float64 raw
    pixel position at level 0 (x s^l, y s^l), ``octave`` (N,) int,
    ``angle`` (N,) float64 degrees, ``desc`` (N, 256) uint8 bits."""
    img = torch.as_tensor(np.ascontiguousarray(image_u8)).to(dtype)
    shapes = level_shapes(*img.shape, scale_factor, n_levels)
    quotas = level_quotas(n_features, scale_factor, n_levels)
    uv, octave, angle, desc = [], [], [], []
    for lvl in range(n_levels):
        if lvl:
            img = resize(img, shapes[lvl])
        score = candidate_map(img, ini_th, min_th)
        ys, xs = select(score, quotas[lvl])
        if not len(ys):
            continue
        ang = orientations(img, ys, xs)
        desc.append(descriptors(blur7(img), ys, xs, ang).numpy())
        s = scale_factor ** lvl
        uv.append(np.stack([xs * s, ys * s], -1).astype(np.float64))
        octave.append(np.full(len(ys), lvl))
        angle.append(ang.double().numpy())
    return dict(uv=np.concatenate(uv), octave=np.concatenate(octave),
                angle=np.concatenate(angle), desc=np.concatenate(desc))
