"""ORB feature extraction as dense tensor programs, one pass per level.

Port of ar_orbslam2_tpu/frontend/orb.py (the reference's ORBextractor,
src/ORBextractor.cc): FAST-9/16 corner scores as shifted whole-image
comparisons, the per-cell threshold fallback as a cell-max mask, per-cell
top-k ranking in place of the quadtree, intensity-centroid orientation and
rotated 256-pair BRIEF as batched gathers. Every stage is fixed-shape and
runs on the image's device.

Parity traps with the JAX package, and what this port does about them:
  * ``jax.image.resize(..., "linear")`` antialiases when it downsamples;
    ``F.interpolate(mode="bilinear", antialias=True)`` uses the same
    triangle filter, so levels agree to float rounding (measured in
    tests/test_torch_orb.py), not bit for bit;
  * ``lax.top_k`` returns the lowest index first among equal values, and
    FAST scores are integers at level 0, so ties are common: selection uses
    a stable descending sort, which keeps that order;
  * ``jnp.take(mode="clip")`` becomes clamped indices;
  * Python-style float ``%`` is written out as fmod + sign fix, the way
    ``jnp.remainder`` computes it.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .brief_pattern import BIT_PATTERN_31

EDGE = 19                 # EDGE_THRESHOLD border (reference ORBextractor)
HALF_PATCH = 15           # IC_Angle circular patch radius
PATCH = 31

# 16-pixel Bresenham circle (radius 3), clockwise from (0,-3) in (dy,dx) —
# same ring as cv::FAST_9_16 / the reference's cv::FAST call.
RING = np.array([
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
], np.int32)


class OrbConfig(NamedTuple):
    """Mirrors the reference YAML keys (ORBextractor.*, src/Tracking.cc)."""
    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    cell: int = 32            # spatial-uniformity grid (quadtree analog)
    per_cell_k: int = 4


def features_per_level(cfg: OrbConfig):
    """Geometric split of the feature budget, parity with the reference's
    mnFeaturesPerLevel computation (ORBextractor ctor)."""
    inv = 1.0 / cfg.scale_factor
    n0 = cfg.n_features * (1 - inv) / (1 - inv ** cfg.n_levels)
    out = []
    acc = 0
    for lvl in range(cfg.n_levels - 1):
        n = int(round(n0 * inv ** lvl))
        out.append(n)
        acc += n
    out.append(max(cfg.n_features - acc, 0))
    return out


def level_shapes(h, w, cfg: OrbConfig):
    shapes = []
    for lvl in range(cfg.n_levels):
        s = 1.0 / (cfg.scale_factor ** lvl)
        shapes.append((int(round(h * s)), int(round(w * s))))
    return shapes


def _fmod_positive(x, y):
    """x % y with Python semantics, computed as jnp.remainder does."""
    m = torch.fmod(x, y)
    return torch.where((m != 0) & ((m < 0) != (y < 0)), m + y, m)


def _grid(h, w, device):
    yy = torch.arange(h, device=device)[:, None].expand(h, w)
    xx = torch.arange(w, device=device)[None, :].expand(h, w)
    return yy, xx


# ---------------------------------------------------------------------------
# FAST
# ---------------------------------------------------------------------------
def fast_score_map(img_f, threshold):
    """FAST-9/16 corner score map (0 where not a corner at `threshold`).

    Score is the exact "maximum threshold for which this stays a corner":
    max over the 16 contiguous 9-arcs of (min over the arc of |ring -
    center|), evaluated separately for the brighter/darker polarity.
    """
    # the ring pixel at offset (dy, dx) of every pixel: slices of the image
    # padded by the ring's radius (the 3-pixel border the padding reaches
    # is masked out below)
    h, w = img_f.shape
    pad = F.pad(img_f[None, None], (3, 3, 3, 3))[0, 0]
    ring = torch.stack([pad[3 + int(dy):3 + int(dy) + h,
                            3 + int(dx):3 + int(dx) + w] for dy, dx in RING])
    d_bright = ring - img_f[None]          # >0 where ring brighter
    d_dark = -d_bright

    def arc_score(d):
        # min over every contiguous 9-window on the circular ring axis: the
        # ring extended by its first 8 entries, windows doubled 2, 4, 8, 9
        e = torch.cat([d, d[:8]])
        m2 = torch.minimum(e[:-1], e[1:])
        m4 = torch.minimum(m2[:-2], m2[2:])
        m8 = torch.minimum(m4[:-4], m4[4:])
        m9 = torch.minimum(m8[:16], e[8:24])
        return m9.max(0).values            # best arc per pixel

    score = torch.maximum(arc_score(d_bright), arc_score(d_dark))
    corner = score > threshold
    yy, xx = _grid(h, w, img_f.device)
    interior = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    return torch.where(corner & interior, score, torch.zeros_like(score))


def _maxpool3(x):
    m = x
    for ax in (0, 1):
        m = torch.maximum(m, torch.maximum(torch.roll(m, 1, ax),
                                           torch.roll(m, -1, ax)))
    return m


def _cell_reduce_max(score, cell):
    h, w = score.shape
    hc, wc = -(-h // cell), -(-w // cell)
    pad = F.pad(score, (0, wc * cell - w, 0, hc * cell - h))
    cmax = pad.reshape(hc, cell, wc, cell).amax((1, 3))
    return cmax.repeat_interleave(cell, 0).repeat_interleave(cell, 1)[:h, :w]


# ---------------------------------------------------------------------------
# keypoint selection (quadtree replacement)
# ---------------------------------------------------------------------------
def _top_k_stable(x, k):
    """lax.top_k along the last axis: descending, lowest index first among
    equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_keypoints(score, quota, cell, k):
    """Per-cell top-k ranking, then global pick of `quota` keypoints.

    Every non-empty cell contributes its rank-0 corner before any cell
    contributes rank-1, etc — the spatial-uniformity contract of the
    reference's DistributeOctTree, with fixed shapes.

    Returns (ys, xs, responses, valid) each (quota,).
    """
    h, w = score.shape
    hc, wc = -(-h // cell), -(-w // cell)
    pad = F.pad(score, (0, wc * cell - w, 0, hc * cell - h))
    cells = pad.reshape(hc, cell, wc, cell).permute(0, 2, 1, 3)
    cells = cells.reshape(hc * wc, cell * cell)
    top_v, top_i = _top_k_stable(cells, k)          # (C, k)
    ok = top_v > 0
    rank = torch.arange(k, dtype=torch.float32,
                        device=score.device)[None, :].expand(top_v.shape)
    # smaller key = better: cell-rank first, then response
    key = torch.where(ok, rank * 1e6 - top_v,
                      torch.full_like(top_v, math.inf)).reshape(-1)
    sel_key, sel = _top_k_stable(-key, quota)
    sel_valid = torch.isfinite(-sel_key)
    c_idx = sel // k
    in_cell = top_i.reshape(-1)[sel]
    cy, cx = c_idx // wc, c_idx % wc
    ys = cy * cell + in_cell // cell
    xs = cx * cell + in_cell % cell
    resp = top_v.reshape(-1)[sel]
    return ys, xs, resp, sel_valid


# ---------------------------------------------------------------------------
# orientation + descriptor
# ---------------------------------------------------------------------------
def _gather_patches(img_f, ys, xs, half):
    """(N,) centers -> (N, 2*half+1, 2*half+1) patches. Start indices are
    clamped so the window stays inside the image (dynamic_slice's rule)."""
    size = 2 * half + 1
    h, w = img_f.shape
    ar = torch.arange(size, device=img_f.device)
    y0 = torch.clamp(ys - half, 0, h - size)
    x0 = torch.clamp(xs - half, 0, w - size)
    rows = (y0[:, None] + ar)[:, :, None]
    cols = (x0[:, None] + ar)[:, None, :]
    return img_f[rows, cols]


_IC_TABLES = None
_DEVICE_CONSTANTS: dict = {}


def _constant(name, device, make):
    """A constant table on `device`, uploaded once per (name, device): a
    host-to-device copy per call would synchronise the stream, and cannot
    be recorded into a CUDA graph."""
    key = (name, str(device))
    hit = _DEVICE_CONSTANTS.get(key)
    if hit is None:
        hit = torch.as_tensor(make(), device=device)
        _DEVICE_CONSTANTS[key] = hit
    return hit


def _ic_tables():
    global _IC_TABLES
    if _IC_TABLES is None:
        r = np.arange(-HALF_PATCH, HALF_PATCH + 1)
        dy, dx = np.meshgrid(r, r, indexing="ij")
        # same circular footprint as the reference's u_max table
        v = np.arange(HALF_PATCH + 1)
        umax = np.round(np.sqrt(HALF_PATCH ** 2 - v ** 2)).astype(int)
        mask = np.abs(dx) <= umax[np.abs(dy)]
        _IC_TABLES = (np.asarray(mask, np.float32),
                      np.asarray(dx * mask, np.float32),
                      np.asarray(dy * mask, np.float32))
    return _IC_TABLES


def ic_angles(img_f, ys, xs):
    """Intensity-centroid orientation (degrees). Parity: IC_Angle
    (src/ORBextractor.cc)."""
    dxs = _constant("ic_dx", img_f.device, lambda: _ic_tables()[1])
    dys = _constant("ic_dy", img_f.device, lambda: _ic_tables()[2])
    patches = _gather_patches(img_f, ys, xs, HALF_PATCH)
    m10 = (patches * dxs).sum((1, 2))
    m01 = (patches * dys).sum((1, 2))
    return _fmod_positive(torch.atan2(m01, m10) * (180.0 / math.pi), 360.0)


def gaussian_blur7(img_f):
    """7x7 sigma=2 separable blur, reflect border — parity with the
    GaussianBlur call before descriptor computation."""
    def taps():
        x = np.arange(-3, 4)
        k = np.exp(-(x ** 2) / (2 * 2.0 ** 2))
        return (k / k.sum()).astype(np.float32)

    k = _constant("blur7", img_f.device, taps)
    h, w = img_f.shape
    p = F.pad(img_f[None, None], (0, 0, 3, 3), mode="reflect")[0, 0]
    v = sum(p[i:i + h] * k[i] for i in range(7))
    p = F.pad(v[None, None], (3, 3, 0, 0), mode="reflect")[0, 0]
    return sum(p[:, i:i + w] * k[i] for i in range(7))


BRIEF_HALF = 18   # max |rotated offset| = ceil(13 * sqrt(2)) — patch bound


def brief_descriptors(blur_f, ys, xs, angles_deg):
    """Rotated 256-pair BRIEF bits. Parity: computeOrbDescriptor
    (src/ORBextractor.cc): sample offsets (x,y) rotate to
    (x cosθ - y sinθ, x sinθ + y cosθ), rounded, compared a < b. Samples
    gather directly from the flattened blurred image."""
    pat = _constant("brief", blur_f.device,          # (256,4) xa ya xb yb
                    lambda: np.asarray(BIT_PATTERN_31, np.float32))
    th = angles_deg * (math.pi / 180.0)
    ca, sa = torch.cos(th), torch.sin(th)           # (N,)
    xa, ya, xb, yb = pat[:, 0], pat[:, 1], pat[:, 2], pat[:, 3]

    def rot(x, y):
        col = torch.round(x[None, :] * ca[:, None] - y[None, :] * sa[:, None])
        row = torch.round(x[None, :] * sa[:, None] + y[None, :] * ca[:, None])
        return row.to(torch.int64), col.to(torch.int64)

    ra, ca_ = rot(xa, ya)                           # (N, 256)
    rb, cb_ = rot(xb, yb)
    h, w = blur_f.shape
    flat = blur_f.reshape(-1)

    def sample(rows, cols):
        r = torch.clamp(ys[:, None] + rows, 0, h - 1)
        c = torch.clamp(xs[:, None] + cols, 0, w - 1)
        return flat[r * w + c]

    return (sample(ra, ca_) < sample(rb, cb_)).to(torch.uint8)   # (N,256)


# ---------------------------------------------------------------------------
# full extraction
# ---------------------------------------------------------------------------
def _level_features(img_f, quota, cfg: OrbConfig):
    score = fast_score_map(img_f, float(cfg.min_th_fast))
    # per-cell threshold fallback: keep >=iniTh corners; in cells where the
    # best corner is below iniTh, keep the minTh ones (reference semantics)
    cmax = _cell_reduce_max(score, cfg.cell)
    keep = (score >= cfg.ini_th_fast) | (cmax < cfg.ini_th_fast)
    zero = torch.zeros_like(score)
    score = torch.where(keep, score, zero)
    # 3x3 non-max suppression
    score = torch.where(score >= _maxpool3(score), score, zero)
    # EDGE border (orientation patch + rotated BRIEF must fit)
    h, w = img_f.shape
    yy, xx = _grid(h, w, img_f.device)
    inside = (yy >= EDGE) & (yy < h - EDGE) & (xx >= EDGE) & (xx < w - EDGE)
    score = torch.where(inside, score, zero)

    ys, xs, resp, valid = select_keypoints(score, quota, cfg.cell,
                                           cfg.per_cell_k)
    ys = torch.where(valid, ys, EDGE)   # clamp padding rows to safe coords
    xs = torch.where(valid, xs, EDGE)
    ang = ic_angles(img_f, ys, xs)
    blur = gaussian_blur7(img_f)
    desc = brief_descriptors(blur, ys, xs, ang)
    return ys, xs, resp, ang, desc, valid


def resize_level(img_f, shape):
    """Antialiased bilinear downsample (jax.image.resize "linear")."""
    return F.interpolate(img_f[None, None], size=shape, mode="bilinear",
                         align_corners=False, antialias=True)[0, 0]


@torch.no_grad()
def extract_orb(image_u8, cfg: OrbConfig = OrbConfig()):
    """Extract ORB features from a grayscale uint8 image tensor (H, W).

    Returns dict of fixed-shape tensors on the image's device
    (N = cfg.n_features): uv (N,2) float32 — level-0 pixel coords;
    octave (N,) int32; angle (N,) float32 degrees; response (N,);
    desc_bits (N,256) uint8; valid (N,) bool.
    """
    h, w = image_u8.shape
    img_l = image_u8.to(torch.float32)
    shapes = level_shapes(h, w, cfg)
    quotas = features_per_level(cfg)

    uys, uxs, resps, angs, descs, valids, octs = [], [], [], [], [], [], []
    for lvl in range(cfg.n_levels):
        if lvl > 0:
            img_l = resize_level(img_l, shapes[lvl])
        ys, xs, resp, ang, desc, valid = _level_features(
            img_l, quotas[lvl], cfg)
        s = cfg.scale_factor ** lvl
        uys.append(ys.to(torch.float32) * s)
        uxs.append(xs.to(torch.float32) * s)
        resps.append(resp)
        angs.append(ang)
        descs.append(desc)
        valids.append(valid)
        octs.append(torch.full((quotas[lvl],), lvl, dtype=torch.int32,
                               device=image_u8.device))

    uv = torch.stack([torch.cat(uxs), torch.cat(uys)], -1)
    return dict(uv=uv, octave=torch.cat(octs), angle=torch.cat(angs),
                response=torch.cat(resps), desc_bits=torch.cat(descs),
                valid=torch.cat(valids))
