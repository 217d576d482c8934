"""The benchmark's one traffic generator: rendered camera sequences with
ground truth, made on the card from the run's seed.

A traffic mix is a data file (``traffic/<name>.json``) that names a scene
and a camera path with their parameters; this module reads it and renders
the frames. It is a frozen, rewritten copy of the image scenes of the
port's ``data/synthetic.py`` (textures of multiscale noise and painted
shapes, surfaces found by per-pixel ray casting), in torch on the device,
and never imports that module. The program receives only the frames.

Each kind is a file of its own, found by the name the traffic gives it:
a camera path ``path.kind`` is ``path_kinds/<kind>.py`` (``poses(path, n,
cam)``: one world-to-camera pose per frame index), a scene
``scene.kind`` is ``scene_kinds/<kind>.py`` (a ``Scene`` with its
textures, ``distance`` to its surfaces and ``hit``, the surface a ray
meets first). A new motion or scene is a new file there.

Images are what the configured camera sees: one pixel-to-ray map per
camera undoes its published radial-tangential distortion, so the frames
carry that distortion. Each frame gets fresh sensor noise. Poses are
world-to-camera (x_c = R x_w + t), float64, kept beside the frames.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .catalog import HERE, load

NOISE_STD = 1.5          # grey levels of sensor noise per pixel
BLUR_3X3_SIGMA = 0.6     # optics: the 3x3 Gaussian the renderer applies
TEXTURE_SCALES = (8, 32, 128)   # multiscale noise, in texels
SHAPES_PER_MTEXEL = 400  # painted discs and squares per 1024^2 texels
BATCH = 32               # frames rendered per device call


def seed64(*parts) -> int:
    """A 63-bit generator seed from non-negative integers."""
    ss = np.random.SeedSequence([int(p) for p in parts])
    a, b = ss.generate_state(2, dtype=np.uint32)
    return (int(a) << 31) ^ int(b)


# ---------------------------------------------------------------------------
# textures
# ---------------------------------------------------------------------------
def make_textures(seeds, h, w, device):
    """One grey texture (h, w) float32 in [0, 255] per seed, on `device`:
    multiscale noise, then discs and squares painted in order."""
    out = torch.empty((len(seeds), h, w), dtype=torch.float32, device=device)
    n_shapes = max(1, round(SHAPES_PER_MTEXEL * h * w / 1024 ** 2))
    params = []
    for b, seed in enumerate(seeds):
        g = torch.Generator(device=device)
        g.manual_seed(int(seed))
        tex = torch.zeros((1, 1, h, w), dtype=torch.float32, device=device)
        for s in TEXTURE_SCALES:
            coarse = torch.rand((1, 1, max(h // s, 2), max(w // s, 2)),
                                generator=g, device=device)
            tex += F.interpolate(coarse, size=(h, w), mode="bicubic",
                                 align_corners=False)
        tex = tex[0, 0]
        tex = (tex - tex.min()) / (tex.max() - tex.min() + 1e-9)
        out[b] = torch.floor(tex * 155 + 50)
        params.append(torch.rand((n_shapes, 5), generator=g, device=device))
    # shapes: (cx, cy, radius, grey, kind) per texture, painted in rounds
    p = torch.stack(params)                       # (B, S, 5)
    margin = min(30, h // 4, w // 4)
    cx = torch.floor(margin + p[..., 0] * (w - 2 * margin))
    cy = torch.floor(margin + p[..., 1] * (h - 2 * margin))
    rad = torch.floor(4 + p[..., 2] * 24)
    grey = torch.floor(p[..., 3] * 255)
    disc = p[..., 4] < 0.5
    yy = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    for k in range(n_shapes):
        dx = xx - cx[:, k, None, None]
        dy = yy - cy[:, k, None, None]
        r = rad[:, k, None, None]
        inside = torch.where(disc[:, k, None, None],
                             dx * dx + dy * dy <= r * r,
                             (dx.abs() <= r) & (dy.abs() <= r))
        out = torch.where(inside, grey[:, k, None, None], out)
    return out


# ---------------------------------------------------------------------------
# camera
# ---------------------------------------------------------------------------
def pixel_rays(cam, iters=50):
    """(H, W, 3) float64 host array: the camera-frame ray (x, y, 1) through
    each raw (distorted) pixel centre, the published distortion undone by
    fixed-point iteration to convergence."""
    u, v = np.meshgrid(np.arange(cam.width, dtype=np.float64),
                       np.arange(cam.height, dtype=np.float64))
    xd = (u - cam.cx) / cam.fx
    yd = (v - cam.cy) / cam.fy
    x, y = undistort_normalized(cam, xd, yd, iters)
    return np.stack([x, y, np.ones_like(x)], -1)


def distort_normalized(cam, x, y):
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return xd, yd


def undistort_normalized(cam, xd, yd, iters=50):
    x, y = xd, yd
    for _ in range(iters):
        ex, ey = distort_normalized(cam, x, y)
        x, y = x - (ex - xd), y - (ey - yd)
    return x, y


def look_at(eye, target, up=(0.0, 0.0, -1.0)):
    """World-to-camera (R, t), float64: camera z towards the target, image
    y down (world z is up, so `up` is world -z)."""
    eye = np.asarray(eye, np.float64)
    z = np.asarray(target, np.float64) - eye
    z /= np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z])
    return R, -R @ eye


def motion(R_cw, t_cw, fps):
    """What a path asks of the tracker, in the terms that datasets publish:
    mean speed (m/s), mean angular rate (deg/s) and the extent of the
    camera centre along world x, y and z (m), at `fps` frames a second."""
    c = -np.einsum("nji,nj->ni", R_cw, t_cw)
    speed = np.linalg.norm(np.diff(c, axis=0), axis=1) * fps
    dR = np.einsum("nij,nkj->nik", R_cw[1:], R_cw[:-1])
    cos = (np.trace(dR, axis1=1, axis2=2) - 1.0) / 2.0
    turn = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))) * fps
    return dict(speed_m_s=float(speed.mean()), turn_deg_s=float(turn.mean()),
                extent_m=[float(x) for x in np.ptp(c, axis=0)])


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------
def _blur3(img):
    """3x3 Gaussian (sigma BLUR_3X3_SIGMA), reflect-101 border, separable
    shifted sums (deterministic)."""
    k = np.exp(-np.array([1.0, 0.0, 1.0]) / (2 * BLUR_3X3_SIGMA ** 2))
    k = (k / k.sum()).tolist()
    p = F.pad(img[:, None], (0, 0, 1, 1), mode="reflect")[:, 0]
    v = k[0] * p[:, :-2] + k[1] * p[:, 1:-1] + k[2] * p[:, 2:]
    p = F.pad(v[:, None], (1, 1, 0, 0), mode="reflect")[:, 0]
    return k[0] * p[..., :-2] + k[1] * p[..., 1:-1] + k[2] * p[..., 2:]


@dataclass
class Sequence:
    """Rendered frames and their truth."""
    images: np.ndarray       # (N, H, W) uint8, host: what a camera delivers
    R_cw: np.ndarray         # (N, 3, 3) float64
    t_cw: np.ndarray         # (N, 3) float64
    scene: object            # has .distance(points) -> metres to a surface


def render(traffic: dict, cam, n_frames: int, seed: int, device,
           base=HERE) -> Sequence:
    """Render `n_frames` frames of a traffic mix for camera `cam` on
    `device`, with the path and scene kinds found under `base`; the same
    (traffic, cam, n_frames, seed) gives the same frames."""
    path = traffic["path"]
    R_cw, t_cw = load("path_kinds", path["kind"], base).poses(
        path, n_frames, cam)
    centres = -np.einsum("nji,nj->ni", R_cw, t_cw)
    spec = traffic["scene"]
    scene = load("scene_kinds", spec["kind"], base).Scene(
        spec, seed, centres, device)
    rays = torch.as_tensor(pixel_rays(cam), dtype=torch.float32,
                           device=device)
    tex = scene.textures                         # (F, th, tw)
    n_faces, th, tw = tex.shape
    atlas = tex.reshape(1, 1, n_faces * th, tw)
    noise = torch.Generator(device=device)
    noise.manual_seed(seed64(seed, 3))
    images = np.empty((n_frames, cam.height, cam.width), np.uint8)
    for s in range(0, n_frames, BATCH):
        e = min(s + BATCH, n_frames)
        R = torch.as_tensor(R_cw[s:e], dtype=torch.float32, device=device)
        eye = torch.as_tensor(centres[s:e], dtype=torch.float32,
                              device=device)
        d = torch.einsum("hwc,bcj->bhwj", rays, R)   # world dirs: R^T ray
        face, a, b = scene.hit(eye, d)
        a = (a - 0.5).clamp(0, tw - 1)
        b = (b - 0.5).clamp(0, th - 1) + face * th
        grid = torch.stack([(a + 0.5) / tw * 2 - 1,
                            (b + 0.5) / (n_faces * th) * 2 - 1], -1)
        img = F.grid_sample(atlas.expand(e - s, -1, -1, -1), grid,
                            mode="bilinear", padding_mode="border",
                            align_corners=False)[:, 0]
        img = _blur3(img)
        img = img + NOISE_STD * torch.randn(img.shape, generator=noise,
                                            device=device)
        images[s:e] = img.clamp(0, 255).to(torch.uint8).cpu().numpy()
    return Sequence(images, R_cw, t_cw, scene)

