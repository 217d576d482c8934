"""Synthetic scene generation — the primary test substrate.

The reference is only verified end-to-end on real datasets (SURVEY.md §4);
this environment has no network, so synthetic scenes with exact ground
truth are the CI substrate (SURVEY.md §7 step 2):

* feature-level scenes: 3D landmarks with ground-truth 256-bit binary
  descriptors + camera trajectory; `observe_frame` produces per-frame
  (keypoints, noisy descriptors, octaves) with exact data association —
  tests matching / estimation / mapping without the image frontend.
* image-level scenes: `render_plane_sequence` renders a textured plane via
  exact homographies — tests the ORB frontend and the full pipeline with
  ground-truth poses.

Pose convention: Tcw (world->camera), x_c = R @ x_w + t, as everywhere in
the framework (reference parity: Frame::SetPose).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SyntheticScene(NamedTuple):
    landmarks: np.ndarray      # (M, 3) world points, float32
    desc_bits: np.ndarray      # (M, 256) uint8 in {0,1} ground-truth descriptors
    R_cw: np.ndarray           # (N, 3, 3) world->camera rotations
    t_cw: np.ndarray           # (N, 3)
    timestamps: np.ndarray     # (N,)

    @property
    def n_frames(self):
        return len(self.R_cw)

    def twc(self):
        """Camera-to-world poses (for trajectory export / eval)."""
        R_wc = np.swapaxes(self.R_cw, -1, -2)
        t_wc = -(R_wc @ self.t_cw[..., None])[..., 0]
        return R_wc, t_wc


def _look_at(eye, target, up=(0.0, -1.0, 0.0)):
    """World->camera from eye/target (camera z forward, x right, y down)."""
    z = np.asarray(target, np.float64) - eye
    z /= np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    if np.linalg.norm(x) < 1e-6:
        x = np.cross([0.0, 0.0, 1.0], z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R_wc = np.stack([x, y, z], axis=1)        # columns = camera axes in world
    R_cw = R_wc.T
    t_cw = -R_cw @ eye
    return R_cw.astype(np.float32), t_cw.astype(np.float32)


def orbit_trajectory(n_frames, radius=3.0, center=(0.0, 0.0, 4.0),
                     arc=1.2, axis="y", jitter=0.0, seed=0):
    """Camera orbiting a scene center on an arc, always looking at it."""
    rng = np.random.default_rng(seed)
    center = np.asarray(center, np.float64)
    Rs, ts = [], []
    for i in range(n_frames):
        a = (i / max(n_frames - 1, 1) - 0.5) * arc
        if axis == "y":
            off = np.array([np.sin(a), 0.15 * np.sin(2.5 * a), -np.cos(a)])
        else:
            off = np.array([0.15 * np.sin(2.5 * a), np.sin(a), -np.cos(a)])
        eye = center + radius * off
        if jitter:
            eye = eye + rng.normal(0, jitter, 3)
        R, t = _look_at(eye, center)
        Rs.append(R)
        ts.append(t)
    return np.stack(Rs), np.stack(ts)


def forward_trajectory(n_frames, speed=0.05, yaw_rate=0.002):
    """KITTI-style forward motion with slow yaw."""
    Rs, ts = [], []
    pos = np.zeros(3)
    yaw = 0.0
    for _ in range(n_frames):
        fwd = np.array([np.sin(yaw), 0.0, np.cos(yaw)])
        eye = pos.copy()
        R, t = _look_at(eye, eye + fwd)
        Rs.append(R)
        ts.append(t)
        pos += speed * fwd
        yaw += yaw_rate
    return np.stack(Rs), np.stack(ts)


def make_scene(n_landmarks=2000, n_frames=60, seed=0, trajectory="orbit",
               box=((-2.5, -2.0, 2.0), (2.5, 2.0, 6.5)), **traj_kw):
    """Random landmark cloud + trajectory + ground-truth descriptors."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(box[0]), np.asarray(box[1])
    pts = rng.uniform(lo, hi, (n_landmarks, 3)).astype(np.float32)
    desc = (rng.random((n_landmarks, 256)) < 0.5).astype(np.uint8)
    if trajectory == "orbit":
        center = (lo + hi) / 2
        R, t = orbit_trajectory(n_frames, center=center, seed=seed, **traj_kw)
    else:
        R, t = forward_trajectory(n_frames, **traj_kw)
    ts = np.arange(n_frames, dtype=np.float64) / 30.0
    return SyntheticScene(pts, desc, R, t, ts)


def observe_frame(scene: SyntheticScene, frame_idx: int, cam, *,
                  noise_px=0.3, bit_flip=0.03, max_kp=1024,
                  n_levels=8, scale_factor=1.2, seed=None, dropout=0.0):
    """Ground-truth observation of one frame, padded to max_kp.

    Returns dict with:
      uv (max_kp, 2) float32, desc (max_kp, 256) uint8, octave (max_kp,)
      int32, valid (max_kp,) bool, landmark_id (max_kp,) int32 (exact
      data association; -1 for padding).
    Octaves are assigned from depth so scale prediction logic is exercised
    (closer points -> finer octaves, mimicking real pyramid detection).
    """
    rng = np.random.default_rng(
        frame_idx * 7919 + 13 if seed is None else seed)
    R, t = scene.R_cw[frame_idx], scene.t_cw[frame_idx]
    xc = scene.landmarks @ R.T + t
    z = xc[:, 2]
    u = cam.fx * xc[:, 0] / np.maximum(z, 1e-6) + cam.cx
    v = cam.fy * xc[:, 1] / np.maximum(z, 1e-6) + cam.cy
    vis = (z > 0.1) & (u >= 8) & (u < cam.width - 8) & (v >= 8) & (v < cam.height - 8)
    if dropout > 0:
        vis &= rng.random(len(z)) > dropout
    ids = np.nonzero(vis)[0]
    if len(ids) > max_kp:
        ids = rng.choice(ids, max_kp, replace=False)
    k = len(ids)

    uv = np.zeros((max_kp, 2), np.float32)
    desc = np.zeros((max_kp, 256), np.uint8)
    octave = np.zeros(max_kp, np.int32)
    lm = np.full(max_kp, -1, np.int32)
    valid = np.zeros(max_kp, bool)
    depth = np.full(max_kp, -1.0, np.float32)
    depth[:k] = z[ids] * (1.0 + rng.normal(0, 0.002, k))   # GT z-depth

    uv[:k] = np.stack([u[ids], v[ids]], 1) + rng.normal(0, noise_px, (k, 2))
    d = scene.desc_bits[ids].copy()
    flip = rng.random(d.shape) < bit_flip
    desc[:k] = d ^ flip.astype(np.uint8)
    # distance -> octave following the real pyramid model (MapPoint::
    # PredictScale): a feature of fixed physical size appears LARGER when
    # closer, so it is detected at a COARSER octave: oct = log(d_far/d)/
    # log(s) with a GLOBAL d_far. Apparent size scales with the EUCLIDEAN
    # distance from the camera center (not z-depth) — using distance here
    # keeps detected octaves consistent with PredictScale's
    # distance-based prediction, which the [pred-1, pred] octave match
    # window relies on (off-axis points differ by up to a level otherwise).
    R_wc_t = R.T
    center = -(R_wc_t @ t)
    zr = np.linalg.norm(scene.landmarks[ids] - center, axis=1)
    z_far = 10.0
    oct_f = np.ceil(np.log(np.maximum(z_far / zr, 1.0))
                    / np.log(scale_factor))
    octave[:k] = np.clip(oct_f.astype(np.int32), 0, n_levels - 1)
    lm[:k] = ids
    valid[:k] = True
    return dict(uv=uv, desc=desc, octave=octave, valid=valid,
                landmark_id=lm, n_valid=k, depth=depth)


# ---------------------------------------------------------------------------
# Image-level: textured plane renderer (exact homography ground truth)
# ---------------------------------------------------------------------------

def _make_texture(size=2048, seed=0):
    """Feature-rich grayscale texture: multiscale noise + random shapes."""
    import cv2
    rng = np.random.default_rng(seed)
    tex = np.zeros((size, size), np.float32)
    for s in (8, 32, 128):
        n = rng.random((size // s, size // s)).astype(np.float32)
        tex += cv2.resize(n, (size, size), interpolation=cv2.INTER_CUBIC)
    tex = (tex - tex.min()) / (np.ptp(tex) + 1e-9)
    img = (tex * 155 + 50).astype(np.uint8)
    for _ in range(400):
        p = rng.integers(30, size - 30, 2)
        c = int(rng.integers(0, 255))
        r = int(rng.integers(4, 28))
        if rng.random() < 0.5:
            cv2.circle(img, tuple(p), r, c, -1)
        else:
            cv2.rectangle(img, tuple(p - r), tuple(p + r), c, -1)
    return img


def render_plane_sequence(cam, n_frames=40, seed=0, tex_size=2048,
                          plane_extent=6.0, distance=3.0, motion=0.5):
    """Render a camera moving in front of a textured plane at z=`distance`.

    Plane: world z = distance, spanning [-e/2, e/2]^2; texture pixel (px,py)
    maps to world ((px/ts - .5) * e, (py/ts - .5) * e, distance). Returns
    (images [N,H,W] uint8, R_cw, t_cw) with exact poses.
    """
    import cv2
    rng = np.random.default_rng(seed)
    tex = _make_texture(tex_size, seed)
    s = plane_extent / tex_size
    # texture pixel -> world: [X Y 1]^T = A @ [px py 1]^T on the plane
    A = np.array([[s, 0, -plane_extent / 2],
                  [0, s, -plane_extent / 2],
                  [0, 0, 1.0]])
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]])
    images, Rs, ts = [], [], []
    for i in range(n_frames):
        a = i / max(n_frames - 1, 1)
        eye = np.array([motion * np.sin(np.pi * a),
                        0.3 * motion * np.sin(2 * np.pi * a),
                        0.3 * motion * a])
        target = np.array([0.2 * np.sin(np.pi * a), 0.0, distance])
        R, t = _look_at(eye, target)
        img = _render_plane_view(tex, A, K, cam, R, t, distance, rng)
        images.append(img)
        Rs.append(R)
        ts.append(t)
    return np.stack(images), np.stack(Rs), np.stack(ts)


def _render_plane_view(tex, A, K, cam, R, t, distance, rng):
    """One view of the textured plane (exact homography warp)."""
    import cv2
    # world plane point (X, Y, distance): u ~ K (R @ [X,Y,dist] + t)
    #   = K ([r1 r2 (dist*r3 + t)]) @ [X Y 1]^T
    M = np.stack([R[:, 0], R[:, 1], distance * R[:, 2] + t], axis=1)
    H = K @ M @ A
    img = cv2.warpPerspective(
        tex, H.astype(np.float64), (cam.width, cam.height),
        flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT,
        borderValue=0)
    img = cv2.GaussianBlur(img, (3, 3), 0.6)
    noise = rng.normal(0, 1.5, img.shape)
    return np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)


def render_stereo_plane_sequence(cam, n_frames=20, seed=0, tex_size=2048,
                                 plane_extent=6.0, distance=3.0,
                                 motion=0.4):
    """Rectified stereo pairs of the textured plane.

    The right camera is displaced by baseline = cam.bf / cam.fx along the
    camera x axis (x_r = R x + t - [b, 0, 0]) — ideal rectified geometry,
    matching the Frame::ComputeStereoMatches epipolar assumption.
    Returns (left [N,H,W] u8, right [N,H,W] u8, R_cw, t_cw).
    """
    rng = np.random.default_rng(seed)
    tex = _make_texture(tex_size, seed)
    s = plane_extent / tex_size
    A = np.array([[s, 0, -plane_extent / 2],
                  [0, s, -plane_extent / 2],
                  [0, 0, 1.0]])
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]])
    baseline = cam.bf / cam.fx if cam.bf > 0 else 0.1
    lefts, rights, Rs, ts = [], [], [], []
    for i in range(n_frames):
        a = i / max(n_frames - 1, 1)
        eye = np.array([motion * np.sin(np.pi * a),
                        0.3 * motion * np.sin(2 * np.pi * a),
                        0.3 * motion * a])
        target = np.array([0.2 * np.sin(np.pi * a), 0.0, distance])
        R, t = _look_at(eye, target)
        t_r = t - np.array([baseline, 0.0, 0.0], t.dtype)
        lefts.append(_render_plane_view(tex, A, K, cam, R, t,
                                        distance, rng))
        rights.append(_render_plane_view(tex, A, K, cam, R, t_r,
                                         distance, rng))
        Rs.append(R)
        ts.append(t)
    return (np.stack(lefts), np.stack(rights),
            np.stack(Rs), np.stack(ts))
