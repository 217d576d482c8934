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


def render_stereo_plane_loop(cam, n_frames=400, seed=0, tex_size=2048,
                             plane_extent=6.0, distance=1.5, radius=1.2,
                             turns=0.999, tilt=0.0):
    """Rectified stereo pairs of a camera translating once around a circle
    parallel to a textured plane at z=`distance`: the end of the sequence
    revisits its start, while views half a turn apart share no texture (2
    * radius exceeds the view's footprint). The camera keeps one viewing
    direction, tilted by `tilt` radians about the image's vertical axis
    from the plane's normal (0: facing it); the right camera is displaced
    by cam.bf / cam.fx along the camera x axis (as in
    render_stereo_plane_sequence). Returns (left, right, R_cw, t_cw)."""
    baseline = cam.bf / cam.fx if cam.bf > 0 else 0.1
    rng = np.random.default_rng(seed)
    tex = _make_texture(tex_size, seed)
    s = plane_extent / tex_size
    A = np.array([[s, 0, -plane_extent / 2],
                  [0, s, -plane_extent / 2],
                  [0, 0, 1.0]])
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]])
    lefts, rights, Rs, ts = [], [], [], []
    for i in range(n_frames):
        a = 2 * np.pi * turns * i / max(n_frames - 1, 1)
        eye = np.array([radius * np.cos(a), radius * np.sin(a), 0.0])
        R, t = _look_at(eye, eye + np.array([distance * np.tan(tilt), 0.0,
                                             distance]))
        t_r = t - np.array([baseline, 0.0, 0.0], t.dtype)
        lefts.append(_render_plane_view(tex, A, K, cam, R, t, distance,
                                        rng))
        rights.append(_render_plane_view(tex, A, K, cam, R, t_r,
                                         distance, rng))
        Rs.append(R)
        ts.append(t)
    return np.stack(lefts), np.stack(rights), np.stack(Rs), np.stack(ts)


def render_room_loop(cam, n_frames=440, seed=0, turns=1.1, radius=1.5,
                     room=8.0, height=3.0, eye_height=1.5, tex_size=1024):
    """Render a camera walking `turns` times around a circle of radius
    `radius` centred in a square room `room` metres wide and `height`
    high, level at `eye_height` and yawing with the circle so that it
    always looks radially outward at the walls, starting at the middle of
    one wall. Each wall, the
    floor and the ceiling carry their own texture (_make_texture, seeds
    seed + 1 to seed + 6), `tex_size` texels across the room's width.
    Views more than about 90 degrees apart share nothing, so the start is
    seen again only at the revisit, from the first pose's orientation; the
    corners make the scene non-planar. Rendered by per-pixel ray-box
    intersection: the nearest surface wins. World z is up; the camera's
    image y points down. Same return values as render_plane_sequence."""
    import cv2
    rng = np.random.default_rng(seed)
    half, s = room / 2.0, room / tex_size
    # one atlas: walls x=+h, x=-h, y=+h, y=-h, floor, ceiling
    atlas = np.concatenate([_make_texture(tex_size, seed + 1 + k)
                            for k in range(6)])
    K_inv = np.linalg.inv(np.array([[cam.fx, 0, cam.cx],
                                    [0, cam.fy, cam.cy], [0, 0, 1.0]]))
    u, v = np.meshgrid(np.arange(cam.width, dtype=np.float64),
                       np.arange(cam.height, dtype=np.float64))
    rays = np.stack([u, v, np.ones_like(u)], -1) @ K_inv.T   # (H, W, 3)
    angles = 2 * np.pi * turns * np.arange(n_frames) / max(
        n_frames - 1, 1)
    images, Rs, ts = [], [], []
    for a in angles:
        eye = np.array([radius * np.cos(a), radius * np.sin(a), eye_height])
        R, t = _look_at(eye, eye + np.array([np.cos(a), np.sin(a), 0.0]),
                        up=(0.0, 0.0, -1.0))
        d = rays @ R.astype(np.float64)          # world directions (R^T d)
        bound = np.array([half, half, height])
        lo = np.array([-half, -half, 0.0])
        with np.errstate(divide="ignore", invalid="ignore"):
            hit = np.where(d > 0, (bound - eye) / d, (lo - eye) / d)
        hit = np.where(np.isfinite(hit) & (hit > 0), hit, np.inf)
        axis = np.argmin(hit, -1)                # 0: x wall, 1: y, 2: z
        p = eye + d * np.take_along_axis(hit, axis[..., None], -1)
        pos = np.take_along_axis(d, axis[..., None], -1)[..., 0] > 0
        surf = np.where(axis == 2, np.where(pos, 5, 4),
                        2 * axis + np.where(pos, 0, 1))
        across = np.where(axis == 0, p[..., 1], p[..., 0])
        up = np.where(axis == 2, p[..., 1] + half, p[..., 2])
        mx = np.clip((across + half) / s, 0, tex_size - 1)
        my = np.clip(up / s, 0, tex_size - 1) + surf * tex_size
        img = cv2.remap(atlas, mx.astype(np.float32), my.astype(np.float32),
                        cv2.INTER_LINEAR, borderMode=cv2.BORDER_REPLICATE)
        img = cv2.GaussianBlur(img, (3, 3), 0.6)
        noise = rng.normal(0, 1.5, img.shape)
        images.append(np.clip(img.astype(np.float32) + noise, 0,
                              255).astype(np.uint8))
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


def stereo_loop_map(cam, map_cfg=None, n_kf=100, per_kf=160, span=6,
                    radius=1.5, seed=0, noise_px=0.5, pose_noise=0.003,
                    point_noise=0.01):
    """A map as stereo tracking leaves it after one walk round a room with
    its loop closed, written straight into a MapStore (for global BA and
    its partitions).

    `n_kf` keyframes evenly spaced on a level circle of radius `radius`,
    each looking radially outward (render_room_loop's walk); keyframe i
    first observes `per_kf` landmarks 2.5-5.5 m ahead, and each landmark is
    seen by `span` consecutive keyframes, round the loop, with its
    right-image u (cam.bf): a keyframe holds span * per_kf keypoints.
    Pixels carry `noise_px` of noise; every keyframe pose but the first and
    every landmark are perturbed by `pose_noise` / `point_noise` metres.
    Keyframe 0 and the stereo scale fix the gauge and the closed loop
    stiffens the chain, so a global BA has one well-conditioned optimum;
    covisibility is a ring, so a covisibility shard's cameras form a band
    narrower than the map. Returns (MapStore, true landmark positions
    (n_kf * per_kf, 3))."""
    from ..mapstore.map import MapConfig, MapStore
    cfg = map_cfg or MapConfig()
    if span * per_kf > cfg.max_kp:
        raise ValueError(f"{span} x {per_kf} keypoints exceed max_kp "
                         f"{cfg.max_kp}")
    rng = np.random.default_rng(seed)
    store = MapStore(cfg)
    poses = []
    for a in 2 * np.pi * np.arange(n_kf) / n_kf:
        eye = np.array([radius * np.cos(a), radius * np.sin(a), 0.0])
        poses.append(_look_at(eye, eye + np.array([np.cos(a), np.sin(a),
                                                   0.0]),
                              up=(0.0, 0.0, -1.0)))
    # landmarks in front of their first keyframe, moved to the world
    z = rng.uniform(2.5, 5.5, (n_kf, per_kf))
    xc = np.stack([(rng.uniform(20, 290, z.shape) - cam.cx) * z / cam.fx,
                   (rng.uniform(60, 420, z.shape) - cam.cy) * z / cam.fy,
                   z], -1)
    gt = np.concatenate([(x - t) @ R for (R, t), x in zip(poses, xc)])
    noisy = gt + rng.normal(0, point_noise, gt.shape)
    ids = store.add_map_points(
        noisy.astype(np.float32),
        rng.integers(0, 256, (len(gt), 32)).astype(np.uint8), first_kf=0)
    anchor = np.arange(len(gt)) // per_kf
    P = cfg.max_kp
    for i, (R, t) in enumerate(poses):
        seen = np.nonzero((i - anchor) % n_kf < span)[0]
        x = gt[seen] @ R.T + t
        uv = np.zeros((P, 2), np.float32)
        uv[:len(seen)] = np.c_[cam.fx * x[:, 0] / x[:, 2] + cam.cx,
                               cam.fy * x[:, 1] / x[:, 2] + cam.cy] \
            + rng.normal(0, noise_px, (len(seen), 2))
        uvr = np.full(P, -1.0, np.float32)
        uvr[:len(seen)] = uv[:len(seen), 0] - cam.bf / x[:, 2]
        t_kf = t + (rng.normal(0, pose_noise, 3) if i else 0.0)
        k = store.add_keyframe(
            R.astype(np.float32), t_kf.astype(np.float32), uv,
            rng.integers(0, 256, (P, 32)).astype(np.uint8),
            np.zeros(P, np.int32), np.arange(P) < len(seen),
            timestamp=i / 30.0, frame_id=i, uvr=uvr)
        store.add_observations(ids[seen], k, np.arange(len(seen)))
        store.update_connections(k)
    return store, gt.astype(np.float32)
