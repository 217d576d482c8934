"""Dominant-plane detection from tracked landmarks — batched RANSAC.

Port of ar_orbslam2_tpu/ar/plane.py, a redesign of ViewerAR::DetectPlane +
struct Plane (Examples/ROS/ORB_SLAM2/src/AR/ViewerAR.cc:≈450): the
reference's 50-iteration loop over 3-point plane fits becomes one batch of
hypotheses on the device; selection by the 20th-percentile point-plane
distance and the final inlier cut at 1.4x that value mirror the
reference's vote logic. The Plane carries T_pw (plane -> world) so virtual
objects sit on it (glTpw parity).

The JAX package draws its samples with ``jax.random.choice``; here they
come from a ``torch.Generator``, and ``plane_ransac`` takes injected
samples so that tests can hold it to the JAX function on the JAX draw.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.device import resolve_device


def draw_samples(valid, n_hyp, generator=None):
    """(n_hyp, 3) int64 point indices drawn with replacement, uniformly
    over the valid points (an invalid point has weight 0; at least one
    point must be valid)."""
    return torch.multinomial(valid.to(torch.float32), n_hyp * 3,
                             replacement=True,
                             generator=generator).reshape(n_hyp, 3)


def plane_ransac(points, valid, samples, inlier_factor=1.4):
    """RANSAC 3-point plane fit over tracked map points.

    points (N, 3) float32, valid (N,) bool, samples (n_hyp, 3) point
    indices. Returns dict(normal (3,), d (offset), inlier (N,) bool,
    score, th) — tensors. Plane: n·x + d = 0, |n| = 1.
    """
    N = points.shape[0]
    a, b, c = (points[samples[:, j]] for j in range(3))
    n = torch.linalg.cross(b - a, c - a)
    norm = torch.linalg.norm(n, dim=-1)
    ns = n / torch.clamp(norm, min=1e-12)[:, None]
    ds = -(ns * a).sum(-1)
    ok = norm > 1e-9
    dist = torch.abs(points @ ns.T + ds[None, :])          # (N, H)
    dist = torch.where(valid[:, None] & ok[None, :], dist,
                       torch.full_like(dist, 1e9))
    n_valid = torch.clamp(valid.sum(), min=1)
    # 20th-percentile distance per hypothesis (reference's vote metric);
    # the row index is clamped as a JAX gather clamps it
    k = torch.clamp((0.2 * n_valid).to(torch.int64), min=3).clamp(max=N - 1)
    sorted_d = torch.sort(dist, dim=0).values
    score = sorted_d.gather(0, k.expand(1, dist.shape[1]))[0]
    best = torch.argmin(score)
    # floor keeps the threshold positive for exactly-coplanar (noise-free)
    # points, where the best 20th-percentile distance is 0
    th = inlier_factor * score[best] + 1e-4
    inlier = (dist[:, best] < th) & valid
    return dict(normal=ns[best], d=ds[best], inlier=inlier,
                score=score[best], th=th)


@dataclass
class Plane:
    """World-frame plane + anchor pose (parity: struct Plane / glTpw)."""
    normal: np.ndarray          # (3,) unit, world frame
    origin: np.ndarray          # (3,) a point on the plane (inlier centroid)
    T_pw: np.ndarray            # (4,4) plane -> world
    n_inliers: int = 0          # points the fit kept

    @staticmethod
    def from_fit(normal, d, points, inlier, cam_center=None):
        normal = np.asarray(normal, np.float64)
        inl = np.asarray(inlier)
        pts = np.asarray(points)[inl]
        origin = pts.mean(0) if len(pts) else -d * normal
        # orient the normal toward the camera (reference flips by view dir)
        if cam_center is not None and \
                np.dot(normal, np.asarray(cam_center) - origin) < 0:
            normal = -normal
        # build T_pw: plane y-axis = normal (objects stand "up")
        up = normal / max(np.linalg.norm(normal), 1e-12)
        ref = np.array([1.0, 0.0, 0.0])
        if abs(np.dot(ref, up)) > 0.9:
            ref = np.array([0.0, 0.0, 1.0])
        x = np.cross(ref, up)
        x /= max(np.linalg.norm(x), 1e-12)
        z = np.cross(x, up)
        T = np.eye(4)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, up, z, origin
        return Plane(normal=up, origin=origin, T_pw=T)


def detect_plane(points, valid, cam_center=None, seed=0, n_hyp=64,
                 min_inliers=20, device=None, samples=None):
    """Host wrapper: fit on the device + least-squares refine on the host.
    Returns Plane or None. `samples` (n_hyp, 3) replaces the draw.

    Parity: ViewerAR::DetectPlane(Tcw, vMPs, 50 iters).
    """
    if int(np.sum(valid)) < min_inliers:       # inliers are valid points
        return None
    dev = resolve_device(device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    ok = torch.as_tensor(np.asarray(valid, bool), device=dev)
    if samples is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        samples = draw_samples(ok, n_hyp, gen)
    else:
        samples = torch.as_tensor(np.asarray(samples), device=dev)
    inlier = plane_ransac(pts, ok, samples)["inlier"].cpu().numpy()
    if int(inlier.sum()) < min_inliers:
        return None
    # least-squares refine over inliers (SVD of centered points)
    pts = np.asarray(points)[inlier].astype(np.float64)
    c = pts.mean(0)
    _, _, Vt = np.linalg.svd(pts - c, full_matrices=False)
    n = Vt[-1]
    out = Plane.from_fit(n, -np.dot(n, c), points, inlier, cam_center)
    out.n_inliers = int(inlier.sum())
    return out
