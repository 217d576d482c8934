"""One input, one result, and what the ordered sums cost, on chip_smoke.py
phase 8's room loop (synthetic.render_room_loop: 440 frames, 1.1 turns of
a 1.5 m circle) through SlamConfig(enable_loop_closing=False) at full
width and one call of track_monocular_batch(chunk=8): the sync room leg
without loops, phase 8's "without" of its loops gate.

The leg is walked twice in one process; the returned poses and the
keyframe ATE of the two walks must be equal bit for bit. The first walk's
local BA problems (the inputs of every mapping.local_mapping.bundle_adjust
call) are kept and each is replayed through the BA's camera-indexed sums
(ba_core.schur_sums) on three routes:

* planned: core.sums.IndexSum, the sort made once per problem (the port);
* sorted_each_call: a stable sort and a sorted index_put_(accumulate=True)
  per block in every LM iteration (the same additions in the same order);
* atomic: index_add_, on a CUDA tensor atomics in arrival order (the
  port's sums before they were ordered).

Each route solves each problem twice (the routes in alternating order),
timed on the host clock, synchronised; the summary gives the median over
the problems of each route's better time, and how many problems gave
another result than planned, or than the same route's first run.
`--every k` replays every k-th problem only. The last line is a JSON
summary.

  python -m ar_orbslam2_tpu_torch.eval.sum_routes [--frames 440] \\
      [--every 1] [--device cpu]
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import statistics
import time

import numpy as np
import torch

from ..core import sums
from ..core.camera import Camera
from ..data import synthetic
from ..estimation import ba_core, local_ba
from ..eval.ate import ate_rmse
from ..mapping import local_mapping
from ..system.slam import SlamConfig, SlamSystem

CAM = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)
OUTPUTS = ("cam_R", "cam_t", "pts", "obs_inlier", "cost")


def atomic_sum(idx, n, values):
    """index_add_: in input order on the CPU, atomics on the card."""
    return torch.zeros((n,) + tuple(values.shape[1:]), dtype=values.dtype,
                       device=values.device).index_add_(0, idx, values)


def sorted_sum_each_call(idx, n, values):
    """IndexSum's additions, sorted at this call: a sorted
    index_put_(accumulate=True) per block of sums.RUN entries, then the
    blocks' partial rows added in block order."""
    E, tail = idx.shape[0], tuple(values.shape[1:])
    blocks = min(-(-E // sums.RUN),
                 sums.MAX_PARTIALS // max(n * math.prod(tail), 1))
    key, rows = idx, n
    if blocks >= 2:
        key = torch.arange(E, device=idx.device) // -(-E // blocks) * n + idx
        rows = blocks * n
    part = torch.zeros((rows,) + tail, dtype=values.dtype,
                       device=values.device).index_put_(
        (key,), values, accumulate=True)
    return part if blocks < 2 else part.reshape((blocks, n) + tail).sum(0)


ROUTES = {
    "planned": sums.IndexSum,
    "sorted_each_call": lambda idx, n: functools.partial(
        sorted_sum_each_call, idx, n),
    "atomic": lambda idx, n: functools.partial(atomic_sum, idx, n),
}


def walk(imgs, gt, cam, device, problems=None):
    """The leg once: (returned poses, keyframe ATE, wall s). problems: a
    list that receives every local BA's inputs."""
    real = local_mapping.bundle_adjust

    def keep(*a, **kw):
        copy = lambda x: x.clone() if torch.is_tensor(x) else x
        problems.append(([copy(x) for x in a],
                         {k: copy(v) for k, v in kw.items()}))
        return real(*a, **kw)
    if problems is not None:
        local_mapping.bundle_adjust = keep
    try:
        slam = SlamSystem(cam, SlamConfig(enable_loop_closing=False),
                          device=device)
        t0 = time.perf_counter()
        poses = slam.track_monocular_batch(
            list(imgs), timestamps=[i / 30.0 for i in range(len(imgs))],
            chunk=8)
        slam.shutdown()
        wall = time.perf_counter() - t0
    finally:
        local_mapping.bundle_adjust = real
    ts_k, _, t_k = slam.keyframe_trajectory()
    kf_frame = np.round(np.asarray(ts_k) * 30.0).astype(int)
    ate = float(ate_rmse(t_k, gt[kf_frame], with_scale=True))
    return [None if p is None else np.array(p) for p in poses], ate, wall


def _same(a, b):
    return all(torch.equal(a[k], b[k]) for k in OUTPUTS)


def solve(route, args, kwargs, sync):
    """One local BA through `route`'s sums: (outputs, ms)."""
    ba_core.IndexSum = ROUTES[route]
    try:
        sync()
        t0 = time.perf_counter()
        out = local_ba.bundle_adjust(*args, **kwargs)
        sync()
    finally:
        ba_core.IndexSum = sums.IndexSum
    return out, (time.perf_counter() - t0) * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=440)
    ap.add_argument("--every", type=int, default=1,
                    help="replay every k-th local BA problem")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; no GPU raises)")
    args = ap.parse_args(argv)
    cam = Camera(**CAM)
    imgs, R_cw, t_cw = synthetic.render_room_loop(
        cam, n_frames=440, turns=1.1, radius=1.5)
    imgs = imgs[:args.frames]
    gt = -(np.swapaxes(R_cw, -1, -2) @ t_cw[..., None])[..., 0]
    problems = []
    poses_a, ate_a, wall_a = walk(imgs, gt, cam, args.device, problems)
    poses_b, ate_b, wall_b = walk(imgs, gt, cam, args.device)
    same_poses = len(poses_a) == len(poses_b) and all(
        (a is None) == (b is None) and (a is None or np.array_equal(a, b))
        for a, b in zip(poses_a, poses_b))

    dev = problems[0][0][0].device if problems else torch.device("cpu")
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    ms = {r: [] for r in ROUTES}
    unlike_planned = {r: 0 for r in ROUTES}
    unlike_itself = {r: 0 for r in ROUTES}
    replayed = problems[::max(args.every, 1)]
    for i, (a, kw) in enumerate(replayed):
        first, times = {}, {r: [] for r in ROUTES}
        for rep in range(2):
            order = list(ROUTES) if (i + rep) % 2 == 0 \
                else list(ROUTES)[::-1]
            for r in order:
                out, t = solve(r, a, kw, sync)
                times[r].append(t)
                if r in first:
                    unlike_itself[r] += not _same(out, first[r])
                else:
                    first[r] = out
        for r in ROUTES:
            ms[r].append(min(times[r]))
            unlike_planned[r] += not _same(first[r], first["planned"])
    P, OPP = problems[0][0][6].shape if problems else (0, 0)
    print(json.dumps(dict(
        frames=len(imgs), device=str(dev),
        ate_keyframes=[repr(ate_a), repr(ate_b)],
        returned_poses_bit_identical=same_poses, wall_s=[round(wall_a, 1),
                                                         round(wall_b, 1)],
        local_ba_problems=len(problems), replayed=len(replayed),
        landmarks_x_observations=[P, OPP],
        cameras=int(problems[0][0][0].shape[0]) if problems else 0,
        **{f"{r}_ms_median": round(statistics.median(ms[r]), 2)
           for r in ROUTES if ms[r]},
        unlike_planned=unlike_planned, unlike_its_first_run=unlike_itself,
    )), flush=True)


if __name__ == "__main__":
    main()
