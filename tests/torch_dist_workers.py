"""Ranks of the port's multi-process tests (tests/test_torch_dist_ba.py,
test_torch_multihost.py, test_torch_loop_gba.py), started by
ar_orbslam2_tpu_torch.parallel.multihost.spawn_local on gloo over CPU
processes. This module imports torch and the port only, never jax: each
spawned rank imports it by name. Rank 0 saves what the test compares.
"""
import time

import numpy as np
import torch

from ar_orbslam2_tpu_torch.core.camera import Camera

PT_KEYS = ("pts", "pt_valid", "obs_cam", "obs_uv", "obs_oct", "obs_valid",
           "obs_uvr")
CAM_KEYS = ("cam_R", "cam_t", "cam_fixed", "cam_valid")


def _cpu_mesh():
    from ar_orbslam2_tpu_torch.parallel import dist_ba
    torch.set_num_threads(1)
    return dist_ba.make_mesh(device="cpu")


def dist_ba_rank(rank, world, prob, cam_kw, n_iters, out):
    """dist_bundle_adjust (or, with prob["band_off"], the banded route) on
    this rank's share of `prob`; rank 0 saves the gathered result and the
    collectives issued."""
    from ar_orbslam2_tpu_torch.parallel import dist_ba
    mesh = _cpu_mesh()
    pts = dist_ba.shard_point_arrays(mesh, *(prob[k] for k in PT_KEYS))
    cams = dist_ba.replicate(mesh, *(prob[k] for k in CAM_KEYS))
    cam = Camera(**cam_kw)
    if "band_off" in prob:
        (off,) = dist_ba.shard_point_arrays(mesh, prob["band_off"])
        res = dist_ba.dist_bundle_adjust_banded(
            mesh, *cams, *pts[:6], cam, band_off=off,
            band_w=prob["band_w"], obs_uvr=pts[6], n_iters=n_iters)
    else:
        res = dist_ba.dist_bundle_adjust(mesh, *cams, *pts[:6], cam,
                                         obs_uvr=pts[6], n_iters=n_iters)
    calls = mesh.calls
    full = {k: dist_ba.gather_points(mesh, res[k]).numpy()
            for k in ("pts", "obs_inlier")}
    if rank == 0:
        np.savez(out, cam_R=res["cam_R"].numpy(), cam_t=res["cam_t"].numpy(),
                 cost=float(res["cost"]), calls=calls, **full)


def gba_rank(rank, world, map_path, cam_kw, routes, n_iters, out):
    """global_bundle_adjustment through each of `routes` (dicts of its
    distributed / banded arguments), each on a fresh copy of the saved
    map; rank 0 saves every route's keyframe translations, landmarks and
    cost."""
    from ar_orbslam2_tpu_torch.mapping import global_ba
    from ar_orbslam2_tpu_torch.mapstore.checkpoint import load_map
    torch.set_num_threads(1)
    saved = {}
    for i, kw in enumerate(routes):
        store = load_map(map_path)
        cost = global_ba.global_bundle_adjustment(
            store, Camera(**cam_kw), n_iters=n_iters, device="cpu", **kw)
        saved.update({f"kf_R{i}": store.kf_R, f"kf_t{i}": store.kf_t,
                      f"mp_pos{i}": store.mp_pos, f"cost{i}": cost})
    if rank == 0:
        np.savez(out, **saved)


def rank_local_gba_rank(rank, world, map_path, cam_kw, out):
    """Only rank 0 closes a loop: the background BA and the loop closer's
    inline and background BA run on rank 0 alone, each on a fresh copy of
    the saved map, while the other ranks wait at the closing barrier. On
    rank 0 make_mesh raises, so a distributed route fails at once instead
    of waiting for peers that never come. Rank 0 saves the keyframe
    translations after each."""
    import torch.distributed as dist

    from ar_orbslam2_tpu_torch.loop.loop_closing import (LoopCloser,
                                                         LoopCloserConfig)
    from ar_orbslam2_tpu_torch.mapping.background_gba import BackgroundGBA
    from ar_orbslam2_tpu_torch.mapstore.checkpoint import load_map
    from ar_orbslam2_tpu_torch.parallel import dist_ba
    torch.set_num_threads(1)
    if rank == 0:
        def refuse(*a, **kw):
            raise AssertionError("a rank-local global BA took the "
                                 "distributed route")
        dist_ba.make_mesh = refuse
        cam = Camera(**cam_kw)
        store = load_map(map_path)
        gba = BackgroundGBA(store, cam, device="cpu")
        gba.launch()
        saved = dict(bg_applied=gba.poll(block=True), bg_kf_t=store.kf_t)
        for background in (False, True):
            store = load_map(map_path)
            lc = LoopCloser(store, None, cam, LoopCloserConfig(
                background_gba=background), device="cpu")
            lc._global_ba()
            lc.gba.poll(block=True)
            saved[f"lc{int(background)}_kf_t"] = store.kf_t
        np.savez(out, **saved)
    dist.barrier()


def selftest_rank(rank, world, out_dir):
    """multihost.selftest on the CPU; every rank writes its return code."""
    from ar_orbslam2_tpu_torch.parallel import multihost
    torch.set_num_threads(1)
    rc = multihost.selftest(device="cpu")
    with open(f"{out_dir}/rank{rank}.rc", "w") as f:
        f.write(str(rc))


def failing_rank(rank, world):
    """Rank 1 raises: spawn_local must report it."""
    if rank == 1:
        raise ValueError("rank 1 gives up")


def stalled_rank(rank, world, seconds):
    """Rank 1 sleeps for `seconds`: spawn_local's deadline must stop it."""
    if rank == 1:
        time.sleep(seconds)
