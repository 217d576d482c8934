"""Strong-scaling harness for the landmark-sharded distributed BA.

Port of ar_orbslam2_tpu/parallel/scaling_bench.py: wall-clock per LM
iteration of parallel/dist_ba.py on a FIXED synthetic bundle-adjustment
problem (the total landmark count stays constant, each rank holds P/n),
at every world size that fits what is available. Each world size is a
group of processes started by multihost.spawn_local; rank 0 reports.

Backends: NCCL runs one rank per card; a second rank on the same card
needs gloo (NCCL refuses two ranks on one GPU), so on one card the table
has world 1 on NCCL and world 2 on gloo sharing cuda:0, and says so. Two
ranks on one card show the exchange code, not interconnect bandwidth:
the table is no scaling claim. On the CPU (`--device cpu`) every world
size runs on gloo.

Run:  python -m ar_orbslam2_tpu_torch.parallel.scaling_bench \
          [--points 65536] [--cams 64] [--opp 16] [--iters 10] [--out FILE]
      torchrun --nproc-per-node N -m ... --distributed   (the whole group
          of the launcher only)
Writes a markdown table to stdout (and --out FILE).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch


def build_problem(n_cams=64, n_pts=65536, opp=16, seed=0):
    """The JAX package's problem, drawn from the same seed: cameras on an
    arc, every landmark seen by `opp` distinct cameras, 0.5 px noise, a
    noisy initialization."""
    from ..core import lie

    rng = np.random.default_rng(seed)
    pts = rng.uniform([-6, -4, 4], [6, 4, 20], (n_pts, 3)).astype(np.float32)
    w = np.zeros((n_cams, 3), np.float32)
    w[:, 1] = 0.04 * np.arange(n_cams)
    cam_R = lie.so3_exp(torch.as_tensor(w)).numpy().astype(np.float32)
    cam_t = np.zeros((n_cams, 3), np.float32)
    cam_t[:, 0] = -0.1 * np.arange(n_cams)
    obs_cam = np.stack([rng.choice(n_cams, opp, replace=False)
                        for _ in range(n_pts)]).astype(np.int32)
    xc = np.einsum("poij,pj->poi", cam_R[obs_cam], pts) + cam_t[obs_cam]
    z = np.maximum(xc[..., 2], 1e-6)
    uv = np.stack([500 * xc[..., 0] / z + 320,
                   500 * xc[..., 1] / z + 240], -1).astype(np.float32)
    uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)
    fixed = np.zeros(n_cams, bool)
    fixed[0] = True
    pts0 = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    return dict(cam_R=cam_R, cam_t=cam_t, cam_fixed=fixed,
                cam_valid=np.ones(n_cams, bool), pts=pts0,
                pt_valid=np.ones(n_pts, bool), obs_cam=obs_cam,
                obs_uv=uv, obs_oct=np.zeros((n_pts, opp), np.int32),
                obs_valid=np.ones((n_pts, opp), bool),
                obs_uvr=np.full((n_pts, opp), -1.0, np.float32))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_on_mesh(mesh, prob, cam, n_iters=10, repeats=3):
    """Time dist_bundle_adjust on this rank's share of `prob`: (best
    seconds per LM iteration over `repeats` runs after one warm-up run,
    cost, collective calls per LM iteration)."""
    import torch.distributed as dist

    from . import dist_ba
    pt_args = dist_ba.shard_point_arrays(
        mesh, prob["pts"], prob["pt_valid"], prob["obs_cam"],
        prob["obs_uv"], prob["obs_oct"], prob["obs_valid"],
        prob["obs_uvr"])
    cam_args = dist_ba.replicate(mesh, prob["cam_R"], prob["cam_t"],
                                 prob["cam_fixed"], prob["cam_valid"])

    def once():
        res = dist_ba.dist_bundle_adjust(
            mesh, *cam_args, *pt_args[:6], cam, obs_uvr=pt_args[6],
            n_iters=n_iters)
        return float(res["cost"])          # reads back: the run has ended

    cost = once()                          # warm-up + correctness
    calls0 = mesh.calls
    best = float("inf")
    for _ in range(repeats):
        dist.barrier(group=mesh.group)
        _sync(mesh.device)
        t0 = time.perf_counter()
        once()
        best = min(best, time.perf_counter() - t0)
    per_iter_calls = (mesh.calls - calls0) / repeats / n_iters
    return best / n_iters, cost, per_iter_calls


def _worker(rank, world, args, device, out_path):
    """One rank of a spawned group: run the bench, rank 0 writes its
    numbers to `out_path`."""
    from ..core.camera import Camera
    from . import dist_ba
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // (2 * world)))
    mesh = dist_ba.make_mesh(device=device)
    cam = Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0)
    prob = build_problem(args.cams, args.points, args.opp)
    per_iter, cost, calls = run_on_mesh(mesh, prob, cam,
                                        n_iters=args.iters)
    if rank == 0:
        np.save(out_path, np.array([per_iter, cost, calls]))


def run_at_world_size(args, world, device, backend):
    """Spawn a group of `world` ranks on `backend` and return rank 0's
    (seconds per LM iteration, cost, collective calls per iteration)."""
    from .multihost import spawn_local
    with tempfile.TemporaryDirectory(prefix="scaling_") as d:
        out = os.path.join(d, "rank0.npy")
        spawn_local(world, _worker, args, device, out, backend=backend)
        per_iter, cost, calls = np.load(out)
    return float(per_iter), float(cost), float(calls)


def plan(device, n_cards):
    """The (world size, backend, device) rows this machine can run."""
    if device.type == "cpu":
        return [(n, "gloo", "cpu") for n in (1, 2, 4, 8)
                if n <= max(os.cpu_count() or 1, 1)]
    rows = [(n, "nccl", None) for n in (1, 2, 4, 8) if n <= n_cards]
    if n_cards == 1:
        rows.append((2, "gloo", "cuda:0"))    # two ranks share the card
    return rows


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=65536)
    ap.add_argument("--cams", type=int, default=64)
    ap.add_argument("--opp", type=int, default=16)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; no GPU raises)")
    ap.add_argument("--distributed", action="store_true",
                    help="join the group announced by torchrun's "
                         "environment (multihost.initialize_from_env) and "
                         "measure ONLY that whole group")
    args = ap.parse_args(argv)

    from ..core.camera import Camera
    from ..core.device import resolve_device
    from . import dist_ba
    from .multihost import initialize_from_env

    device = resolve_device(args.device)
    header = card_line() if device.type == "cuda" else "CPU"
    rows = []
    if args.distributed:
        if not initialize_from_env(backend=None if device.type == "cuda"
                                   else "gloo"):
            print("[scaling] --distributed: no group in the environment",
                  file=sys.stderr)
            return 2
        mesh = dist_ba.make_mesh(device=args.device)
        cam = Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0)
        prob = build_problem(args.cams, args.points, args.opp)
        per_iter, cost, calls = run_on_mesh(mesh, prob, cam,
                                            n_iters=args.iters)
        if mesh.rank != 0:
            return 0
        runs = [(mesh.world_size, mesh.backend, str(mesh.device),
                 per_iter, cost, calls)]
    else:
        runs = []
        n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
        for world, backend, dev in plan(device, n_cards):
            per_iter, cost, calls = run_at_world_size(args, world, dev,
                                                      backend)
            shared = "cuda:0 shared" if (backend == "gloo"
                                         and device.type == "cuda") \
                else (dev or "one card per rank")
            runs.append((world, backend, shared, per_iter, cost, calls))
    t1 = runs[0][3]
    for world, backend, where, per_iter, cost, calls in runs:
        rows.append((world, backend, where, per_iter * 1e3, t1 / per_iter,
                     cost, calls))
        print(f"[scaling] world={world} {backend} ({where}): "
              f"{per_iter * 1e3:.3f} ms/iter cost={cost:.6g} "
              f"collectives/iter={calls:g}", file=sys.stderr)
    lines = [
        f"# Distributed BA ({header}; {args.points} landmarks x "
        f"{args.cams} cameras, {args.opp} obs/landmark, {args.iters} LM "
        "iterations)",
        "",
        "| ranks | backend | devices | ms / LM iter | speedup | cost | "
        "collectives / iter |",
        "|---|---|---|---|---|---|---|",
    ]
    for world, backend, where, ms, sp, cost, calls in rows:
        lines.append(f"| {world} | {backend} | {where} | {ms:.3f} | "
                     f"{sp:.2f}x | {cost:.6g} | {calls:g} |")
    lines.append("")
    lines.append("Comms per iteration: one all_reduce of the (6C)^2 camera "
                 "system and one of the costs, independent of the landmark "
                 "count (parallel/dist_ba.py). Ranks sharing one card "
                 "measure the exchange code, not interconnect bandwidth.")
    table = "\n".join(lines)
    print(table)
    if args.out:
        with open(args.out, "w") as f:
            f.write(table + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
