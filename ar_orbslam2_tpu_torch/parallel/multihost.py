"""Multi-process group initialization on torch.distributed.

Port of ar_orbslam2_tpu/parallel/multihost.py. The JAX package starts
``jax.distributed`` and its collectives ride the TPU interconnect; here
every rank is a process, the group is torch.distributed's, and the
collectives of parallel/dist_ba.py run on NCCL when the rank's device is
a CUDA card and on gloo on the CPU.

Launchers: torchrun sets MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and
LOCAL_RANK, which `initialize_from_env` reads; or pass a ``file://`` init
method with the world size and rank. `spawn_local` starts a local group
in child processes that meet through a FileStore under a temporary
directory, so no port is bound and released before the group takes it.

    torchrun --nproc-per-node 2 -m ar_orbslam2_tpu_torch.parallel.multihost
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist


def initialize_from_env(init_method: str | None = None,
                        world_size: int | None = None,
                        rank: int | None = None,
                        backend: str | None = None) -> bool:
    """Start the default process group when a multi-process run is
    announced (arguments, or torchrun's environment); returns True if a
    group was started, False (and does nothing) when nothing announces
    one, so entry points can call it unconditionally.

    backend: None means NCCL when a CUDA card is visible to this rank,
    gloo otherwise."""
    world_size = world_size if world_size is not None \
        else _int_env("WORLD_SIZE")
    rank = rank if rank is not None else _int_env("RANK")
    if init_method is None:
        if not os.environ.get("MASTER_ADDR") or not world_size:
            return False
        init_method = "env://"
    if not world_size:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(_int_env("LOCAL_RANK") or
                              int(rank or 0) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(world_size), rank=int(rank or 0))
    return True


def _int_env(name):
    v = os.environ.get(name)
    return int(v) if v else None


def global_mesh(device=None):
    """The mesh over the whole default group, for parallel/dist_ba.py."""
    from . import dist_ba
    return dist_ba.make_mesh(device=device)


def _spawned(rank, world_size, store_path, backend, fn, args, timeout):
    store = dist.FileStore(store_path, world_size)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    kw = {} if timeout is None else dict(
        timeout=datetime.timedelta(seconds=timeout))
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, **kw)
    try:
        fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()


def spawn_local(world_size, fn, *args, backend="gloo", timeout=None):
    """Run ``fn(rank, world_size, *args)`` in `world_size` new processes
    that form one group through a FileStore in a temporary directory
    (removed afterwards), and wait for all of them. `fn` must be
    importable by name (a module-level function). Raises if a process
    fails.

    timeout: seconds to wait for the ranks, start-up included (None: no
    limit). It also bounds each rank's wait for its peers in the group's
    set-up and collectives. When it passes, the ranks still running are
    terminated and TimeoutError names them."""
    import torch.multiprocessing as mp
    root = tempfile.mkdtemp(prefix="torch_group_")
    try:
        ctx = mp.spawn(_spawned, nprocs=world_size, join=False, args=(
            world_size, os.path.join(root, "store"), backend, fn, args,
            timeout))
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(None if deadline is None
                           else max(deadline - time.monotonic(), 0.0)):
            if deadline is not None and time.monotonic() >= deadline:
                late = [r for r, p in enumerate(ctx.processes)
                        if p.is_alive()]
                _stop(ctx.processes)
                raise TimeoutError(
                    ", ".join(f"rank {r}" for r in late)
                    + f" did not finish within {timeout} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _stop(processes, grace_s=5.0):
    """Terminate the processes still running, and kill those that
    outlive `grace_s`."""
    for p in processes:
        if p.is_alive():
            p.terminate()
    for p in processes:
        p.join(grace_s)
        if p.is_alive():
            p.kill()
            p.join()


def selftest(device=None) -> int:
    """One rank's half of the multi-process check: join the group
    announced in the environment (or already started), run one sum across
    it — rank r contributes r + 1 in each of its 4 slots — and verify the
    global sum on every rank. device: as dist_ba.make_mesh (None: the
    card; pass "cpu" for a gloo group on the CPU).

    Run directly (one process per rank; torchrun sets the same variables):
        MASTER_ADDR=127.0.0.1 MASTER_PORT=PORT WORLD_SIZE=2 RANK=i \
        python -m ar_orbslam2_tpu_torch.parallel.multihost [--device cpu]
    """
    if not dist.is_initialized() and not initialize_from_env(
            backend=None if device is None else
            ("nccl" if torch.device(device).type == "cuda" else "gloo")):
        print("multihost: no group configured (single-process)")
        return 2
    mesh = global_mesh(device=device)
    print(f"multihost: rank {mesh.rank}/{mesh.world_size} on "
          f"{mesh.device} ({mesh.backend})", flush=True)
    per = 4
    x = torch.full((per,), 1.0 + mesh.rank, device=mesh.device)
    dist.all_reduce(x, group=mesh.group)
    got = float(x.sum())
    want = per * sum(range(1, mesh.world_size + 1))
    ok = abs(got - want) < 1e-3
    print(f"multihost: all_reduce {got} want {want} -> "
          f"{'OK' if ok else 'FAIL'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description="two-or-more-rank sum check")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; no GPU raises)")
    raise SystemExit(selftest(ap.parse_args().device))
