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
import faulthandler
import os
import shutil
import signal
import tempfile
import time
import traceback
import warnings

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


def _spawned(rank, world_size, root, backend, fn, args, timeout):
    """One rank of spawn_local. A failure leaves ``rank<r>.error`` in
    `root`: the stage it happened in (group set-up, fn, group tear-down),
    the time, and the traceback, for spawn_local to report; fn's return
    leaves ``rank<r>.done``. SIGUSR1 writes the rank's Python stacks to
    ``rank<r>.stack``: spawn_local asks for them before it stops a rank."""
    faulthandler.register(signal.SIGUSR1, all_threads=True, file=open(
        os.path.join(root, f"rank{rank}.stack"), "w"))
    stage = "group set-up"
    try:
        store = dist.FileStore(os.path.join(root, "store"), world_size)
        kw = {} if timeout is None else dict(
            timeout=datetime.timedelta(seconds=timeout))
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size, **kw)
        # every rank finishes the set-up before any rank runs fn: a rank
        # that fails fast cannot tear down a peer's connection mesh
        dist.barrier(device_ids=[torch.cuda.current_device()]
                     if backend == "nccl" else None)
        stage = "fn"
        try:
            fn(rank, world_size, *args)
            open(os.path.join(root, f"rank{rank}.done"), "w").close()
            stage = "group tear-down"
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(root, f"rank{rank}.error"), "w") as f:
            f.write(f"{stage}\n{time.time()!r}\n{traceback.format_exc()}")
        raise


def spawn_local(world_size, fn, *args, backend="gloo", timeout=None):
    """Run ``fn(rank, world_size, *args)`` in `world_size` new processes
    that form one group through a FileStore in a temporary directory
    (removed afterwards), and wait for all of them. `fn` must be
    importable by name (a module-level function).

    When ranks fail, the others get FAIL_GRACE_S to finish or fail by
    themselves, then are stopped, and RuntimeError names every failed rank
    with its own error: those raised inside fn first (the earliest first),
    then those of the group's set-up or tear-down, then ranks that died
    without one. Once fn has returned on every rank, a rank still running
    after EXIT_GRACE_S (in the group's tear-down or the interpreter's) is
    stopped, and a RankStoppedWarning names it with its Python stacks: its
    work is done, but it hung. Every rank stopped is named with the stacks
    it had when it was stopped.

    timeout: seconds to wait for the ranks, start-up included (None: no
    limit). It also bounds each rank's wait for its peers in the group's
    set-up and collectives. When it passes with no rank failed, the ranks
    still running are terminated and TimeoutError names them."""
    import torch.multiprocessing as mp
    from multiprocessing.connection import wait
    root = tempfile.mkdtemp(prefix="torch_group_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_spawned, args=(
        r, world_size, root, backend, fn, args, timeout))
        for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        failed_by = exit_by = None      # when the others must have ended
        late = {}
        while any(p.is_alive() for p in procs):
            now = time.monotonic()
            if failed_by is None and any(p.exitcode for p in procs):
                failed_by = now + FAIL_GRACE_S
            if exit_by is None and all(os.path.exists(os.path.join(
                    root, f"rank{r}.done")) for r in range(world_size)):
                exit_by = now + EXIT_GRACE_S
            ends = [t for t in (deadline, failed_by, exit_by)
                    if t is not None]
            if ends and now >= min(ends):
                late = _stop_late(root, procs)
                if failed_by is None and exit_by is None:
                    raise TimeoutError(
                        ", ".join(f"rank {r}" for r in late)
                        + f" did not finish within {timeout} s\n"
                        + _stacks(late))
                break
            # the done files are polled: wake at least every second
            wait([p.sentinel for p in procs if p.is_alive()],
                 min([1.0] + [t - now for t in ends]))
        _raise_failures(root, procs, late)
    finally:
        _stop(procs)
        shutil.rmtree(root, ignore_errors=True)


FAIL_GRACE_S = 10.0     # spawn_local: the others' time after a rank fails
EXIT_GRACE_S = 30.0     # spawn_local: a rank's time to exit once fn is done
STACK_WAIT_S = 2.0      # spawn_local: a rank's time to write its stacks


class RankStoppedWarning(RuntimeWarning):
    """A rank of spawn_local returned from fn but did not exit, and was
    stopped; the message holds its Python stacks."""


def _stop_late(root, procs):
    """Ask every rank still running for its Python stacks, stop them all,
    and return {rank: stacks}. A rank past its interpreter's shutdown has
    no handler left, and SIGUSR1 ends it."""
    late = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in late:
        try:
            os.kill(procs[r].pid, signal.SIGUSR1)
        except ProcessLookupError:
            pass                    # it has just exited
    time.sleep(STACK_WAIT_S if late else 0.0)
    _stop(procs)
    stacks = {}
    for r in late:
        try:
            with open(os.path.join(root, f"rank{r}.stack")) as f:
                stacks[r] = f.read().strip()
        except FileNotFoundError:
            stacks[r] = ""
        stacks[r] = stacks[r] or "(no Python stack: the rank was not " \
            "running Python, as before its start-up or after its " \
            "interpreter's shutdown)"
    return stacks


def _stacks(stacks):
    return "".join(f"rank {r}'s stacks when it was stopped:\n{text}\n"
                   for r, text in stacks.items())


def _raise_failures(root, procs, stopped):
    """Raise RuntimeError naming every rank that failed, or warn about
    the ranks that hung after fn returned. stopped: {rank: stacks} of the
    ranks spawn_local stopped."""
    found, hung = [], {}
    for r, p in enumerate(procs):
        path = os.path.join(root, f"rank{r}.error")
        if r in stopped and os.path.exists(os.path.join(root,
                                                        f"rank{r}.done")):
            hung[r] = stopped[r]    # its work done, it did not exit
            continue
        if os.path.exists(path):
            with open(path) as f:
                stage, when, trace = f.read().split("\n", 2)
            found.append((stage != "fn", float(when), r,
                          f"rank {r} failed in {stage}:\n{trace}"))
        elif p.exitcode:
            found.append((True, float("inf"), r, f"rank {r} " + (
                "was stopped after a peer failed; " + _stacks(
                    {r: stopped[r]}) if r in stopped
                else f"exited with code {p.exitcode}\n")))
    if found:
        raise RuntimeError(
            f"{len(found)} of {len(procs)} ranks failed\n"
            + "\n".join(text for *_, text in sorted(found)))
    if hung:
        warnings.warn(RankStoppedWarning(
            ", ".join(f"rank {r}" for r in hung) + " returned from fn but "
            f"was still running {EXIT_GRACE_S} s after fn had returned on "
            "every rank, and was stopped\n" + _stacks(hung)), stacklevel=3)


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
