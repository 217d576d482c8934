#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (ar_orbslam2_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints its numbers on its own line; any failure exits
non-zero before the final line):

  1. card     — name and power limit (nvidia-smi), torch and CUDA versions;
  2. build    — compiles the Hamming kernel from csrc/ with nvcc;
  3. kernel   — the kernel against its plain torch version on the card, at
                the main path's shapes (1024/2048/4096 queries x 1024
                keypoints) plus a ragged shape, on tie-free and tie-heavy
                inputs: every output must be bit-identical; the device time
                of both (calls queued behind a sleep kernel, CUDA events) and
                the time a caller waits for one call;
  4. main     — the 640x480 monocular sequence through
                SlamSystem.track_monocular_batch on the card: state OK,
                >= 90% of frames after init tracked, >= 3 keyframes,
                scale-aligned ATE < 0.05, and the kernel launched at least
                once per tracked frame.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Needs no network and no JAX; exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

SHAPES = [(1024, 1024), (2048, 1024), (4096, 1024), (1000, 997)]
REPEATS = 60
QUEUED_CALLS = 10          # calls queued behind the sleep in device_ms
SLEEP_CYCLES = 200_000_000  # ~0.1 s of GPU clock: far longer than queuing them
ATE_GATE = 0.05            # tests/test_slam_image_e2e.py's image-pipeline gate
TRACKED_SHARE_GATE = 0.90
MIN_KEYFRAMES = 3


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(tag, **numbers):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in numbers.items()),
          flush=True)


# ---------------------------------------------------------------------------
# phase 3 inputs
# ---------------------------------------------------------------------------
def make_inputs(torch, n, m, ties, seed):
    """Windowed-search inputs on the card. ties=False: random descriptors
    with planted near-matches; ties=True: every keypoint repeated 4x (same
    descriptor, uv and octave) and every query repeated 2x, so rows and
    columns are full of exact ties."""
    import numpy as np
    rng = np.random.default_rng(seed)
    if ties:
        base_k = rng.integers(0, 2, (-(-m // 4), 256))
        kp_bits = np.repeat(base_k, 4, axis=0)[:m]
        kp_uv = np.repeat(rng.uniform([0, 0], [640, 480],
                                      (len(base_k), 2)), 4, axis=0)[:m]
        kp_oct = np.repeat(rng.integers(0, 8, len(base_k)), 4)[:m]
        src = np.repeat(rng.integers(0, m, -(-n // 2)), 2)[:n]
        q_bits = kp_bits[src].copy()
        q_uv = kp_uv[src].copy()
    else:
        kp_bits = rng.integers(0, 2, (m, 256))
        kp_uv = rng.uniform([0, 0], [640, 480], (m, 2))
        kp_oct = rng.integers(0, 8, m)
        src = rng.integers(0, m, n)
        q_bits = kp_bits[src].copy()
        flips = rng.random((n, 256)) < rng.uniform(0.0, 0.3, (n, 1))
        q_bits ^= flips
        q_uv = kp_uv[src] + rng.normal(0, 3, (n, 2))
    q_oct = kp_oct[src]
    dev = "cuda"

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev,
                               dtype=dtype)
    return dict(
        q_signs=t(q_bits * 2 - 1, torch.int8),
        q_uv=t(q_uv, torch.float32),
        q_radius=t(rng.uniform(4.0, 25.0, n), torch.float32),
        q_olo=t(q_oct - 1, torch.int32),
        q_ohi=t(q_oct + 1, torch.int32),
        q_valid=t(rng.random(n) > 0.1, torch.bool),
        kp_signs=t(kp_bits * 2 - 1, torch.int8),
        kp_uv=t(kp_uv, torch.float32),
        kp_octave=t(kp_oct, torch.int32),
        kp_valid=t(rng.random(m) > 0.05, torch.bool))


def device_ms(torch, fn, calls=QUEUED_CALLS, repeats=9):
    """Device time of one call of fn, host launch cost excluded: the calls
    are queued behind a sleep kernel, so the device runs them back to back;
    CUDA events around them, median over repeats. Fails if the device
    reached the timed calls before the host had queued them all — a call
    that synchronises would do that."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        if a.query():
            fail("the device ran ahead of the host while timing "
                 "(a synchronising call, or a sleep too short)")
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    times.sort()
    return times[len(times) // 2]


def median_ms(torch, fn, repeats=REPEATS, warmup=5):
    """Median of CUDA-event times around single calls: the time a caller
    waits for one call, host launch cost included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def check_kernel(torch, CH):
    """Phase 3. Returns the kernel record for the JSON line."""
    worst = 0
    timings = {}
    for n, m in SHAPES:
        for ties in (False, True):
            x = make_inputs(torch, n, m, ties, seed=n + m + ties)
            args = tuple(x.values())
            got = CH.top2_cuda(*args)
            want = CH.top2_reference(*args)
            torch.cuda.synchronize()
            names = ("idx0", "d0", "d1", "kp_best_d", "kp_best_q")
            for name, a, b in zip(names, got, want):
                err = int((a.long() - b.long()).abs().max())
                worst = max(worst, err)
                if err:
                    fail(f"kernel != plain at {(n, m)} ties={ties}: {name} "
                         f"differs in {int((a != b).sum())} entries")
            for mutual in (False, True):
                idx_k, d0_k = CH.fused_windowed_top2(
                    *args, th=100, nn_ratio=0.9, mutual=mutual)
                idx_r, d0_r = CH.fused_windowed_top2_reference(
                    *args, th=100, nn_ratio=0.9, mutual=mutual)
                if not (torch.equal(idx_k, idx_r) and torch.equal(d0_k, d0_r)):
                    fail(f"filtered idx differs at {(n, m)} ties={ties} "
                         f"mutual={mutual}")
            n_match = int((idx_k >= 0).sum())
            phase("kernel-check", shape=f"{n}x{m}", ties=ties,
                  bit_identical=True, matches=n_match)
        x = make_inputs(torch, n, m, False, seed=7)
        args = tuple(x.values())
        # the main path hands the kernel packed descriptors (Frame /
        # MapStore keep them so); time it that way
        pk = list(args)
        pk[0] = CH.H.packed_from_signs(args[0])
        pk[6] = CH.H.packed_from_signs(args[6])
        fns = {"kernel": lambda: CH.top2_cuda(*pk),
               "plain": lambda: CH.top2_reference(*pk),
               "wrapper": lambda: CH.fused_windowed_top2(*pk),
               "plain_wrapper": lambda: CH.fused_windowed_top2_reference(
                   *pk)}
        dev = {k: device_ms(torch, f) for k, f in fns.items()}
        wall = {k: median_ms(torch, fns[k])
                for k in ("wrapper", "plain_wrapper")}
        timings[(n, m)] = (dev["wrapper"], dev["plain_wrapper"])
        phase("kernel-time", shape=f"{n}x{m}",
              **{f"{k}_device_ms": f"{v:.4f}" for k, v in dev.items()},
              **{f"{k}_call_ms": f"{v:.4f}" for k, v in wall.items()},
              device_repeats=f"9x{QUEUED_CALLS}", call_repeats=REPEATS)
    ms, plain = timings[(4096, 1024)]
    return dict(name="hamming_top2", route="cuda",
                source="ar_orbslam2_tpu_torch/csrc/cuda_hamming.cu",
                replaces="ar_orbslam2_tpu/ops/pallas_hamming.py:39",
                launches=None, max_abs_err=worst, ms=ms, plain_ms=plain,
                timed="device ms per fused_windowed_top2 call at 4096x1024,"
                      " packed descriptors (kernel + key decode + filter)")


def run_main_path(torch, CH):
    """Phase 4: the port's main path on the card."""
    import numpy as np

    from ar_orbslam2_tpu_torch.core.camera import Camera
    from ar_orbslam2_tpu_torch.data import synthetic
    from ar_orbslam2_tpu_torch.eval.ate import ate_rmse
    from ar_orbslam2_tpu_torch.system.slam import SlamConfig, SlamSystem

    cam = Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                 width=640, height=480)
    n_frames = 60
    imgs, R_cw, t_cw = synthetic.render_plane_sequence(
        cam, n_frames=n_frames, seed=0, motion=0.25)
    cfg = SlamConfig(use_fused_tracking=False, async_mapping=False,
                     enable_loop_closing=False, enable_relocalization=False)
    slam = SlamSystem(cam, cfg, device="cuda")
    frame_ms = []
    track_one = slam.track_monocular

    def timed(*a, **kw):                  # per-frame wall time, synced
        t0 = time.perf_counter()
        out = track_one(*a, **kw)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        return out
    slam.track_monocular = timed

    torch.cuda.reset_peak_memory_stats()
    CH.fused_windowed_top2.launches = 0
    t0 = time.perf_counter()
    poses = slam.track_monocular_batch(
        list(imgs), timestamps=[i / 30.0 for i in range(n_frames)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = CH.fused_windowed_top2.launches
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20

    ok = [p is not None for p in poses]
    if not any(ok):
        fail("main path never initialised")
    init = ok.index(True)
    after = ok[init + 1:]
    share = sum(after) / max(len(after), 1)
    est = np.array([-(p[:3, :3].T @ p[:3, 3]) for p in poses if p is not None])
    gt = np.array([-(R_cw[i].T @ t_cw[i])
                   for i, p in enumerate(poses) if p is not None])
    ate = float(ate_rmse(est, gt, with_scale=True))
    steady = sorted(frame_ms[init + 1:])
    med = steady[len(steady) // 2]
    p90 = steady[min(int(0.9 * len(steady)), len(steady) - 1)]
    n_kf, n_mp = slam.store.n_keyframes(), slam.store.n_map_points()
    slam.shutdown()
    phase("main-path", frames=n_frames, init_frame=init,
          tracked_after_init=f"{sum(after)}/{len(after)}",
          state=slam.tracking.state, keyframes=n_kf, map_points=n_mp,
          ate=f"{ate:.5f}", ms_per_frame_median=f"{med:.2f}",
          ms_per_frame_p90=f"{p90:.2f}", wall_s=f"{wall:.2f}",
          kernel_launches=launches, peak_device_mib=f"{peak_mib:.1f}")
    if slam.tracking.state != "OK":
        fail(f"final state {slam.tracking.state}")
    if share < TRACKED_SHARE_GATE:
        fail(f"tracked share {share:.3f} < {TRACKED_SHARE_GATE}")
    if n_kf < MIN_KEYFRAMES:
        fail(f"{n_kf} keyframes < {MIN_KEYFRAMES}")
    if not ate < ATE_GATE:
        fail(f"ATE {ate:.4f} >= {ATE_GATE}")
    if launches < sum(after):
        fail(f"{launches} kernel launches < {sum(after)} tracked frames")
    return launches


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this test needs a GPU")
    try:
        from ar_orbslam2_tpu_torch.ops import cuda_hamming as CH
    except ImportError as e:
        fail(f"the port package is not beside this script ({e})")

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    kind = torch.cuda.get_device_name(0)
    phase("card", name=json.dumps(kind), torch=torch.__version__,
          cuda=torch.version.cuda, count=torch.cuda.device_count())

    # 2. build
    t0 = time.perf_counter()
    CH.build_kernel()
    phase("build", seconds=f"{time.perf_counter() - t0:.2f}")
    for line in CH.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)

    # 3. kernel vs plain version
    rec = check_kernel(torch, CH)

    # 4. main path
    rec["launches"] = run_main_path(torch, CH)
    torch.cuda.synchronize()

    print(json.dumps({"kernels": [rec]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
