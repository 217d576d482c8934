"""Where a fused frame's device time goes, on the card.

Run from the repository root on a machine with an NVIDIA GPU:

    python -m ar_orbslam2_tpu_torch.eval.profile_fused

It brings a fused SlamSystem to its steady state on the rendered 640x480
sequence, then
  1. captures each stage of the frame step as a CUDA graph of its own (ORB
     extraction, motion-model track, brute-force fallback, local-map track
     + counters + bindings) and times its replay with CUDA events: node
     count and device ms per stage;
  2. times the whole step in successive batches of replays, with the SM
     clock nvidia-smi reports after each: the clock rises under load, and
     a step of dependent tiny kernels follows it;
  3. profiles one replay of the whole step with torch.profiler: kernel
     count, summed kernel time, the replay's span, the busy share, and the
     kernels that take most of the time, by name.
Prints the card's name and power limit first. Needs no network.
"""
from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

from ..core.camera import Camera
from ..data import synthetic
from ..frontend.orb import extract_orb
from ..system import fused as F
from ..system.graph import GraphRunner
from ..system.slam import SlamConfig, SlamSystem

N_TIMED = 10
N_BATCHES = 12
_CARD_STATE = ("clocks.sm,clocks.mem,pstate,power.draw,"
               "clocks_throttle_reasons.active")


def _replay_ms(runner, n=N_TIMED):
    runner.run()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        runner.run()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def _smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_fused needs a GPU")
    print(_smi("name,power.limit"), flush=True)
    cam = Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640,
                 height=480)
    imgs, _, _ = synthetic.render_plane_sequence(cam, n_frames=16, seed=0,
                                                 motion=0.25)
    slam = SlamSystem(cam, SlamConfig(
        use_fused_tracking=True, async_mapping=False,
        enable_loop_closing=False, enable_relocalization=False),
        device="cuda")
    for i in range(14):
        slam.track_monocular(imgs[i], timestamp=i / 30.0)
    fe = slam.tracking.fused
    if slam.tracking.state != "OK" or fe.state is None:
        sys.exit("the system did not reach the fused state")
    fe._img_in.copy_(torch.as_tensor(imgs[14], device="cuda"))
    st, kw, cell = fe.state, fe._step_kw, {}

    @torch.no_grad()
    def orb():
        cell["f"] = extract_orb(fe._img_in, fe.orb_cfg)

    @torch.no_grad()
    def motion():
        f = cell["f"]
        cell["mid"] = F._megastep_motion(
            cam, st, f["uv"], f["desc_bits"], f["octave"], f["valid"],
            min_track_matches=kw["min_track_matches"],
            min_inliers_track=kw["min_inliers_track"],
            undistort=kw["undistort"])

    @torch.no_grad()
    def fallback():
        f = cell["f"]
        cell["fb"] = F._fallback(cam, st, cell["mid"], f["desc_bits"],
                                 f["octave"], f["valid"])

    @torch.no_grad()
    def local():
        f = cell["f"]
        cell["out"] = F._megastep_rest(
            cam, st, cell["mid"], f["desc_bits"], f["octave"], f["valid"],
            f["angle"], scale_factor=kw["scale_factor"],
            n_levels=kw["n_levels"],
            min_inliers_track=kw["min_inliers_track"], fallback="skip")

    total = 0.0
    for name, fn in (("orb", orb), ("motion_track", motion),
                     ("fallback", fallback), ("local_track", local)):
        fn()                        # fixes the tensors the next stage reads
        keep = dict(cell)           # a captured stage's outputs stay alive
        r = GraphRunner(fn, "cuda")
        r.capture()
        cell.update(keep)
        ms = _replay_ms(r)
        total += ms
        print(f"[stage] {name} nodes={r.n_nodes} device_ms={ms:.3f} "
              f"us_per_node={ms * 1e3 / r.n_nodes:.3f}", flush=True)
    whole = _replay_ms(fe.runner)
    for b in range(N_BATCHES):      # back to back: the card stays loaded
        ms = _replay_ms(fe.runner, 3 * N_TIMED)
        print(f"[batch] {b} whole_step_ms={ms:.3f} sm/mem clock, pstate, "
              f"power, slowdown reasons: {_smi(_CARD_STATE)}", flush=True)
    print(f"[stage] sum_of_stages_ms={total:.3f} whole_step_ms={whole:.3f} "
          f"whole_step_nodes={fe.runner.n_nodes}",
          flush=True)

    from torch.profiler import ProfilerActivity, profile
    fe.runner.run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fe.runner.run()
        torch.cuda.synchronize()
        span_ms = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ev:
        print("[profile] the profiler recorded no device activity",
              flush=True)
        return
    busy_us = sum(e.device_time for e in ev)
    first = min(e.time_range.start for e in ev)
    last = max(e.time_range.end for e in ev)
    print(f"[profile] device_events={len(ev)} busy_ms={busy_us / 1e3:.3f} "
          f"device_span_ms={(last - first) / 1e3:.3f} "
          f"busy_share={busy_us / max(last - first, 1):.3f} "
          f"host_span_ms={span_ms:.3f}", flush=True)
    by_name: dict = {}
    for e in ev:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    for name, (n, t) in top:
        print(f"[profile] {t / 1e3:8.3f} ms {n:6d} x {name[:90]}",
              flush=True)


if __name__ == "__main__":
    main()
