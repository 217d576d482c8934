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
                inputs: the raw outputs and the filtered (idx, d0) for
                mutual in {on, off} x ratio in {1.0, 0.8}, each twice in a
                row on one workspace, must be bit-identical; a batch of 5
                searches in one launch against 5 single launches; at most 3
                device kernels per search call (torch.profiler, in one
                session after every other phase has run); the device
                time of both versions (calls queued behind a sleep kernel,
                CUDA events) and the time a caller waits for one call;
  4. main     — the 640x480 monocular sequence through
                SlamSystem.track_monocular_batch on the card, per-frame
                path: state OK, >= 90% of frames after init tracked, >= 3
                keyframes, scale-aligned ATE < 0.05, and the kernel launched
                at least once per tracked frame;
  5. graph    — one chunk of 8 frames through the CUDA-graph runner and
                through the same step function eagerly on the card, from the
                same state: integer outputs equal, poses within 1e-5; the
                graph's capture count, node count, capture and instantiate
                times; ms/frame of the replayed chunk, of the eager chunk and
                of the two replacements of the device branch around the
                brute-force fallback (always compute and select; two graphs
                around one host read);
  6. fused    — 128 frames at 640x480 through precompile() and
                track_monocular_batch(chunk=8) with fused tracking and async
                mapping: state OK, >= 90% tracked, >= 3 keyframes, scale-
                aligned ATE < 0.05 on the returned poses, on the exported
                trajectory and on the keyframe trajectory, no reset, a
                healthy mapping worker, no graph captured after warm-up, and
                the kernel launched at least twice per fused frame;
  7. reloc    — the same configuration with relocalization on
                (SlamConfig(use_fused_tracking=True, async_mapping=True,
                enable_relocalization=True), 1024 keypoints, 4096-landmark
                bundle, 4096-word vocabulary): a wider sweep is tracked
                until the map holds more keyframes than the early-loss reset
                limit, 8 uniform grey frames make the tracker lose the scene
                by itself, then the sequence resumes at an earlier
                viewpoint: LOST during the gap and no reset, OK within 3
                frames of resuming, the relocalized camera centre within
                0.05 of ground truth under the sim3 alignment fitted before
                the gap, >= 50 inliers, >= 90% tracked after recovery, no
                graph captured after warm-up, a healthy worker, the kernel
                launched in every successful relocalization; prints ms per
                attempt by stage, candidates, matches, inliers and host
                synchronisations;
  8. loop     — loop closing at full width (SlamConfig's defaults: 1024
                keypoints, 4096-landmark bundle, 4096-word vocabulary, 1024
                keyframes, LoopCloserConfig(): a loop is taken after three
                consistent detections): a camera walking 1.1 turns of a
                circle of radius 1.5 m in the middle of an 8 m square room, level, looking radially
                outward at walls that each carry their own texture (440
                frames at 640x480; synthetic.render_room_loop: the end
                revisits the start from the first pose's orientation),
                through precompile() and track_monocular_batch(chunk=8),
                with SlamConfig() (the loop closes inline: sync) and with
                SlamConfig(async_mapping=True) (on the mapping worker, the
                global BA on its own stream: async). Each run: >= 1 loop,
                0.5 < s12 < 2, n_total >= 40, > 70% of frames tracked, a
                global BA launched and applied by shutdown(), a healthy
                worker, no graph captured after warm-up; SearchBySim3 one
                batched launch and the projection top-up one launch per
                attempt, both bit-identical to the plain version on the
                run's own inputs; the first loop's S12 within 5 degrees of
                the true relative rotation; the keyframe ATE with loops
                (sync and async) below the same sequence's without. The
                room also runs without loops, sync and async, and every
                room leg's exported trajectory (frame_trajectory: what
                save_trajectory_tum writes) stays below the ATE limit;
                [loop-ate-room] prints each leg's exported ATE, its RMSE
                by quarter of the walk and its ratio to the keyframe ATE.
                One input, one result: two fresh systems walk the sync
                leg without loops over its first 160 frames, each in one
                call of track_monocular_batch; their returned poses,
                keyframe count and keyframe poses must be bit-identical
                ([loop-repro-room] prints the first differing frame).
                Then
                test_loop_closure_improves_ate's noisy orbit at that test's
                size, loops on and off (>= 1 loop; ATE reported). Prints
                the loop's stage times, the global BA's device time and the
                tracking thread's ms/frame while a loop or a global BA is
                in flight;
  9. default  — exactly bench.py's configuration, SlamConfig(
                async_mapping=True), loop closing and relocalization on,
                on phase 6's sweep with phase 6's gates; ms/frame beside
                phase 6's and the worker's loop-stage ms per keyframe;
 10. depth    — (phases 10, 11 and 12 run in a process of their own
                beside phase 8 when it runs: 8, 10 and 11 wait on the
                host, and no gate of 10, 11 or 12 reads a time; the lines
                of all four then carry contended_with=, and the timing
                line contended=: their times were taken while the other
                process shared the card and the host) the depth sensors
                at full width (1024 keypoints, 4096-landmark bundle, 1024
                keyframe slots; fx = fy = 500, bf = 50: a 0.1 m
                baseline), per-frame tracking with every other
                default (loop closing with the scale fixed, relocalization):
                SlamConfig(sensor="STEREO") through precompile() and
                track_stereo on 60 rendered pairs (motion 0.4), and
                SlamConfig(sensor="RGBD") through track_rgbd on the same
                left images with the plane's depth map: tracked from frame
                0, >= 90% tracked, ATE without scale alignment < 0.05 on
                the returned and the exported trajectory, median landmark
                depth 2-4 m, no reset, two kernel launches per tracked
                frame (one where no velocity exists yet); stage ms (the
                feature stage as the run records it, tracking, keyframe
                events, loop stage; ORB, stereo match and subpixel
                refinement timed apart, each synchronised, on five of the
                run's pairs) and peak memory. Then the stereo path
                on a camera circling a plane (the first 90 of a 120-pair
                circle): the same gates and >= 3 keyframes, each after the
                first seeding depth landmarks; its map saved, loaded into
                a fresh system in localization mode and 20 frames of the
                circle tracked again
                from its middle: relocalized within 3 frames, >= 90%
                tracked after, ATE < 0.05, no keyframe or landmark added.
                Then tests/test_localization_vo.py's RGB-D scene (the VO
                regime engages, >= half the mid-stretch tracked, the map
                re-acquired) and an RGB-D sweep at MapConfig(
                max_keyframes=16) that creates more keyframes than slots:
                no error, a slot reused, ATE < 0.05. Every search of every
                run is held bit for bit against its plain version on the
                run's own inputs.
 11. apps     — the user's entry points, as a user calls them, on a
                dataset directory the phase writes under a temporary
                directory: the first 48 frames of phase 6's sweep
                rendered at 64 as TUM rgb/ PNGs with
                rgb.txt, groundtruth.txt and a FileStorage settings file
                (fx = fy = 500, cx = 320, cy = 240, Camera.fps 30,
                ORBextractor.nFeatures 1000: 1024 keypoints). 11a: run_eval
                tum with --gate-ate 0.05 (precompile(), chunks of 8): exit
                0, both trajectory files, no graph captured after warm-up,
                >= 2 kernel launches per fused frame; median and mean
                ms/frame. 11b: run_ar, 40 frames, a cube added at frame 30:
                one cube, its plane >= 20 inliers and its normal (R_cw n)
                within 10 degrees of the rendered plane's in the same
                ground-truth camera, 40 overlays of 502x640x3, the tracked
                dots of every 4th fused frame keypoints of that frame's
                image (1e-3 px); ms/frame, detect_plane ms and the fused
                frame's readback ms. 11c: run_multi --synthetic 2 --frames
                40: > 60 % tracked and >= 2 keyframes per sequence, each
                system's frame step captured once, two stores; aggregate
                fps. 11d: the loop-recall study at run_study's defaults on
                the card and on the CPU: ranks equal but for at most one
                query. 11e: run_eval tum-rgbd on 16 frames with the exact
                depth as 16-bit PNGs at DepthMapFactor 5000: exit 0 under
                the 0.05 m gate without scale alignment, per frame. Every
                search of every leg is held bit for bit against its plain
                version.
 12. dist     — the distributed routes (parallel/) on the card: 12a
                scaling_bench's problem at its defaults (65,536 landmarks x
                64 cameras x 16 observations, 10 LM iterations) in a group
                of one rank on NCCL and of two ranks on gloo sharing the
                card (multihost.spawn_local): ms per LM iteration, the two
                costs within 1e-4; 12b a stereo map of a walk round a
                room, its loop closed (synthetic.stereo_loop_map: 100
                keyframes on a 1.5 m circle looking outward, 16,000
                landmarks each seen by 6 consecutive keyframes, bf = 50, so
                keyframe 0 and the observed scale fix the gauge),
                saved with the port's checkpoint and loaded in every rank,
                global_bundle_adjustment single-device and dense and banded
                in both groups: the 2-shard band narrower than the map,
                banded vs dense within 5e-3 (camera translations, median
                landmark), two ranks vs one within 1e-4 on the cost and
                1e-3 m on translations and the median landmark, every
                cost finite and below the cost before, the banded layout
                keeping every observation of a live keyframe; ms per
                route and collectives per LM iteration; the
                single-device global BA run twice on the loaded map, and
                optimize_essential_graph twice on one drifted circle on
                its dense path (64 vertices) and on its PCG path (192),
                each pair bit-identical ([solver-repro]); 12c
                multihost.selftest in both groups. Each group has 300 s;
                a rank still running 30 s after its work was done on every
                rank fails the phase with its Python stacks
                ([dist-stopped-rank]). One card shows the exchange code,
                not interconnect bandwidth.

The kernel's `bound_ms` is the least time the card could take for the
timed call: the larger of its bytes (every input read once, every output
written once) over 3.35 TB/s and its operations over their peak rate — 4
float32 operations per query-keypoint pair for the window test at 67
TFLOP/s, and 8 population counts for each pair that passes the gates at 16
results per clock and SM (NVIDIA's throughput table for compute capability
9.0) on 132 SMs at the card's maximum SM clock. `bound_dense_ms` is the same
with every pair passing.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Needs no network and no JAX; exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

SHAPES = [(1024, 1024), (2048, 1024), (4096, 1024), (1000, 997)]
REPEATS = 60
QUEUED_CALLS = 10          # calls queued behind the sleep in device_ms
SLEEP_CYCLES = 200_000_000  # ~0.1 s of GPU clock: far longer than queuing them
ATE_GATE = 0.05            # tests/test_slam_image_e2e.py's image-pipeline gate
TRACKED_SHARE_GATE = 0.90
MIN_KEYFRAMES = 3
PER_FRAME_FRAMES = 40      # phase 4
FUSED_FRAMES = 128         # phase 6: 15 chunks of 8 after init
FUSED_MOTION = 0.25        # phase 6: sweep amplitude of the camera path
CHUNK = 8
GRAPH_POSE_TOL = 1e-5      # graph replay vs the same step run eagerly
MAX_WRAPPER_KERNELS = 3    # device kernels one search call may cost
BATCH = 5                  # phase 3: searches in the batched launch
RELOC_MOTION = 0.6         # phase 7: sweep amplitude (wider: more keyframes)
RELOC_FRAMES = 160         # phase 7: frames of the rendered sweep
RELOC_GAP_AT = 96          # phase 7: frames tracked before the grey gap
RELOC_GREY = 8             # phase 7: uniform grey frames (one chunk)
RELOC_BACK = 40            # phase 7: resume this many frames earlier
RELOC_CENTRE_GATE = 0.05   # phase 7: relocalized centre vs ground truth
LOOP_FRAMES = 64           # phase 8: tests/test_loop_reloc.py's orbit
LOOP_IMAGES = 440          # phase 8: frames of the rendered room loop
LOOP_TURNS = 1.1           # phase 8: the circle, then a tenth more of it
ROOM_RADIUS = 1.5          # phase 8: the circle's radius in the 8 m room
S12_TRUTH_GATE_DEG = 5.0   # phase 8: first loop's S12 vs the true rotation
REPRO_FRAMES = 160         # phase 8: the sync leg without loops, twice
_SCENES = {}               # phase 8: the room loop, rendered once
PHASE6 = {}                # phase 6's ms/frame, printed beside phase 9's
DEPTH_BF = 50.0            # phase 10: fx * baseline (0.1 m)
DEPTH_FRAMES = 60          # phase 10: rendered stereo pairs
DEPTH_MOTION = 0.4
DEPTH_PRECOMPILE_FRAMES = 8
DEPTH_LOCALIZATION_FRAMES = 20  # phase 10c: frames tracked on the loaded map
DEPTH_LOOP_FRAMES = 120    # phase 10a: the stereo circle over the plane
DEPTH_LOOP_TRACKED = 90    # phase 10a: its first frames, tracked
SLOT_CAPACITY = 16         # phase 10d: MapConfig(max_keyframes=...)
SLOT_LEG = 40              # phase 10d: frames of one sweep over the arc
SLOT_FRAMES = 160          # phase 10d: four sweeps
APPS_FRAMES = 64           # phase 11: phase 6's sweep, rendered
APPS_EVAL_FRAMES = 48      # phase 11a: its first frames, run_eval tum
APPS_AR_FRAMES = 40        # phase 11b: run_ar on the same directory
APPS_CUBE_AT = 30          # phase 11b: the frame that presses "Add Cube"
APPS_PLANE_INLIERS = 20    # phase 11b: detect_plane's min_inliers
APPS_NORMAL_GATE_DEG = 10.0
APPS_DOT_TOL_PX = 1e-3     # phase 11b: a dot is a keypoint of its image
APPS_DOT_EVERY = 4         # phase 11b: fused frames whose dots are checked
APPS_MULTI_FRAMES = 40     # phase 11c: tests/test_run_multi.py's size
APPS_MULTI_TRACKED = 0.6   # phase 11c: tests/test_run_multi.py's gate
APPS_RGBD_FRAMES = 16      # phase 11e
APPS_DEPTH_FACTOR = 5000.0  # TUM's DepthMapFactor: 16-bit PNG per meter
DIST_WORLD_TOL = 1e-4      # phase 12: world 2 vs world 1 costs, relative
DIST_WORLD_POS_TOL = 1e-3  # phase 12: world 2 vs world 1 translations and
#                            median landmark, metres: the float32 LM's floor
#                            on a 100-camera map is ~1e-4 (PERF.md §6)
BAND_TOL = 5e-3            # phase 12: banded vs dense (tests/test_partition)
DIST_SPAWN_LIMIT_S = 300   # phase 12: each group's time, start-up included
DIST_CAM_KW = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0,
                   width=640, height=480)   # phase 12's stereo map
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12
N_SM = 132
POPC_PER_CLK_SM = 16


START = time.perf_counter()


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


CONTENDED = []             # phases running meanwhile in another process


def phase(tag, **numbers):
    """Print one phase line; while another process runs phases beside
    this one, the line says so: its times share the card and the host."""
    if CONTENDED:
        numbers["contended_with"] = "phases" + ",".join(map(str, CONTENDED))
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


def device_kernels(torch, fns):
    """The device kernels each call in `fns` launches, by torch.profiler:
    a list of {name: (count, us)}. ONE profiler session covers all the
    calls (a third session in a process recorded nothing on this stack);
    a marker kernel before each call and after the last splits the device
    events, which one stream runs in launch order. The session opens with
    one more marker, finished before the calls start: the session's first
    device event has been seen missing from the trace on the card, and it
    is that marker's place to lose."""
    from torch.profiler import ProfilerActivity, profile
    for fn in fns:
        fn()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for fn in fns:
            torch.cuda._sleep(1000)
            fn()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA),
                key=lambda e: e.time_range.start)
    if not ev:
        fail("the profiler recorded no device activity")
    marker = ev[0].name
    n_markers = sum(1 for e in ev if e.name == marker)
    if n_markers == len(fns) + 2:
        ev = ev[1:]                     # the opening marker was recorded
    elif n_markers != len(fns) + 1:
        fail(f"profiler: {len(fns) + 1} markers expected after the opening "
             f"one, device events: {[e.name for e in ev]}")
    out = []
    for e in ev:
        if e.name == marker:
            out.append({})
        else:
            n, t = out[-1].get(e.name, (0, 0.0))
            out[-1][e.name] = (n + 1, t + e.device_time)
    return out[:len(fns)]


def batched_inputs(torch, CH, n, m, n_batch, seed):
    """One packed query descriptor set against n_batch keypoint sets, each
    with its own query geometry (the fuse's shape)."""
    items = [make_inputs(torch, n, m, b % 2 == 1, seed + b)
             for b in range(n_batch)]
    keys = list(items[0])
    args = [CH.H.packed_from_signs(items[0]["q_signs"])]
    for k in keys[1:]:
        t = torch.stack([it[k] for it in items])
        args.append(CH.H.packed_from_signs(t) if k == "kp_signs" else t)
    return args


def check_kernel(torch, CH):
    """Phase 3. Returns the kernel record for the JSON line."""
    from ar_orbslam2_tpu_torch.matching import matcher
    worst = 0
    timings = {}
    profiled = {}           # tag -> a search call, profiled in one session

    def gap(a, b):
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    for n, m in SHAPES:
        for ties in (False, True):
            x = make_inputs(torch, n, m, ties, seed=n + m + ties)
            args = tuple(x.values())
            got = CH.top2_cuda(*args)
            want = CH.top2_reference(*args)
            torch.cuda.synchronize()
            names = ("idx0", "d0", "d1", "kp_best_d", "kp_best_q")
            for name, a, b in zip(names, got, want):
                err = gap(a, b)
                worst = max(worst, err)
                if err:
                    fail(f"kernel != plain at {(n, m)} ties={ties}: {name} "
                         f"differs in {int((a != b).sum())} entries")
            n_match = 0
            for mutual in (False, True):
                for ratio in (1.0, 0.8):
                    want = CH.fused_windowed_top2_reference(
                        *args, th=100, nn_ratio=ratio, mutual=mutual)
                    # twice in a row: the first call must leave the
                    # workspace as it found it
                    for call in (1, 2):
                        got = CH.fused_windowed_top2(
                            *args, th=100, nn_ratio=ratio, mutual=mutual)
                        torch.cuda.synchronize()
                        for name, a, b in zip(("idx", "d0"), got, want):
                            worst = max(worst, gap(a, b))
                            if not torch.equal(a, b):
                                fail(f"filtered {name} differs at {(n, m)} "
                                     f"ties={ties} mutual={mutual} "
                                     f"nn_ratio={ratio} call={call}")
                    n_match = int((got[0] >= 0).sum())
            phase("kernel-check", shape=f"{n}x{m}", ties=ties,
                  raw_bit_identical=True, filtered_bit_identical=True,
                  filters="mutual{F,T}xratio{1.0,0.8}x2calls",
                  matches=n_match)
        x = make_inputs(torch, n, m, False, seed=7)
        args = tuple(x.values())
        # the main path hands the kernel packed descriptors (Frame /
        # MapStore keep them so); time it that way
        pk = list(args)
        pk[0] = CH.H.packed_from_signs(args[0])
        pk[6] = CH.H.packed_from_signs(args[6])
        fns = {"raw": lambda: CH.top2_cuda(*pk),
               "plain": lambda: CH.top2_reference(*pk),
               "wrapper": lambda: CH.fused_windowed_top2(*pk),
               "wrapper_not_mutual": lambda: CH.fused_windowed_top2(
                   *pk, mutual=False),
               "plain_wrapper": lambda: CH.fused_windowed_top2_reference(
                   *pk)}
        dev = {k: device_ms(torch, f) for k, f in fns.items()}
        wall = {k: median_ms(torch, fns[k])
                for k in ("wrapper", "plain_wrapper")}
        timings[(n, m)] = (dev["wrapper"], dev["plain_wrapper"])
        profiled[f"{n}x{m}"] = fns["wrapper"]
        if (n, m) == (4096, 1024):
            timings["raw"] = dev["raw"]
        phase("kernel-time", shape=f"{n}x{m}",
              **{f"{k}_device_ms": f"{v:.4f}" for k, v in dev.items()},
              **{f"{k}_call_ms": f"{v:.4f}" for k, v in wall.items()},
              device_repeats=f"9x{QUEUED_CALLS}", call_repeats=REPEATS)

    # the matcher's entry with a scalar radius and no octave gate: no
    # constant tensors around the launch
    x = make_inputs(torch, 1024, 1024, False, seed=7)
    q_packed = CH.H.packed_from_signs(x["q_signs"])
    k_packed = CH.H.packed_from_signs(x["kp_signs"])

    def scalar_call():
        return matcher.windowed_match(
            x["q_uv"], q_packed, x["q_valid"], 30.0, x["kp_uv"], k_packed,
            x["kp_octave"], x["kp_valid"], th=50, nn_ratio=0.9)
    got = scalar_call()
    want = CH.fused_windowed_top2_reference(
        q_packed, x["q_uv"], 30.0, None, None, x["q_valid"], k_packed,
        x["kp_uv"], x["kp_octave"], x["kp_valid"], th=50, nn_ratio=0.9)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        fail("scalar-radius / ungated search differs from the plain version")
    profiled["scalar_radius_ungated_1024x1024"] = scalar_call

    # a batch: one launch against B single launches and the plain version
    bargs = batched_inputs(torch, CH, 4096, 1024, BATCH, seed=90)
    before = CH.fused_windowed_top2.launches
    got = CH.fused_windowed_top2(*bargs, th=50, nn_ratio=1.0)
    raw = CH.top2_cuda(*bargs)
    torch.cuda.synchronize()
    if CH.fused_windowed_top2.launches != before + 2:
        fail("a batched call is not one launch")
    singles = []
    for b in range(BATCH):
        item = CH._item(bargs, b)
        single = CH.fused_windowed_top2(*item, th=50, nn_ratio=1.0)
        want = CH.fused_windowed_top2_reference(*item, th=50, nn_ratio=1.0)
        raw_want = CH.top2_reference(*item)
        torch.cuda.synchronize()
        singles.append(item)
        for g, s_, w in zip(got, single, want):
            worst = max(worst, gap(g[b], w))
            if not (torch.equal(g[b], s_) and torch.equal(s_, w)):
                fail(f"batched search: item {b} differs")
        for g, w in zip(raw, raw_want):
            if not torch.equal(g[b], w):
                fail(f"batched raw search: item {b} differs")
    batch_ms = device_ms(torch, lambda: CH.fused_windowed_top2(
        *bargs, th=50, nn_ratio=1.0))
    singles_ms = device_ms(torch, lambda: [CH.fused_windowed_top2(
        *item, th=50, nn_ratio=1.0) for item in singles])
    phase("kernel-batch", shape=f"{BATCH}x4096x1024", bit_identical=True,
          one_launch_device_ms=f"{batch_ms:.4f}",
          single_launches_device_ms=f"{singles_ms:.4f}")
    profiled[f"batch_{BATCH}x4096x1024"] = lambda: CH.fused_windowed_top2(
        *bargs, th=50, nn_ratio=1.0)

    ms, plain = timings[(4096, 1024)]
    bound = kernel_bound(torch, make_inputs(torch, 4096, 1024, False, seed=7))
    phase("kernel-bound", shape="4096x1024", **bound)
    return profiled, dict(name="hamming_search", route="cuda",
                source="ar_orbslam2_tpu_torch/csrc/cuda_hamming.cu",
                replaces="ar_orbslam2_tpu/ops/pallas_hamming.py:39",
                launches=None, max_abs_err=worst, ms=ms, plain_ms=plain,
                bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                bound_dense_ms=bound["bound_dense_ms"],
                gate_density=bound["gate_density"],
                sm_clock_mhz=bound["sm_clock_mhz"],
                library_ms=None,    # no single PyTorch call computes this
                raw_ms=timings["raw"],
                kernel_us_profiler=None,        # set by profile_searches
                device_kernels_per_call=None,   # set by profile_searches
                batch_ms=batch_ms, batch_singles_ms=singles_ms,
                timed="device ms per fused_windowed_top2 call at 4096x1024,"
                      " packed descriptors: one launch (search + threshold +"
                      " ratio + mutual-best); raw_ms is the launch with raw"
                      " outputs (top2_cuda); batch_ms one launch of"
                      f" {BATCH} searches, batch_singles_ms {BATCH} launches")


def profile_searches(torch, profiled, rec):
    """Phase 3's last check, run after every other phase: device kernels
    per search call, the launch and nothing around it. (Once a profiler
    session has run in a process, launching a 47,850-node graph costs the
    host tens of ms, which would falsify the phases that time replays.)"""
    for tag, kernels in zip(profiled, device_kernels(
            torch, list(profiled.values()))):
        n_kernels = sum(c for c, _ in kernels.values())
        ours = [v for k, v in kernels.items() if "hamming_search" in k]
        if len(ours) != 1 or ours[0][0] != 1:
            fail(f"{tag}: a search call did not launch the kernel once: "
                 f"{kernels}")
        if n_kernels > MAX_WRAPPER_KERNELS:
            fail(f"{tag}: a search call is {n_kernels} device kernels "
                 f"(> {MAX_WRAPPER_KERNELS}): {sorted(kernels)}")
        if tag == "4096x1024":
            rec["kernel_us_profiler"] = ours[0][1]
            rec["device_kernels_per_call"] = n_kernels
        phase("kernel-profile", call=tag, device_kernels=n_kernels,
              kernel_us=f"{ours[0][1]:.2f}")


def sm_clock_mhz(which="clocks.max.sm"):
    """The card's maximum SM clock, or with "clocks.sm" the clock it runs at
    now (read while work is queued: a step of dependent tiny kernels follows
    the clock, and the card does not always sit at its maximum)."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={which}",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi {which} failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0])


def kernel_bound(torch, x):
    """The least time the card could take for one windowed top-2 call on
    the inputs `x` (see the module docstring)."""
    n, m = x["q_uv"].shape[0], x["kp_uv"].shape[0]
    in_bytes = (n * (32 + 8 + 4 + 4 + 4 + 1) + m * (32 + 8 + 4 + 1))
    out_bytes = 2 * n * 4           # idx and d0
    du = (x["q_uv"][:, None, 0] - x["kp_uv"][None, :, 0]).abs()
    dv = (x["q_uv"][:, None, 1] - x["kp_uv"][None, :, 1]).abs()
    r = x["q_radius"][:, None]
    gate = (du <= r) & (dv <= r)
    gate &= (x["kp_octave"][None, :] >= x["q_olo"][:, None]) \
        & (x["kp_octave"][None, :] <= x["q_ohi"][:, None])
    gate &= x["q_valid"][:, None] & x["kp_valid"][None, :]
    passed = int(gate.sum())
    clock = sm_clock_mhz()
    popc_rate = POPC_PER_CLK_SM * N_SM * clock * 1e6

    def ops_ms(pairs_popc):
        return (n * m * 4 / FP32_FLOPS + pairs_popc * 8 / popc_rate) * 1e3
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops = ops_ms(passed)
    return dict(bound_ms=max(bytes_ms, ops),
                bound_by="bytes" if bytes_ms > ops else "operations",
                bytes_ms=bytes_ms, ops_ms=ops,
                bound_dense_ms=max(bytes_ms, ops_ms(n * m)),
                gate_density=passed / (n * m), sm_clock_mhz=clock)


CAM_KW = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)


def make_sequence(n_frames, motion=0.25):
    """The bench scene: a textured plane rendered at 640x480."""
    from ar_orbslam2_tpu_torch.core.camera import Camera
    from ar_orbslam2_tpu_torch.data import synthetic
    cam = Camera(**CAM_KW)
    imgs, R_cw, t_cw = synthetic.render_plane_sequence(
        cam, n_frames=n_frames, seed=0, motion=motion)
    return cam, list(imgs), R_cw, t_cw


def trajectory_numbers(slam, poses, R_cw, t_cw):
    """(init frame, tracked flags after init, online ATE, exported ATE,
    keyframe ATE).

    The online ATE is over the poses track_monocular_batch returned, each
    in the map frame of its moment; the exported ATE is over
    SlamSystem.frame_trajectory(), the trajectory the system saves: every
    frame re-composed against the final pose of its reference keyframe
    (System::SaveTrajectoryTUM); the keyframe ATE is over the keyframe
    trajectory after BA, the quality of the map."""
    import numpy as np

    from ar_orbslam2_tpu_torch.eval.ate import ate_rmse
    ok = [p is not None for p in poses]
    if not any(ok):
        return None, [], float("nan"), float("nan"), float("nan")
    init = ok.index(True)
    gt_c = -(np.swapaxes(R_cw, -1, -2) @ t_cw[..., None])[..., 0]
    est = np.array([-(p[:3, :3].T @ p[:3, 3]) for p in poses if p is not None])
    gt = np.array([gt_c[i] for i, p in enumerate(poses) if p is not None])
    online = float(ate_rmse(est, gt, with_scale=True))
    ts, _, t_wc = slam.frame_trajectory()
    idx = np.round(np.asarray(ts) * 30.0).astype(int)
    exported = float(ate_rmse(t_wc, gt_c[idx], with_scale=True))
    ts_k, _, t_k = slam.keyframe_trajectory()
    idx_k = np.round(np.asarray(ts_k) * 30.0).astype(int)
    keyframes = float(ate_rmse(t_k, gt_c[idx_k], with_scale=True))
    return init, ok[init + 1:], online, exported, keyframes


def exported_error_where(slam, R_cw, t_cw, n_seg=4):
    """Where the exported trajectory's error lies: the RMSE of each of
    `n_seg` equal spans of source frames and the worst frame, under the
    one sim3 alignment of the whole exported trajectory."""
    import numpy as np

    from ar_orbslam2_tpu_torch.eval.ate import align_umeyama
    gt_c = -(np.swapaxes(R_cw, -1, -2) @ t_cw[..., None])[..., 0]
    ts, _, t_wc = slam.frame_trajectory()
    idx = np.round(np.asarray(ts) * 30.0).astype(int)
    s, R, t = align_umeyama(t_wc, gt_c[idx])
    err = np.linalg.norm(s * np.asarray(t_wc, np.float64) @ R.T + t
                         - gt_c[idx], axis=1)
    edges = np.linspace(0, len(gt_c), n_seg + 1)
    seg = [err[(idx >= a) & (idx < b)] for a, b in zip(edges, edges[1:])]
    return ("/".join(f"{np.sqrt((e ** 2).mean()):.4f}" if len(e) else "none"
                     for e in seg),
            f"{int(idx[np.argmax(err)])}:{err.max():.4f}")


def trajectory_gates(tag, slam, after, ate, ate_name="ATE"):
    if not after:
        fail(f"{tag}: never initialised")
    share = sum(after) / len(after)
    n_kf = slam.store.n_keyframes()
    if slam.tracking.state != "OK":
        fail(f"{tag}: final state {slam.tracking.state}")
    if share < TRACKED_SHARE_GATE:
        fail(f"{tag}: tracked share {share:.3f} < {TRACKED_SHARE_GATE}")
    if n_kf < MIN_KEYFRAMES:
        fail(f"{tag}: {n_kf} keyframes < {MIN_KEYFRAMES}")
    if not ate < ATE_GATE:
        fail(f"{tag}: {ate_name} {ate:.4f} >= {ATE_GATE}")


def percentile(values, q):
    v = sorted(values)
    return v[min(int(q * len(v)), len(v) - 1)]


def run_main_path(torch, CH):
    """Phase 4: the per-frame main path on the card."""
    from ar_orbslam2_tpu_torch.system.slam import SlamConfig, SlamSystem

    n_frames = PER_FRAME_FRAMES
    cam, imgs, R_cw, t_cw = make_sequence(n_frames)
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
        imgs, timestamps=[i / 30.0 for i in range(n_frames)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = CH.fused_windowed_top2.launches
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    slam.shutdown()

    init, after, ate, ate_exp, ate_kf = trajectory_numbers(
        slam, poses, R_cw, t_cw)
    steady = frame_ms[(init or 0) + 1:]
    phase("main-path", frames=n_frames, init_frame=init,
          tracked_after_init=f"{sum(after)}/{len(after)}",
          state=slam.tracking.state, keyframes=slam.store.n_keyframes(),
          map_points=slam.store.n_map_points(),
          ate=f"{ate:.5f}", ate_exported=f"{ate_exp:.5f}",
          ate_keyframes=f"{ate_kf:.5f}",
          ms_per_frame_median=f"{percentile(steady, 0.5):.2f}",
          ms_per_frame_p90=f"{percentile(steady, 0.9):.2f}",
          wall_s=f"{wall:.2f}", kernel_launches=launches,
          launches_per_tracked_frame=f"{launches / max(sum(after), 1):.2f}",
          peak_device_mib=f"{peak_mib:.1f}")
    trajectory_gates("main-path", slam, after, ate)
    if launches < sum(after):
        fail(f"{launches} kernel launches < {sum(after)} tracked frames")
    return launches


def fused_config(async_mapping):
    from ar_orbslam2_tpu_torch.system.slam import SlamConfig
    return SlamConfig(use_fused_tracking=True, async_mapping=async_mapping,
                      enable_loop_closing=False, enable_relocalization=False)


def host_branch_step(torch, fe):
    """The alternative to "always compute the fallback and select": graph
    A (extraction + motion-model track), one host read of motion_ok, then
    graph B with the fallback run or skipped. Built from the package's own
    megastep halves, for measurement only. Returns (step function giving
    the frame's record, the three graph runners)."""
    from ar_orbslam2_tpu_torch.frontend.orb import extract_orb
    from ar_orbslam2_tpu_torch.system import fused as F
    from ar_orbslam2_tpu_torch.system.graph import GraphRunner
    cell, kw = {}, fe._step_kw

    @torch.no_grad()
    def part_a():
        f = extract_orb(fe._img_in, fe.orb_cfg)
        mid = F._megastep_motion(
            fe.cam, fe.state, f["uv"], f["desc_bits"], f["octave"],
            f["valid"], min_track_matches=kw["min_track_matches"],
            min_inliers_track=kw["min_inliers_track"],
            undistort=kw["undistort"])
        if not cell:                    # the first call fixes the buffers
            cell["f"] = {k: torch.empty_like(v) for k, v in f.items()}
            cell["mid"] = {k: torch.empty_like(v) for k, v in mid.items()}
        for k, v in f.items():
            cell["f"][k].copy_(v)
        for k, v in mid.items():
            cell["mid"][k].copy_(v)

    def part_b(mode):
        @torch.no_grad()
        def run():
            f = cell["f"]
            new, rec = F._megastep_rest(
                fe.cam, fe.state, cell["mid"], f["desc_bits"], f["octave"],
                f["valid"], f["angle"], scale_factor=kw["scale_factor"],
                n_levels=kw["n_levels"],
                min_inliers_track=kw["min_inliers_track"], fallback=mode)
            fe._commit(new, rec)
        return run

    part_a()                            # allocate the hand-over buffers
    restore = fe.runner.restore
    a = GraphRunner(part_a, "cuda")
    b_run = GraphRunner(part_b("run"), "cuda", restore=restore)
    b_skip = GraphRunner(part_b("skip"), "cuda", restore=restore)
    for r in (a, b_run, b_skip):
        r.capture()

    def step():
        a.run()
        ok = bool(cell["mid"]["motion_ok"].cpu())       # the host read
        (b_skip if ok else b_run).run()
        return fe.read_record()
    return step, (a, b_run, b_skip)


def run_graph_check(torch, CH):
    """Phase 5: graph replay against the same step run eagerly."""
    import numpy as np

    from ar_orbslam2_tpu_torch.system import fused as F
    from ar_orbslam2_tpu_torch.system.slam import SlamSystem

    cam, imgs, _, _ = make_sequence(12 + 3 * CHUNK)
    slam = SlamSystem(cam, fused_config(False), device="cuda")
    fe = slam.tracking.fused
    n = 0
    while n < 12:                 # init + a few fused per-frame steps
        slam.track_monocular(imgs[n], timestamp=n / 30.0)
        n += 1
    if slam.tracking.state != "OK" or fe.state is None:
        fail("graph check: the system did not reach the fused state")
    if fe.runner.captures != 1 or fe.runner.launches_per_replay < 2:
        fail(f"graph check: {fe.runner.captures} captures, "
             f"{fe.runner.launches_per_replay} kernel launches per replay")
    r = fe.runner
    phase("graph", captures=r.captures, nodes=r.n_nodes,
          warmup_s=f"{r.warmup_s:.3f}", capture_s=f"{r.capture_s:.3f}",
          instantiate_s=f"{r.instantiate_s:.3f}",
          kernel_launches_per_replay=r.launches_per_replay)
    if not r.n_nodes:
        fail("graph check: no node counted in the graph's dump")

    torch.cuda.synchronize()
    start = {k: v.clone() for k, v in fe.state.items()}
    stack = np.stack(imgs[n:n + CHUNK])

    def restore():
        for k, v in start.items():
            fe.state[k].copy_(v)

    def timed_ms(fn, repeats=3):
        out, times = None, []
        for _ in range(repeats):
            restore()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / CHUNK)
        return out, sorted(times)[len(times) // 2]

    # graph: dispatch + collect (one upload, 8 replays, one readback)
    before = CH.fused_windowed_top2.launches
    recs_g, graph_ms = timed_ms(lambda: fe.step_chunk(stack))
    replayed = (CH.fused_windowed_top2.launches - before) // 3
    snaps_g = {k: v.clone() for k, v in fe._chunk_snaps.items()}
    state_g = {k: v.clone() for k, v in fe.state.items()}
    # eager: the same step function on the card, no graph
    kw = dict(fe._step_kw)
    imgs_dev = torch.as_tensor(stack, device="cuda")

    def eager():
        return F.track_chunk(cam, fe.orb_cfg, dict(start), imgs_dev, **kw)
    (state_e, recs_e, snaps_e), eager_ms = timed_ms(eager, repeats=1)

    worst = 0.0
    for k in F._REC_INTS:
        a = np.asarray(recs_g[k]).astype(np.int64)
        b = recs_e[k].cpu().numpy().astype(np.int64)
        if not np.array_equal(a, b):
            fail(f"graph != eager: record {k}: {a.tolist()} vs {b.tolist()}")
    for k in ("R", "t"):
        worst = max(worst, float(np.abs(
            recs_g[k] - recs_e[k].cpu().numpy()).max()))
    for k in ("slot", "oct", "valid", "uv", "desc"):
        if not torch.equal(snaps_g[k], snaps_e[k]):
            fail(f"graph != eager: snapshot {k}")
    for k in ("acc_visible", "acc_found", "prev_slot", "have_vel"):
        if not torch.equal(state_g[k], state_e[k]):
            fail(f"graph != eager: state {k}")
    if worst > GRAPH_POSE_TOL:
        fail(f"graph != eager: pose gap {worst:.3g} > {GRAPH_POSE_TOL}")
    if min(int(v) for v in recs_g["n_inliers"]) < 30:
        fail("graph check: the chunk did not track")
    # no wait inside a dispatch: behind a sleep kernel the host must get
    # through the whole dispatch before the device reaches its first work
    restore()
    torch.cuda.synchronize()
    torch.cuda._sleep(3 * SLEEP_CYCLES)
    reached = torch.cuda.Event()
    reached.record()
    t0 = time.perf_counter()
    handle = fe.dispatch_chunk(stack)
    dispatch_ms = (time.perf_counter() - t0) * 1e3
    if reached.query():
        fail("dispatch_chunk waited for the device (or took the host "
             f"longer than the sleep: {dispatch_ms:.1f} ms)")
    clock_now = sm_clock_mhz("clocks.sm")       # while the chunk runs
    fe.collect_chunk(handle)
    phase("graph-vs-eager", frames=CHUNK, integers_equal=True,
          dispatch_waits_for_device=False,
          dispatch_host_ms=f"{dispatch_ms:.2f}",
          pose_max_abs_gap=f"{worst:.3g}", tol=GRAPH_POSE_TOL,
          kernel_launches_per_chunk=replayed,
          graph_chunk_ms_per_frame=f"{graph_ms:.2f}",
          eager_chunk_ms_per_frame=f"{eager_ms:.2f}",
          sm_clock_mhz=clock_now, captures=fe.n_captures)

    # the two replacements of the device branch, per frame with one
    # readback each (the host-branch variant cannot run a chunk unsynced)
    host_step, host_runners = host_branch_step(torch, fe)

    def per_frame(one):
        def run():
            out = []
            for img in stack:
                fe.extract(img)
                out.append(one())
            return out
        return run
    sel, sel_ms = timed_ms(per_frame(fe.step))
    host, host_ms = timed_ms(per_frame(host_step))
    for a, b in zip(sel, host):
        for k in F._REC_INTS:
            if int(a[k]) != int(b[k]):
                fail(f"host-branch != select: record {k}")
    n_fb = sum(1 for a in sel if not a["motion_ok"])
    captures = fe.n_captures + sum(x.captures for x in host_runners)
    phase("fallback-variants", frames=CHUNK, fallback_frames=n_fb,
          select_ms_per_frame=f"{sel_ms:.2f}",
          host_branch_ms_per_frame=f"{host_ms:.2f}",
          host_branch_nodes="+".join(str(x.n_nodes) for x in host_runners),
          records_equal=True, captures=captures)
    if captures != 4:
        fail(f"graph check: {captures} captures, expected 4")
    slam.shutdown()
    return dict(nodes=r.n_nodes, graph_ms=graph_ms, eager_ms=eager_ms)


def timeline(metrics):
    """Compact per-frame trace of a run, for a failed gate's report."""
    rows = []
    for r in metrics:
        kind = "C" if r.get("chunked") else ("F" if r.get("fused") else "-")
        tag = ""
        if "t_kf_ms" in r:
            tag = " KF-hard" if r.get("kf_hard") else " KF"
        rows.append(f"{r['frame_id']}:{r['state'][0]}{kind}"
                    f"{r['n_inliers']}/{r.get('local_visible', 0)}"
                    f"k{r['n_kf']}{tag}")
    return " ".join(rows)


def run_fused_path(torch, CH):
    """Phase 6: the fused, chunked, pipelined main path at full width."""
    from ar_orbslam2_tpu_torch.system.slam import SlamSystem

    n_frames = FUSED_FRAMES
    cam, imgs, R_cw, t_cw = make_sequence(n_frames, FUSED_MOTION)
    slam = SlamSystem(cam, fused_config(True), device="cuda")
    t0 = time.perf_counter()
    slam.precompile()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    fe = slam.tracking.fused
    phase("fused-precompile", seconds=f"{warm_s:.2f}",
          captures=slam.n_captures,
          capture_s=f"{fe.runner.capture_s:.3f}",
          instantiate_s=f"{fe.runner.instantiate_s:.3f}")

    collected = []                  # host time at each chunk's readback
    clocks = []                     # SM clock, sampled while chunks run
    collect = fe.collect_chunk

    def stamped(handle):
        out = collect(handle)
        collected.append(time.perf_counter())
        if len(collected) % 4 == 0:     # the next chunk is in flight
            clocks.append(sm_clock_mhz("clocks.sm"))
        return out
    fe.collect_chunk = stamped

    torch.cuda.reset_peak_memory_stats()
    CH.fused_windowed_top2.launches = 0
    replays0 = fe.runner.replays
    t0 = time.perf_counter()
    poses = slam.track_monocular_batch(
        imgs, timestamps=[i / 30.0 for i in range(n_frames)], chunk=CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = CH.fused_windowed_top2.launches
    replays = fe.runner.replays - replays0
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    slam.shutdown()                 # joins the worker; raises what it died of

    init, after, ate, ate_exp, ate_kf = trajectory_numbers(
        slam, poses, R_cw, t_cw)
    t, am = slam.tracking, slam.tracking.async_mapper
    m = t.metrics
    chunked = sum(1 for r in m if r.get("chunked"))
    fused = sum(1 for r in m if r.get("fused"))
    events = [r for r in m if "t_kf_ms" in r]
    hard = sum(1 for r in events if r.get("kf_hard"))
    soft = sum(1 for r in events if r.get("kf_hard") is False)
    kf_ms = [r["t_kf_ms"] for r in events]
    # a chunk's period: the time between successive readbacks, per frame
    periods = [(b - a) * 1e3 / CHUNK
               for a, b in zip(collected, collected[1:])] or [float("nan")]
    PHASE6.update(median=f"{percentile(periods, 0.5):.2f}",
                  p90=f"{percentile(periods, 0.9):.2f}")
    phase("fused-path", frames=n_frames, init_frame=init,
          tracked_after_init=f"{sum(after)}/{len(after)}",
          state=t.state, keyframes=slam.store.n_keyframes(),
          map_points=slam.store.n_map_points(),
          ate_keyframes=f"{ate_kf:.5f}", ate_exported=f"{ate_exp:.5f}",
          ate_online=f"{ate:.5f}",
          resets=t.n_resets, chunks=len(collected),
          frames_in_chunks=chunked, frames_per_frame_fused=fused - chunked,
          frames_per_frame_other=len(m) - fused,
          ms_per_frame_median=f"{percentile(periods, 0.5):.2f}",
          ms_per_frame_p90=f"{percentile(periods, 0.9):.2f}",
          wall_s=f"{wall:.2f}",
          wall_ms_per_frame=f"{wall * 1e3 / n_frames:.2f}",
          sm_clock_mhz="/".join(f"{c:.0f}" for c in clocks) or "none",
          soft_keyframes=soft, hard_keyframes=hard,
          other_keyframe_events=len(events) - soft - hard,
          keyframe_event_ms_median=(
              f"{percentile(kf_ms, 0.5):.2f}" if kf_ms else "none"),
          worker_processed=am.n_processed, worker_error=am.error,
          captures_after_warmup=slam.captures_after_warmup,
          graph_replays=replays, kernel_launches=launches,
          launches_per_fused_frame=f"{launches / max(fused, 1):.2f}",
          peak_device_mib=f"{peak_mib:.1f}")
    print(f"[fused-timeline] {timeline(m)}", flush=True)
    # With async mapping a chunk tracks against a bundle snapshot up to two
    # chunks old, so the returned poses lag the map; all three trajectories
    # are still held to the one bound.
    trajectory_gates("fused-path", slam, after, ate_kf, "keyframe ATE")
    for name, value in (("online", ate), ("exported", ate_exp)):
        if not value < ATE_GATE:
            fail(f"fused-path: {name} ATE {value:.4f} >= {ATE_GATE}")
    if len(collected) < 10:
        fail(f"fused-path: only {len(collected)} chunks ran")
    if t.n_resets != 0:
        fail(f"fused-path: {t.n_resets} resets")
    if am.error is not None or am.n_processed < 1:
        fail(f"fused-path: worker error={am.error!r} "
             f"processed={am.n_processed}")
    if slam.captures_after_warmup != 0:
        fail(f"fused-path: {slam.captures_after_warmup} graph captures "
             "after warm-up")
    if replays < chunked or launches < 2 * fused:
        fail(f"fused-path: {replays} replays, {launches} kernel launches "
             f"for {fused} fused frames")
    return launches


def reloc_config():
    from ar_orbslam2_tpu_torch.system.slam import SlamConfig
    return SlamConfig(use_fused_tracking=True, async_mapping=True,
                      enable_loop_closing=False, enable_relocalization=True)


def run_reloc_path(torch, CH):
    """Phase 7: the tracker loses the scene by itself (grey frames), then
    relocalizes at an earlier viewpoint of the sequence, at full width."""
    import numpy as np

    from ar_orbslam2_tpu_torch.eval.ate import align_umeyama
    from ar_orbslam2_tpu_torch.system.slam import SlamSystem

    motion, frames, gap_at = RELOC_MOTION, RELOC_FRAMES, RELOC_GAP_AT
    cam, imgs, R_cw, t_cw = make_sequence(frames, motion)
    grey = np.full_like(imgs[0], 128)
    resume = gap_at - RELOC_BACK
    # source frame of every fed image (-1: grey)
    src = list(range(gap_at)) + [-1] * RELOC_GREY \
        + list(range(resume, frames))
    feed = [grey if i < 0 else imgs[i] for i in src]
    slam = SlamSystem(cam, reloc_config(), device="cuda")
    t, rel = slam.tracking, slam.tracking.relocalizer
    limit = t.cfg.reset_if_lost_before_kfs
    t0 = time.perf_counter()
    slam.precompile()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    attempts = []                   # (fed index, stats, launches, ms)
    relocalize = rel.relocalize

    def watched(frame):
        torch.cuda.synchronize()
        before = CH.fused_windowed_top2.launches
        t1 = time.perf_counter()
        out = relocalize(frame)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        attempts.append((frame.frame_id, dict(rel.last_stats),
                         CH.fused_windowed_top2.launches - before, ms))
        return out
    rel.relocalize = watched

    torch.cuda.reset_peak_memory_stats()
    CH.fused_windowed_top2.launches = 0
    t0 = time.perf_counter()
    poses = slam.track_monocular_batch(
        feed, timestamps=[i / 30.0 for i in range(len(feed))], chunk=CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = CH.fused_windowed_top2.launches
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    slam.shutdown()
    am = t.async_mapper

    m = t.metrics
    by_fid = {r["frame_id"]: r for r in m}
    n_kf_at_gap = max((r["n_kf"] for r in m if r["frame_id"] < gap_at),
                      default=0)
    gap_ids = range(gap_at, gap_at + RELOC_GREY)
    gap_states = [by_fid[i]["state"] if i in by_fid else "?" for i in gap_ids]
    after_ids = list(range(gap_at + RELOC_GREY, len(feed)))
    ok_after = [poses[i] is not None for i in after_ids]
    first_ok = ok_after.index(True) if any(ok_after) else None
    good = [a for a in attempts if a[1].get("ok")]
    failed_ms = [a[3] for a in attempts if not a[1].get("ok")]

    # sim3 alignment of the returned poses before the gap
    gt_c = -(np.swapaxes(R_cw, -1, -2) @ t_cw[..., None])[..., 0]
    pre = [i for i in range(gap_at) if poses[i] is not None]
    est_pre = np.array([-(poses[i][:3, :3].T @ poses[i][:3, 3]) for i in pre])
    sc, Ra, ta = align_umeyama(est_pre, gt_c[pre], with_scale=True) \
        if len(pre) >= 3 else (1.0, np.eye(3), np.zeros(3))

    def centre_error(i):
        c = -(poses[i][:3, :3].T @ poses[i][:3, 3])
        return float(np.linalg.norm(sc * Ra @ c + ta - gt_c[src[i]]))
    err_first = centre_error(after_ids[first_ok]) if first_ok is not None \
        else float("nan")
    errs_after = [centre_error(i) for i, ok in zip(after_ids, ok_after) if ok]
    tracked_after = ok_after[first_ok:] if first_ok is not None else []
    share = sum(tracked_after) / max(len(tracked_after), 1)

    stage_keys = ("t_bow_ms", "t_candidates_ms", "t_match_ms", "t_pnp_ms",
                  "t_pose_opt_ms", "t_topup_ms", "t_total_ms")
    st = good[0][1] if good else {}
    phase("reloc-path", motion=motion, sequence_frames=frames,
          frames_before_gap=gap_at, grey_frames=RELOC_GREY,
          resume_at_source_frame=resume, fed_frames=len(feed),
          precompile_s=f"{warm_s:.2f}",
          keyframes_at_gap=n_kf_at_gap, reset_limit=limit,
          gap_states="".join(x[0] for x in gap_states), resets=t.n_resets,
          ok_after_resume_frames=first_ok,
          centre_error_relocalized=f"{err_first:.5f}",
          centre_error_after_max=(f"{max(errs_after):.5f}" if errs_after
                                  else "none"),
          tracked_after_recovery=f"{sum(tracked_after)}/{len(tracked_after)}",
          state=t.state, keyframes=slam.store.n_keyframes(),
          attempts=len(attempts), attempts_ok=len(good),
          failed_attempt_ms_median=(
              f"{percentile(failed_ms, 0.5):.2f}" if failed_ms else "none"),
          worker_processed=am.n_processed, worker_error=am.error,
          captures_after_warmup=slam.captures_after_warmup,
          kernel_launches=launches, wall_s=f"{wall:.2f}",
          peak_device_mib=f"{peak_mib:.1f}")
    for fid, stats, n_launch, ms in good:
        phase("reloc-attempt", frame=fid, ms=f"{ms:.2f}",
              candidates=stats["candidates"], tried=stats["tried"],
              keyframe=stats["kf"], matches=stats["matches"],
              pnp_inliers=stats["pnp_inliers"],
              refine_inliers=stats["refine_inliers"],
              final_inliers=stats["final_inliers"],
              host_syncs=stats["syncs"], kernel_launches=n_launch,
              **{k: f"{stats[k]:.2f}" for k in stage_keys})
    # the PnP's batched factorizations at the path's shapes, alone
    g = torch.Generator(device="cuda").manual_seed(0)
    a12 = torch.randn(256, 12, 12, device="cuda", generator=g)
    a12 = a12 @ a12.transpose(-1, -2)
    a3 = torch.randn(256, 3, 3, device="cuda", generator=g)
    eigh_ms = median_ms(torch, lambda: torch.linalg.eigh(a12), 20)
    svd_ms = median_ms(torch, lambda: torch.linalg.svd(a3), 20)
    phase("reloc-linalg", eigh_256x12x12_call_ms=f"{eigh_ms:.4f}",
          svd_256x3x3_call_ms=f"{svd_ms:.4f}",
          timed="CUDA events around one call, host launch cost included")
    print(f"[reloc-timeline] {timeline(m)}", flush=True)

    if n_kf_at_gap <= limit:
        fail(f"reloc-path: {n_kf_at_gap} keyframes at the gap, the early-"
             f"loss reset needs more than {limit}")
    if t.n_resets != 0:
        fail(f"reloc-path: {t.n_resets} resets")
    if any(x != "LOST" for x in gap_states):
        fail(f"reloc-path: states during the gap {gap_states}")
    if first_ok is None or first_ok >= 3:
        fail(f"reloc-path: not OK within 3 frames of resuming ({first_ok})")
    if not good:
        fail("reloc-path: no relocalization succeeded")
    if not err_first < RELOC_CENTRE_GATE:
        fail(f"reloc-path: relocalized centre {err_first:.4f} from ground "
             f"truth (>= {RELOC_CENTRE_GATE})")
    if st["final_inliers"] < 50:
        fail(f"reloc-path: {st['final_inliers']} inliers < 50")
    if share < TRACKED_SHARE_GATE or t.state != "OK":
        fail(f"reloc-path: tracked share after recovery {share:.3f}, "
             f"state {t.state}")
    if slam.captures_after_warmup != 0:
        fail(f"reloc-path: {slam.captures_after_warmup} graph captures "
             "after warm-up")
    if am.error is not None or am.n_processed < 1:
        fail(f"reloc-path: worker error={am.error!r} "
             f"processed={am.n_processed}")
    if any(n_launch < 1 for _, _, n_launch, _ in good):
        fail("reloc-path: a relocalization did not launch the kernel")
    return launches


# ---------------------------------------------------------------------------
# phases 8 and 9: loop closing
# ---------------------------------------------------------------------------
def loop_closer_config():
    """tests/test_loop_reloc.py's loop-closer settings (the orbit's)."""
    from ar_orbslam2_tpu_torch.loop.loop_closing import LoopCloserConfig
    return LoopCloserConfig(min_kf_gap=8, consistency_threshold=1)


def orbit_scene():
    """tests/test_loop_reloc.py's full-circle orbit (the end revisits the
    start)."""
    import numpy as np

    from ar_orbslam2_tpu_torch.data import synthetic
    return synthetic.make_scene(n_landmarks=2500, n_frames=LOOP_FRAMES,
                                seed=11, trajectory="orbit",
                                arc=2 * np.pi * 0.999)


def orbit_config(loops=True):
    """tests/test_loop_reloc.py's own size (512 keypoints, 2048-landmark
    bundle, 64 keyframes, keyframes at least every 5 frames), per-frame
    path. At full width the whole orbit scene (2,500 landmarks) sits in
    the 4,096-landmark local map, every keyframe is covisible with every
    other and no loop forms (PERF.md §6)."""
    from ar_orbslam2_tpu_torch.mapping.local_mapping import LocalMapperConfig
    from ar_orbslam2_tpu_torch.mapstore.map import MapConfig
    from ar_orbslam2_tpu_torch.system.slam import SlamConfig
    from ar_orbslam2_tpu_torch.system.tracking import TrackingConfig
    return SlamConfig(
        map=MapConfig(max_keyframes=64, max_map_points=20_000, max_kp=512),
        tracking=TrackingConfig(max_kp=512, n_local_mp=2048,
                                max_frames_between_kf=5),
        mapper=LocalMapperConfig(ba_max_points=2048,
                                 n_triangulation_neighbors=5,
                                 n_fuse_neighbors=5),
        use_fused_tracking=False, enable_loop_closing=loops,
        enable_relocalization=loops)


class LoopWatch:
    """Instruments a live loop closer: the kernel launches of its two
    searches, their first inputs (for the kernel-vs-plain check), and the
    host intervals during which a loop stage or a global BA was in
    flight."""

    def __init__(self, torch, CH, lc, R_cw):
        from ar_orbslam2_tpu_torch.matching import matcher
        self.torch, self.CH, self.lc = torch, CH, lc
        self.launches = {"search_by_sim3": [], "topup": []}
        self.inputs = {}
        self.busy = []              # (t0, t1) of insert_keyframe calls
        self.gba = []               # (launch time, apply time)
        real = matcher.fused_windowed_top2

        def wrap(name, fn):
            # launches are read from the calling thread's own count: the
            # wrapper's global count also takes the tracking thread's graph
            # replays, which run beside the worker's loop stages (async)
            def run(*a, **kw):
                me = threading.get_ident()

                def record(*args, **kwargs):
                    if threading.get_ident() == me:
                        self.inputs.setdefault(name, (args, kwargs))
                    return real(*args, **kwargs)
                before = CH.thread_launches()
                matcher.fused_windowed_top2 = record
                try:
                    return fn(*a, **kw)
                finally:
                    matcher.fused_windowed_top2 = real
                    self.launches[name].append(
                        CH.thread_launches() - before)
            return run
        lc._search_by_sim3 = wrap("search_by_sim3", lc._search_by_sim3)
        lc._count_projected_matches = wrap("topup",
                                           lc._count_projected_matches)
        insert, launch, poll = lc.insert_keyframe, lc.gba.launch, \
            lc.gba.poll

        def timed_insert(kf):
            t0 = time.perf_counter()
            try:
                return insert(kf)
            finally:
                self.busy.append((t0, time.perf_counter()))

        def timed_launch():
            self.gba.append([time.perf_counter(), None])
            return launch()

        def timed_poll(block=False):
            applied = poll(block=block)
            if applied and self.gba and self.gba[-1][1] is None:
                self.gba[-1][1] = time.perf_counter()
            return applied
        correct = lc._correct_loop

        def checked_correct(kf, cand, sim3, *a):
            # the accepted S12 against the map's own relative pose of the
            # two keyframes just before the correction (degrees)
            # and against the two frames' true relative pose
            import numpy as np
            s = lc.store
            f1, f2 = int(s.kf_frame_id[kf]), int(s.kf_frame_id[cand])
            for R_ref, out in ((s.kf_R[kf] @ s.kf_R[cand].T,
                                self.r12_vs_map_deg),
                               (R_cw[f1] @ R_cw[f2].T,
                                self.r12_vs_truth_deg)):
                c = (np.trace(sim3["R12"] @ R_ref.T) - 1.0) / 2.0
                out.append(float(np.degrees(np.arccos(np.clip(c, -1.0,
                                                              1.0)))))
            return correct(kf, cand, sim3, *a)
        self.r12_vs_map_deg, self.r12_vs_truth_deg = [], []
        lc.insert_keyframe = timed_insert
        lc.gba.launch, lc.gba.poll = timed_launch, timed_poll
        lc._correct_loop = checked_correct

    def in_flight(self, t):
        """Whether a loop stage or a global BA ran at host time t."""
        spans = [(a, b) for a, b in self.busy if b - a > 0.05] \
            + [(a, b if b is not None else float("inf"))
               for a, b in self.gba]
        return any(a <= t <= b for a, b in spans)

    def check_kernel(self):
        """The loop path's two searches, kernel against plain version on
        the card on the inputs the run gave them: bit for bit."""
        CH, out = self.CH, {}
        counted = CH.fused_windowed_top2.launches   # these do not count
        for name, (args, kwargs) in self.inputs.items():
            got = CH.fused_windowed_top2(*args, **kwargs)
            want = CH.fused_windowed_top2_reference(*args, **kwargs)
            for g, w in zip(got, want):
                if not self.torch.equal(g, w):
                    fail(f"loop-path: the {name} search differs from its "
                         "plain version")
            out[name] = "x".join(str(d) for d in args[1].shape[:-1]) \
                + f"x{args[7].shape[-2]}"
        CH.fused_windowed_top2.launches = counted
        return out


def loop_gates(tag, slam, lc, tracked, n_frames, am=None):
    if not lc.loops:
        fail(f"{tag}: no loop closed")
    loop = lc.loops[0]
    if not 0.5 < loop["s12"] < 2.0:
        fail(f"{tag}: s12 {loop['s12']:.4f} outside (0.5, 2)")
    if loop["n_total"] < 40:
        fail(f"{tag}: n_total {loop['n_total']} < 40")
    if tracked <= 0.7 * n_frames:
        fail(f"{tag}: {tracked} of {n_frames} frames tracked")
    if lc.gba.n_launched < 1 or lc.gba.n_applied < 1:
        fail(f"{tag}: global BA launched {lc.gba.n_launched}, applied "
             f"{lc.gba.n_applied}")
    if am is not None and am.error is not None:
        fail(f"{tag}: worker error {am.error!r}")
    if slam.captures_after_warmup != 0:
        fail(f"{tag}: {slam.captures_after_warmup} graph captures after "
             "warm-up")


STAGES = ("detect", "bf_match", "ransac", "search_by_sim3", "optimize_sim3",
          "topup", "correction", "essential_graph", "gba_launch")


def loop_numbers(lc, watch):
    """The stage times of the attempt that closed the first loop (host
    clock: each stage ends in its readback), the global BA's device time
    on its stream (CUDA events), and the search launches per attempt."""
    done = [s for s in lc.stats_log if "t_correction_ms" in s]
    st = done[0] if done else {}
    out = {f"{k}_ms": f"{st[f't_{k}_ms']:.2f}" for k in STAGES
           if f"t_{k}_ms" in st}
    g = lc.gba.last_stats
    out.update(gba_device_ms=f"{g.get('device_ms', float('nan')):.2f}",
               gba_enqueue_ms=f"{g.get('enqueue_ms') or float('nan'):.2f}",
               gba_keyframes=g.get("n_kf"), gba_points=g.get("n_mp"),
               attempts=len(lc.stats_log),
               r12_vs_map_deg="/".join(f"{d:.2f}" for d in
                                       watch.r12_vs_map_deg) or "none",
               r12_vs_truth_deg="/".join(f"{d:.2f}" for d in
                                         watch.r12_vs_truth_deg) or "none",
               launches_search_by_sim3=watch.launches["search_by_sim3"],
               launches_topup=watch.launches["topup"])
    for k in ("bf_matches", "ransac_inliers", "pairs", "sim3_inliers"):
        out[k] = st.get(k)
    return out


def run_loop_orbit(torch, CH, loops):
    """The noisy orbit of test_loop_closure_improves_ate through the
    per-frame path at that test's size, the loop closing inline. Returns
    (loops closed, keyframe ATE, kernel launches of the run)."""
    import numpy as np

    from ar_orbslam2_tpu_torch.core.camera import Camera
    from ar_orbslam2_tpu_torch.data import synthetic
    from ar_orbslam2_tpu_torch.eval.ate import ate_rmse
    from ar_orbslam2_tpu_torch.system.slam import SlamSystem
    scene = orbit_scene()
    cam = Camera(**CAM_KW)
    slam = SlamSystem(cam, orbit_config(loops), device="cuda")
    lc = slam.tracking.loop_closer
    if lc is not None:
        lc.cfg = loop_closer_config()
    CH.fused_windowed_top2.launches = 0
    for i in range(scene.n_frames):
        obs = synthetic.observe_frame(scene, i, cam, max_kp=512,
                                      noise_px=1.5, bit_flip=0.04,
                                      dropout=0.4)
        slam.track_monocular(
            features=dict(uv=obs["uv"], desc=obs["desc"],
                          octave=obs["octave"], valid=obs["valid"]),
            timestamp=scene.timestamps[i])
    slam.shutdown()
    launches = CH.fused_windowed_top2.launches
    gt = -(np.swapaxes(scene.R_cw, -1, -2) @ scene.t_cw[..., None])[..., 0]
    ts_k, _, t_k = slam.keyframe_trajectory()
    idx = np.round(np.asarray(ts_k) * 30.0).astype(int)
    ok = idx < len(gt)
    ate = float(ate_rmse(t_k[ok], gt[idx[ok]], with_scale=True))
    closed = [] if lc is None else [(lp["kf"], lp["cand"]) for lp in
                                    lc.loops]
    return closed, ate, launches


def room_loop(cam):
    """Phase 8's scene: the camera walks 1.1 turns of a circle of radius
    1.5 m in the middle of an 8 m square room, level, looking radially
    outward at walls that each carry their own texture
    (synthetic.render_room_loop). Views more than about 90 degrees apart
    share nothing, so tracking cannot re-bind the start before the
    revisit, which sees frame 0's wall from frame 0's orientation; the
    corners make the scene non-planar. At radius 1 m the walls are 3 m
    away and the camera mostly turns: its translation is weakly observed,
    the keyframe ATE is noise that a loop cannot remove, and S12 came out
    1-5 degrees off (PERF.md §6). Rendered once (about 20 s on the host)
    and shared by the three legs."""
    from ar_orbslam2_tpu_torch.data import synthetic
    if "room" not in _SCENES:
        _SCENES["room"] = synthetic.render_room_loop(
            cam, n_frames=LOOP_IMAGES, turns=LOOP_TURNS, radius=ROOM_RADIUS)
    return _SCENES["room"]


def room_loop_ate_without_loops(torch, CH, async_mapping):
    """The room loop through SlamConfig(enable_loop_closing=False), sync or
    with async mapping: (keyframe ATE, exported ATE, the exported RMSE by
    quarter of the walk, kernel launches)."""
    from ar_orbslam2_tpu_torch.core.camera import Camera
    from ar_orbslam2_tpu_torch.system.slam import SlamConfig, SlamSystem
    cam = Camera(**CAM_KW)
    imgs, R_cw, t_cw = room_loop(cam)
    slam = SlamSystem(cam, SlamConfig(enable_loop_closing=False,
                                      async_mapping=async_mapping),
                      device="cuda")
    CH.fused_windowed_top2.launches = 0
    poses = slam.track_monocular_batch(
        list(imgs), timestamps=[i / 30.0 for i in range(len(imgs))],
        chunk=CHUNK)
    slam.shutdown()
    launches = CH.fused_windowed_top2.launches
    _, _, _, ate_exp, ate_kf = trajectory_numbers(slam, poses, R_cw, t_cw)
    spans, _ = exported_error_where(slam, R_cw, t_cw)
    return ate_kf, ate_exp, spans, launches


def room_sync_first_frames(CH):
    """The sync room leg without loops over its first REPRO_FRAMES frames,
    in a system of its own and one call of track_monocular_batch: (its
    returned poses, the ids and poses of its live keyframes, kernel
    launches, wall seconds)."""
    import numpy as np

    from ar_orbslam2_tpu_torch.core.camera import Camera
    from ar_orbslam2_tpu_torch.system.slam import SlamConfig, SlamSystem
    cam = Camera(**CAM_KW)
    imgs, _, _ = room_loop(cam)
    slam = SlamSystem(cam, SlamConfig(enable_loop_closing=False),
                      device="cuda")
    CH.fused_windowed_top2.launches = 0
    t0 = time.perf_counter()
    poses = slam.track_monocular_batch(
        list(imgs[:REPRO_FRAMES]),
        timestamps=[i / 30.0 for i in range(REPRO_FRAMES)], chunk=CHUNK)
    wall = time.perf_counter() - t0
    slam.shutdown()
    s = slam.store
    ids = s.keyframe_ids()
    return dict(poses=[None if p is None else np.array(p) for p in poses],
                kf_ids=ids.copy(), kf_R=s.kf_R[ids].copy(),
                kf_t=s.kf_t[ids].copy(),
                launches=CH.fused_windowed_top2.launches, wall=wall)


def room_sync_twice(CH):
    """One input, one result: the sync room leg without loops over its
    first REPRO_FRAMES frames, in two fresh systems; their returned poses,
    keyframe count and keyframe poses must be equal bit for bit. Returns
    kernel launches."""
    import numpy as np
    first, again = (room_sync_first_frames(CH) for _ in range(2))
    launches = first["launches"] + again["launches"]

    def same(a, b):
        return (a is None) == (b is None) and (a is None
                                               or np.array_equal(a, b))
    diff = [i for i, (a, b) in enumerate(zip(first["poses"], again["poses"]))
            if not same(a, b)]
    kf_equal = all(np.array_equal(first[k], again[k])
                   for k in ("kf_ids", "kf_R", "kf_t"))
    phase("loop-repro-room", frames=REPRO_FRAMES,
          config="SlamConfig(enable_loop_closing=False)",
          poses_bit_identical=not diff,
          first_differing_frame=diff[0] if diff else "none",
          differing_frames=len(diff),
          keyframes=f"{len(first['kf_ids'])}/{len(again['kf_ids'])}",
          keyframe_poses_bit_identical=kf_equal,
          wall_s=f"{first['wall']:.2f}/{again['wall']:.2f}",
          kernel_launches=launches)
    if diff or not kf_equal or len(first["poses"]) != len(again["poses"]):
        fail(f"loop-repro-room: the sync room leg without loops gave "
             f"two results in two runs over {REPRO_FRAMES} frames: "
             f"first differing frame "
             f"{diff[0] if diff else 'none'}, keyframes "
             f"{len(first['kf_ids'])} / {len(again['kf_ids'])}, keyframe "
             f"poses equal {kf_equal}")
    return launches


def run_loop_images(torch, CH, async_mapping):
    """The room loop at full width through precompile() and
    track_monocular_batch(chunk=8): SlamConfig() (the loop closes inline)
    or SlamConfig(async_mapping=True) (on the mapping worker, the global BA
    on its own stream). Returns (kernel launches of the run, keyframe ATE,
    exported ATE)."""
    from ar_orbslam2_tpu_torch.core.camera import Camera
    from ar_orbslam2_tpu_torch.system.slam import SlamConfig, SlamSystem

    tag = "loop-async" if async_mapping else "loop-sync"
    cam = Camera(**CAM_KW)
    imgs, R_cw, t_cw = room_loop(cam)
    slam = SlamSystem(cam, SlamConfig(async_mapping=async_mapping),
                      device="cuda")
    t, lc = slam.tracking, slam.tracking.loop_closer
    t0 = time.perf_counter()
    slam.precompile()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    watch = LoopWatch(torch, CH, lc, R_cw)
    fe = t.fused
    collected = []                  # host time of each chunk's readback
    collect = fe.collect_chunk      # (step_chunk reads back through it)

    def stamped(handle):
        out = collect(handle)
        collected.append(time.perf_counter())
        return out
    fe.collect_chunk = stamped
    CH.fused_windowed_top2.launches = 0
    t0 = time.perf_counter()
    poses = slam.track_monocular_batch(
        list(imgs), timestamps=[i / 30.0 for i in range(len(imgs))],
        chunk=CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    slam.shutdown()
    launches = CH.fused_windowed_top2.launches
    am = t.async_mapper
    init, after, ate, ate_exp, ate_kf = trajectory_numbers(
        slam, poses, R_cw, t_cw)
    busy, calm = [], []
    for a, b in zip(collected, collected[1:]):
        (busy if watch.in_flight(b) else calm).append((b - a) * 1e3 / CHUNK)
    tracked = sum(p is not None for p in poses)
    points = [r["n_inliers"] for r in t.metrics if r["state"] == "OK"]
    exp_spans, exp_worst = exported_error_where(slam, R_cw, t_cw)
    phase(tag, frames=len(imgs), precompile_s=f"{warm_s:.2f}",
          tracked=tracked, state=t.state, resets=t.n_resets,
          keyframes=slam.store.n_keyframes(),
          loops=[(lp["kf"], lp["cand"]) for lp in lc.loops],
          s12=f"{lc.loops[0]['s12']:.5f}" if lc.loops else "none",
          n_total=lc.loops[0]["n_total"] if lc.loops else "none",
          gba_launched=lc.gba.n_launched, gba_applied=lc.gba.n_applied,
          gba_aborted=lc.gba.n_aborted,
          ate_keyframes=f"{ate_kf:.5f}", ate_exported=f"{ate_exp:.5f}",
          exported_rmse_by_quarter=exp_spans,
          exported_worst_frame=exp_worst,
          rescue_keyframes_dropped=t.n_rescue_dropped,
          ms_per_frame_median_calm=(f"{percentile(calm, 0.5):.2f}"
                                    if calm else "none"),
          ms_per_frame_median_loop_or_gba=(f"{percentile(busy, 0.5):.2f}"
                                           if busy else "none"),
          ms_per_frame_max_loop_or_gba=(f"{max(busy):.2f}" if busy
                                        else "none"),
          chunks_calm=len(calm), chunks_loop_or_gba=len(busy),
          tracked_points_median=percentile(points, 0.5) if points
          else "none",
          worker_processed=None if am is None else am.n_processed,
          worker_error=None if am is None else am.error,
          captures_after_warmup=slam.captures_after_warmup,
          wall_s=f"{wall:.2f}", kernel_launches=launches,
          **loop_numbers(lc, watch))
    print(f"[{tag}-timeline] {timeline(t.metrics)}", flush=True)
    fid = slam.store.kf_frame_id
    print(f"[{tag}-attempts] " + " ".join(
        f"{int(fid[st['kf']])}:{int(fid[st['cand']])}/"
        + "/".join(str(st[k]) for k in ("bf_matches", "sim3_inliers",
                                        "n_total") if k in st)
        for st in lc.stats_log), flush=True)
    loop_gates(tag, slam, lc, tracked, len(imgs), am)
    if not watch.r12_vs_truth_deg[0] <= S12_TRUTH_GATE_DEG:
        fail(f"{tag}: the first loop's S12 is "
             f"{watch.r12_vs_truth_deg[0]:.2f} degrees from the true "
             f"relative rotation (gate {S12_TRUTH_GATE_DEG})")
    for name in ("search_by_sim3", "topup"):
        if not watch.launches[name] or any(n != 1 for n in
                                           watch.launches[name]):
            fail(f"{tag}: {name} launches per attempt "
                 f"{watch.launches[name]} (one each expected)")
    phase(f"{tag}-kernel-check", bit_identical=True, **watch.check_kernel())
    return launches, ate_kf, ate_exp, exp_spans


def run_loop_path(torch, CH):
    """Phase 8: loop closing at full width, inline (sync) and on the
    mapping worker with the global BA on its own stream (async), and what
    the loops do to the trajectory's accuracy."""
    legs = {}                   # leg: (keyframe ATE, exported ATE, spans)
    launches = 0
    for name, async_mapping in (("loops_sync", False), ("loops_async", True)):
        n, *legs[name] = run_loop_images(torch, CH, async_mapping)
        launches += n
    n_off = 0
    for name, async_mapping in (("no_loops_sync", False),
                                ("no_loops_async", True)):
        *legs[name], n = room_loop_ate_without_loops(torch, CH,
                                                     async_mapping)
        n_off += n
    launches += n_off
    # one input, one result: the sync leg without loops, twice
    launches += room_sync_twice(CH)
    phase("loop-ate-room", frames=LOOP_IMAGES, **{
        f"{key}_{name}": value for name, (kf, exp, spans) in legs.items()
        for key, value in (("ate_keyframes", f"{kf:.5f}"),
                           ("ate_exported", f"{exp:.5f}"),
                           ("exported_rmse_by_quarter", spans),
                           ("exported_to_keyframe_ate", f"{exp / kf:.2f}"))},
        kernel_launches_no_loops=n_off)
    ate_off = legs["no_loops_sync"][0]
    ate_sync, ate_async = legs["loops_sync"][0], legs["loops_async"][0]
    if not max(ate_sync, ate_async) < ate_off:
        fail(f"loop-ate-room: keyframe ATE with loops {ate_sync:.5f} / "
             f"{ate_async:.5f} is not below the ATE without {ate_off:.5f}")
    for name, (_, exp, _) in legs.items():
        if not exp < ATE_GATE:
            fail(f"loop-ate-room: {name} exported ATE {exp:.5f} >= "
                 f"{ATE_GATE}")
    # test_loop_closure_improves_ate's noisy orbit at that test's size:
    # reported, not gated (PERF.md §6: the port's odometry leaves
    # the loops nothing to correct there)
    loops_on, ate_on, n_on = run_loop_orbit(torch, CH, loops=True)
    _, ate_orbit_off, n_orbit_off = run_loop_orbit(torch, CH, loops=False)
    phase("loop-ate-orbit", frames=LOOP_FRAMES, noise_px=1.5, bit_flip=0.04,
          dropout=0.4, loops=loops_on, ate_keyframes_loops=f"{ate_on:.5f}",
          ate_keyframes_no_loops=f"{ate_orbit_off:.5f}",
          kernel_launches=n_on + n_orbit_off)
    if not loops_on:
        fail("loop-ate-orbit: no loop closed on the noisy orbit")
    return launches + n_on + n_orbit_off


def run_default_config(torch, CH):
    """Phase 9: exactly the configuration bench.py builds,
    SlamConfig(async_mapping=True): loop closing and relocalization on,
    on phase 6's sweep."""
    from ar_orbslam2_tpu_torch.system.slam import SlamConfig, SlamSystem

    n_frames = FUSED_FRAMES
    cam, imgs, R_cw, t_cw = make_sequence(n_frames, FUSED_MOTION)
    slam = SlamSystem(cam, SlamConfig(async_mapping=True), device="cuda")
    t0 = time.perf_counter()
    slam.precompile()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t, lc = slam.tracking, slam.tracking.loop_closer
    fe = t.fused
    collected, loop_ms = [], []
    collect, insert = fe.collect_chunk, lc.insert_keyframe

    def stamped(handle):
        out = collect(handle)
        collected.append(time.perf_counter())
        return out

    def timed_insert(kf):
        t1 = time.perf_counter()
        try:
            return insert(kf)
        finally:
            loop_ms.append((time.perf_counter() - t1) * 1e3)
    fe.collect_chunk = stamped
    lc.insert_keyframe = timed_insert
    CH.fused_windowed_top2.launches = 0
    t0 = time.perf_counter()
    poses = slam.track_monocular_batch(
        imgs, timestamps=[i / 30.0 for i in range(n_frames)], chunk=CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    slam.shutdown()
    launches = CH.fused_windowed_top2.launches
    am = t.async_mapper
    init, after, ate, ate_exp, ate_kf = trajectory_numbers(
        slam, poses, R_cw, t_cw)
    fused = sum(1 for r in t.metrics if r.get("fused"))
    periods = [(b - a) * 1e3 / CHUNK
               for a, b in zip(collected, collected[1:])] or [float("nan")]
    phase("default-config", config="SlamConfig(async_mapping=True)",
          frames=n_frames, precompile_s=f"{warm_s:.2f}", init_frame=init,
          tracked_after_init=f"{sum(after)}/{len(after)}", state=t.state,
          keyframes=slam.store.n_keyframes(), resets=t.n_resets,
          ate_keyframes=f"{ate_kf:.5f}", ate_exported=f"{ate_exp:.5f}",
          ate_online=f"{ate:.5f}",
          ms_per_frame_median=f"{percentile(periods, 0.5):.2f}",
          ms_per_frame_p90=f"{percentile(periods, 0.9):.2f}",
          phase6_ms_per_frame_median=PHASE6.get("median", "not run"),
          phase6_ms_per_frame_p90=PHASE6.get("p90", "not run"),
          loop_ms_per_keyframe="/".join(f"{x:.1f}" for x in loop_ms)
          or "none", loops=len(lc.loops), vocab_trained=lc.kfdb.trained,
          worker_processed=am.n_processed, worker_error=am.error,
          captures_after_warmup=slam.captures_after_warmup,
          kernel_launches=launches, wall_s=f"{wall:.2f}")
    trajectory_gates("default-config", slam, after, ate_kf, "keyframe ATE")
    for name, value in (("online", ate), ("exported", ate_exp)):
        if not value < ATE_GATE:
            fail(f"default-config: {name} ATE {value:.4f} >= {ATE_GATE}")
    if t.n_resets != 0:
        fail(f"default-config: {t.n_resets} resets")
    if am.error is not None or am.n_processed < 1:
        fail(f"default-config: worker error={am.error!r} "
             f"processed={am.n_processed}")
    if slam.captures_after_warmup != 0:
        fail(f"default-config: {slam.captures_after_warmup} graph captures "
             "after warm-up")
    if launches < 2 * fused:
        fail(f"default-config: {launches} kernel launches for {fused} "
             "fused frames")
    return launches


# ---------------------------------------------------------------------------
# phase 10: depth sensors, localization mode, map loading, slot reuse
# ---------------------------------------------------------------------------
class KernelInputs:
    """While installed, keeps the inputs of the first search of each shape
    the matcher sends to the kernel, for the kernel-vs-plain check on the
    run's own inputs (the launches themselves are counted as usual)."""

    def __init__(self, torch, CH):
        from ar_orbslam2_tpu_torch.matching import matcher
        self.torch, self.CH, self.matcher = torch, CH, matcher
        self.inputs = {}

    def __enter__(self):
        real = self.real = self.matcher.fused_windowed_top2

        def record(*args, **kwargs):
            key = "x".join(str(d) for d in args[1].shape[:-1]) \
                + f"x{args[7].shape[-2]}"
            self.inputs.setdefault(key, (args, kwargs))
            return real(*args, **kwargs)
        self.matcher.fused_windowed_top2 = record
        return self

    def __exit__(self, *exc):
        self.matcher.fused_windowed_top2 = self.real

    def check(self, tag):
        """Kernel against plain version, bit for bit; these launches do
        not count. Returns the shapes checked."""
        CH = self.CH
        counted = CH.fused_windowed_top2.launches
        for key, (args, kwargs) in self.inputs.items():
            got = CH.fused_windowed_top2(*args, **kwargs)
            want = CH.fused_windowed_top2_reference(*args, **kwargs)
            for g, w in zip(got, want):
                if not self.torch.equal(g, w):
                    fail(f"{tag}: the {key} search differs from its plain "
                         "version")
        CH.fused_windowed_top2.launches = counted
        if not self.inputs:
            fail(f"{tag}: no search reached the kernel")
        return "/".join(sorted(self.inputs))


def depth_camera():
    from ar_orbslam2_tpu_torch.core.camera import Camera
    return Camera(bf=DEPTH_BF, **CAM_KW)


def plane_depth_map(cam, R, t, distance=3.0):
    """Per-pixel depth of the rendered plane (world z = distance) seen from
    (R, t): each pixel's ray meets the plane (the ground truth of
    tests/test_stereo_image_e2e.py's subpixel test, for every pixel)."""
    import numpy as np
    v, u = np.mgrid[0:cam.height, 0:cam.width].astype(np.float64)
    rays = np.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy,
                     np.ones_like(u)], -1)
    return ((distance + (R.T @ t)[2]) / (rays @ R)[..., 2]).astype(np.float32)


def centres(R_cw, t_cw):
    import numpy as np
    return -(np.swapaxes(R_cw, -1, -2) @ t_cw[..., None])[..., 0]


def metric_ates(slam, poses, gt_c, src):
    """ATE without scale alignment on the returned poses and on the
    exported trajectory; src[i] is the ground-truth index of fed frame i,
    whose timestamp is src[i] / 30."""
    import numpy as np

    from ar_orbslam2_tpu_torch.eval.ate import ate_rmse
    ok = [i for i, p in enumerate(poses) if p is not None]
    est = np.array([-(poses[i][:3, :3].T @ poses[i][:3, 3]) for i in ok])
    online = float(ate_rmse(est, gt_c[[src[i] for i in ok]],
                            with_scale=False))
    ts, _, t_wc = slam.frame_trajectory()
    exported = float(ate_rmse(
        t_wc, gt_c[np.round(np.asarray(ts) * 30.0).astype(int)],
        with_scale=False))
    return online, exported


def stereo_stage_ms(torch, slam, left, right, picks):
    """The stereo feature stage taken apart, on the run's own images and
    apart from the tracked run (whose path adds no waits to time them):
    both ORB extractions, match_stereo and refine_stereo_subpixel, each
    closed by a device synchronisation. Medians over `picks`."""
    from ar_orbslam2_tpu_torch.frontend import stereo
    from ar_orbslam2_tpu_torch.ops import hamming as H
    cam = slam.cam
    max_disp = max(cam.bf / max(cam.fx * 0.02, 1e-6), 64.0)
    times = {"orb": [], "match": [], "refine": []}

    def up(a):
        return torch.as_tensor(a, device=slam.device)

    def lap(key, t0):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        times[key].append((t1 - t0) * 1e3)
        return t1
    for i in picks:
        t0 = time.perf_counter()
        fl = slam._extract(left[i])
        fr = slam._extract(right[i])
        t0 = lap("orb", t0)
        uv_l, valid_l = up(fl["uv"]), up(fl["valid"])
        uvr, _ = stereo.match_stereo(
            uv_l, H.to_signs(fl["desc_bits"], device=slam.device),
            up(fl["octave"]), valid_l, up(fr["uv"]),
            H.to_signs(fr["desc_bits"], device=slam.device),
            up(fr["octave"]), up(fr["valid"]), float(max_disp))
        t0 = lap("match", t0)
        stereo.refine_stereo_subpixel(up(left[i]), up(right[i]), uv_l, uvr,
                                      valid_l)
        lap("refine", t0)
    return {k: f"{percentile(v, 0.5):.2f}" for k, v in times.items()}


def run_depth_sequence(torch, CH, sensor, frames, tag, plane=3.0,
                       depth_band=(2.0, 4.0), precompile=False,
                       keyframes=False):
    """Phase 10a/10b: SlamConfig(sensor=...) with every other default on
    rendered stereo pairs (RGB-D: the left images and the plane's depth
    map); per frame: host time (synchronised) and the stage times the
    system records. `keyframes`: gate >= 3 keyframes, each after the first
    seeding landmarks from its depth."""
    import numpy as np

    from ar_orbslam2_tpu_torch.system.slam import SlamConfig, SlamSystem
    left, right, R_cw, t_cw = frames
    cam = depth_camera()
    n = len(left)
    slam = SlamSystem(cam, SlamConfig(sensor=sensor), device="cuda")
    warm_s = float("nan")
    if precompile:
        t0 = time.perf_counter()
        slam.precompile(n_frames=DEPTH_PRECOMPILE_FRAMES)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    depth = [plane_depth_map(cam, R_cw[i], t_cw[i], distance=plane)
             for i in range(n)] if sensor == "RGBD" else None
    frame_ms, poses = [], []
    torch.cuda.reset_peak_memory_stats()
    CH.fused_windowed_top2.launches = 0
    with KernelInputs(torch, CH) as rec:
        for i in range(n):
            t0 = time.perf_counter()
            if sensor == "STEREO":
                T = slam.track_stereo(left[i], right[i], timestamp=i / 30.0)
            else:
                T = slam.track_rgbd(left[i], depth[i], timestamp=i / 30.0)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            poses.append(T)
    launches = CH.fused_windowed_top2.launches
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    shapes = rec.check(tag)
    stages = stereo_stage_ms(torch, slam, left, right, range(1, 6)) \
        if sensor == "STEREO" else None
    slam.shutdown()
    t, s = slam.tracking, slam.store
    m = t.metrics
    gt_c = centres(R_cw, t_cw)
    ate, ate_exp = metric_ates(slam, poses, gt_c, list(range(n)))
    tracked = sum(p is not None for p in poses)
    kf_recs = [r for r in m if "new_kf" in r]
    seeded = [r.get("n_depth_mp", 0) for r in kf_recs]
    z = s.mp_pos[s.mp_valid][:, 2]
    kf_stage = ("t_process_ms", "t_cull_mp_ms", "t_triangulate_ms",
                "t_fuse_ms", "t_local_ba_ms", "t_cull_kf_ms", "t_loop_ms")
    track_ms = [frame_ms[i] - r.get("t_features_ms", 0.0)
                for i, r in enumerate(m) if i > 0 and "new_kf" not in r]
    kf_ms = [sum(r.get(k, 0.0) for k in kf_stage) for r in kf_recs]

    def med(key):
        v = [r[key] for r in m[1:] if key in r]
        return f"{percentile(v, 0.5):.2f}" if v else "none"
    steady = frame_ms[1:]
    lc = t.loop_closer
    phase(tag, config=f"SlamConfig(sensor={sensor})",
          frames=n, precompile_s=f"{warm_s:.2f}",
          tracked=f"{tracked}/{n}", first_frame_tracked=poses[0] is not None,
          state=t.state, keyframes=s.n_keyframes(), resets=t.n_resets,
          depth_seeded=seeded, median_landmark_depth=f"{np.median(z):.3f}",
          map_points=s.n_map_points(), ate_metric=f"{ate:.5f}",
          ate_metric_exported=f"{ate_exp:.5f}",
          ms_per_frame_median=f"{percentile(steady, 0.5):.2f}",
          ms_per_frame_p90=f"{percentile(steady, 0.9):.2f}",
          features_ms=med("t_features_ms"),
          orb_ms=stages["orb"] if stages else med("t_features_ms"),
          stereo_match_ms=stages["match"] if stages else "none",
          stereo_refine_ms=stages["refine"] if stages else "none",
          track_ms=(f"{percentile(track_ms, 0.5):.2f}" if track_ms
                    else "none"),
          keyframe_event_ms="/".join(f"{x:.1f}" for x in kf_ms) or "none",
          loop_stage_ms="/".join(f"{r.get('t_loop_ms', 0.0):.1f}"
                                 for r in kf_recs) or "none",
          loops=len(lc.loops), fix_scale=lc.cfg.fix_scale,
          kernel_launches=launches,
          launches_per_tracked_frame=f"{launches / max(tracked, 1):.2f}",
          kernel_checked=shapes, peak_device_mib=f"{peak_mib:.1f}",
          wall_s=f"{sum(frame_ms) / 1e3:.2f}")
    if poses[0] is None:
        fail(f"{tag}: frame 0 not tracked")
    if tracked < TRACKED_SHARE_GATE * n or t.state != "OK":
        fail(f"{tag}: {tracked}/{n} tracked, state {t.state}")
    for name, value in (("returned", ate), ("exported", ate_exp)):
        if not value < ATE_GATE:
            fail(f"{tag}: metric ATE ({name}) {value:.4f} >= {ATE_GATE}")
    lo, hi = depth_band
    if not lo < float(np.median(z)) < hi:
        fail(f"{tag}: median landmark depth {np.median(z):.3f} outside "
             f"({lo}, {hi})")
    if keyframes and s.n_keyframes() < MIN_KEYFRAMES:
        fail(f"{tag}: {s.n_keyframes()} keyframes < {MIN_KEYFRAMES}")
    if keyframes and (not seeded or min(seeded) <= 0):
        fail(f"{tag}: keyframes without depth-seeded landmarks {seeded}")
    if t.n_resets != 0:
        fail(f"{tag}: {t.n_resets} resets")
    # each tracked frame after the first: one local-map search, and one
    # more when it had a velocity for the motion-model search (the frame
    # after the map's first has none)
    need = sum(2 if "motion_matches" in r else 1
               for r in m[1:] if r["ok"])
    if launches < need:
        fail(f"{tag}: {launches} kernel launches, {need} expected for "
             f"{tracked} tracked frames")
    return slam, launches


def run_localization(torch, CH, mapped, frames):
    """Phase 10c: the stereo loop's map saved, loaded into a fresh
    SlamSystem(sensor="STEREO") in localization mode, and the sequence
    tracked again from its middle."""
    import tempfile

    import numpy as np

    from ar_orbslam2_tpu_torch.system.slam import SlamConfig, SlamSystem
    left, right, R_cw, t_cw = frames
    n = len(left)
    start = n // 2
    stop = start + DEPTH_LOCALIZATION_FRAMES
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stereo_map.npz")
        mapped.save_map(path)
        slam = SlamSystem(depth_camera(), SlamConfig(sensor="STEREO"),
                          device="cuda")
        t0 = time.perf_counter()
        slam.load_map(path)
        load_s = time.perf_counter() - t0
    s, t = slam.store, slam.tracking
    n_kf, n_mp, created = s.n_keyframes(), s.n_map_points(), s.n_kf_created
    db_rows = int((slam.kfdb.has_bow & s.kf_valid).sum())
    poses, frame_ms = [], []
    CH.fused_windowed_top2.launches = 0
    with KernelInputs(torch, CH) as rec:
        for i in range(start, stop):
            t1 = time.perf_counter()
            poses.append(slam.track_stereo(left[i], right[i],
                                           timestamp=i / 30.0))
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t1) * 1e3)
    launches = CH.fused_windowed_top2.launches
    shapes = rec.check("depth-localization")
    slam.shutdown()
    ok = [p is not None for p in poses]
    first = ok.index(True) if any(ok) else None
    after = ok[first:] if first is not None else []
    share = sum(after) / max(len(after), 1)
    src = list(range(start, stop))
    ate, ate_exp = metric_ates(slam, poses, centres(R_cw, t_cw), src) \
        if any(ok) else (float("nan"), float("nan"))
    rel = t.relocalizer
    phase("depth-localization", loaded_keyframes=n_kf,
          loaded_map_points=n_mp, database_rows=db_rows,
          load_s=f"{load_s:.3f}", resumed_at=start, frames=stop - start,
          first_ok=first, tracked_after=f"{sum(after)}/{len(after)}",
          relocalizations=rel.n_success,
          ate_metric=f"{ate:.5f}", ate_metric_exported=f"{ate_exp:.5f}",
          keyframes_added=s.n_kf_created - created,
          map_points_after=s.n_map_points(),
          ms_per_frame_median=f"{percentile(frame_ms[1:], 0.5):.2f}",
          kernel_launches=launches, kernel_checked=shapes)
    if db_rows != n_kf:
        fail(f"depth-localization: {db_rows} database rows for {n_kf} "
             "loaded keyframes")
    if first is None or first >= 3:
        fail(f"depth-localization: not relocalized within 3 frames "
             f"({first})")
    if share < TRACKED_SHARE_GATE:
        fail(f"depth-localization: tracked share {share:.3f}")
    for name, value in (("returned", ate), ("exported", ate_exp)):
        if not value < ATE_GATE:
            fail(f"depth-localization: metric ATE ({name}) {value:.4f}")
    if s.n_kf_created != created or s.n_keyframes() != n_kf:
        fail(f"depth-localization: keyframes {n_kf} -> {s.n_keyframes()}, "
             f"created {s.n_kf_created - created}")
    if s.n_map_points() != n_mp:
        fail(f"depth-localization: landmarks {n_mp} -> {s.n_map_points()}")
    return launches


def feature_camera(bf):
    from ar_orbslam2_tpu_torch.core.camera import Camera
    return Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=bf)


def feature_config(**map_kw):
    """tests/test_localization_vo.py's and test_slam_stereo_e2e.py's size:
    512 keypoints, a 2048-landmark bundle, keyframes at least every 5
    frames; relocalization on, loop closing off."""
    from ar_orbslam2_tpu_torch.mapping.local_mapping import LocalMapperConfig
    from ar_orbslam2_tpu_torch.mapstore.map import MapConfig
    from ar_orbslam2_tpu_torch.system.slam import SlamConfig
    from ar_orbslam2_tpu_torch.system.tracking import TrackingConfig
    return SlamConfig(
        sensor="RGBD",
        map=MapConfig(**dict(dict(max_keyframes=64, max_map_points=20_000,
                                  max_kp=512), **map_kw)),
        tracking=TrackingConfig(max_kp=512, n_local_mp=2048,
                                max_frames_between_kf=5),
        mapper=LocalMapperConfig(ba_max_points=2048,
                                 n_triangulation_neighbors=5,
                                 n_fuse_neighbors=5),
        enable_loop_closing=False, enable_relocalization=True)


def track_features(slam, scene, cam, i):
    from ar_orbslam2_tpu_torch.data import synthetic
    obs = synthetic.observe_frame(scene, i, cam, max_kp=512, noise_px=0.3,
                                  bit_flip=0.02)
    return slam.track_rgbd(features=dict(uv=obs["uv"], desc=obs["desc"],
                                         octave=obs["octave"],
                                         valid=obs["valid"]),
                           kp_depth=obs["depth"],
                           timestamp=scene.timestamps[i])


def run_vo_and_slots(torch, CH):
    """Phase 10d: localization mode's VO regime on
    tests/test_localization_vo.py's out-and-back scene, then keyframe
    slots reused past capacity on the RGB-D orbit swept back and forth."""
    import numpy as np

    from ar_orbslam2_tpu_torch.data import synthetic
    from ar_orbslam2_tpu_torch.eval.ate import ate_rmse
    from ar_orbslam2_tpu_torch.system.slam import SlamSystem

    # the VO regime
    base = synthetic.make_scene(
        n_landmarks=4000, n_frames=36, seed=5, trajectory="forward",
        box=((-4.0, -3.0, 0.0), (4.0, 3.0, 26.0)), speed=0.35)
    back = np.arange(14, -1, -1)
    scene = synthetic.SyntheticScene(
        base.landmarks, base.desc_bits,
        np.concatenate([base.R_cw, base.R_cw[back]]),
        np.concatenate([base.t_cw, base.t_cw[back]]), np.arange(51) / 30.0)
    cam = feature_camera(50.0)
    slam = SlamSystem(cam, feature_config(), device="cuda")
    n_map, history = 16, []
    CH.fused_windowed_top2.launches = 0
    with KernelInputs(torch, CH) as rec:
        for i in range(scene.n_frames):
            if i == n_map:
                slam.activate_localization_mode()
                n_kf = slam.store.n_keyframes()
                resets = slam.tracking.n_resets
            T = track_features(slam, scene, cam, i)
            history.append((T is not None, slam.tracking.vo))
    launches = CH.fused_windowed_top2.launches
    shapes = rec.check("depth-vo")
    mid = [ok for i, (ok, _) in enumerate(history)
           if n_map + 8 <= i < n_map + 20]
    reacquired = any(ok and not vo for ok, vo in history[-6:])
    trace = "".join("V" if vo else ("o" if ok else "x")
                    for ok, vo in history)
    phase("depth-vo", frames=scene.n_frames, mapped_frames=n_map,
          trace=trace, vo_frames=sum(vo for _, vo in history),
          mid_tracked=f"{sum(mid)}/{len(mid)}", reacquired=reacquired,
          keyframes_added=slam.store.n_keyframes() - n_kf,
          resets_in_localization=slam.tracking.n_resets - resets,
          kernel_launches=launches, kernel_checked=shapes)
    if not any(vo for _, vo in history):
        fail("depth-vo: the VO regime never engaged")
    if sum(mid) < 0.5 * len(mid):
        fail(f"depth-vo: {sum(mid)}/{len(mid)} mid-stretch frames tracked")
    if not reacquired:
        fail(f"depth-vo: map not re-acquired on the return ({trace})")
    if slam.store.n_keyframes() != n_kf or slam.tracking.n_resets != resets:
        fail("depth-vo: localization mode changed the map")

    # keyframe slots reused past capacity
    leg = SLOT_LEG
    base = synthetic.make_scene(n_landmarks=1500, n_frames=leg, seed=5,
                                trajectory="orbit", arc=3.0)
    sweep = np.concatenate([np.arange(leg), np.arange(leg - 2, 0, -1)])
    idx = np.resize(sweep, SLOT_FRAMES)
    scene = synthetic.SyntheticScene(base.landmarks, base.desc_bits,
                                     base.R_cw[idx], base.t_cw[idx],
                                     np.arange(len(idx)) / 30.0)
    cam = feature_camera(40.0)
    slam = SlamSystem(cam, feature_config(max_keyframes=SLOT_CAPACITY),
                      device="cuda")
    CH.fused_windowed_top2.launches = 0
    error = None
    poses = []
    with KernelInputs(torch, CH) as rec:
        try:
            for i in range(scene.n_frames):
                poses.append(track_features(slam, scene, cam, i))
        except RuntimeError as e:
            error = e
    n_slots = CH.fused_windowed_top2.launches
    shapes = rec.check("depth-slots")
    s = slam.store
    seeded = [r.get("n_depth_mp", 0) for r in slam.tracking.metrics
              if "new_kf" in r]
    ok = [i for i, p in enumerate(poses) if p is not None]
    gt = centres(scene.R_cw, scene.t_cw)
    est = np.array([-(poses[i][:3, :3].T @ poses[i][:3, 3]) for i in ok])
    ate = float(ate_rmse(est, gt[ok], with_scale=False)) if ok \
        else float("nan")
    ts, _, t_wc = slam.frame_trajectory()
    ate_exp = float(ate_rmse(t_wc, gt[np.round(ts * 30.0).astype(int)],
                             with_scale=False)) if len(ts) else float("nan")
    phase("depth-slots", capacity=SLOT_CAPACITY, frames=scene.n_frames,
          processed=len(poses), error=repr(error),
          keyframes_created=s.n_kf_created, slots_reused=s.n_kf_reused,
          live_keyframes=s.n_keyframes(), tracked=f"{len(ok)}/{len(poses)}",
          depth_seeded_min=min(seeded, default=0),
          ate_metric=f"{ate:.5f}", ate_metric_exported=f"{ate_exp:.5f}",
          kernel_launches=n_slots, kernel_checked=shapes)
    if error is not None:
        fail(f"depth-slots: {error!r}")
    if s.n_kf_reused < 1 or s.n_kf_created <= SLOT_CAPACITY:
        fail(f"depth-slots: {s.n_kf_created} keyframes created, "
             f"{s.n_kf_reused} slots reused")
    if not seeded or min(seeded) <= 0:
        fail("depth-slots: keyframes without depth-seeded landmarks")
    for name, value in (("returned", ate), ("exported", ate_exp)):
        if not value < ATE_GATE:
            fail(f"depth-slots: metric ATE ({name}) {value:.4f}")
    return launches + n_slots


def run_depth_path(torch, CH):
    """Phase 10: stereo and RGB-D at full width, localization against a
    loaded map, the VO regime and keyframe slot reuse."""
    from ar_orbslam2_tpu_torch.data import synthetic
    cam = depth_camera()
    frames = synthetic.render_stereo_plane_sequence(
        cam, n_frames=DEPTH_FRAMES, seed=0, motion=DEPTH_MOTION)
    launches = run_depth_sequence(torch, CH, "STEREO", frames,
                                  "depth-stereo", precompile=True)[1]
    launches += run_depth_sequence(torch, CH, "RGBD", frames,
                                   "depth-rgbd")[1]
    # the sway above keeps most of the first keyframe's landmarks in view,
    # so the map keeps one keyframe (PERF.md §6); the keyframe path
    # runs on a camera that travels: a circle over a plane 1.5 m away
    loop = tuple(x[:DEPTH_LOOP_TRACKED] for x in
                 synthetic.render_stereo_plane_loop(
                     cam, n_frames=DEPTH_LOOP_FRAMES, radius=1.0, tilt=0.35))
    mapped, n = run_depth_sequence(torch, CH, "STEREO", loop,
                                   "depth-stereo-loop", plane=1.5,
                                   depth_band=(1.2, 2.0), keyframes=True)
    launches += n
    launches += run_localization(torch, CH, mapped, loop)
    launches += run_vo_and_slots(torch, CH)
    return launches


# ---------------------------------------------------------------------------
# phase 11: the user's entry points and the AR app
# ---------------------------------------------------------------------------
def write_apps_inputs(root):
    """Phase 11's datasets, written under `root`: phase 6's sweep rendered
    at APPS_FRAMES frames, its first APPS_EVAL_FRAMES as a TUM directory
    (rgb/, rgb.txt,
    groundtruth.txt) with a FileStorage settings file (the renderer's
    intrinsics, Camera.fps 30, ORBextractor.nFeatures 1000); and its first
    APPS_RGBD_FRAMES frames with the plane's exact depth maps as 16-bit PNGs
    at DepthMapFactor 5000, with phase 10's bf."""
    from ar_orbslam2_tpu_torch.data import datasets
    from ar_orbslam2_tpu_torch.utils.config import write_settings
    cam, imgs, R_cw, t_cw = make_sequence(APPS_FRAMES, FUSED_MOTION)
    n = APPS_EVAL_FRAMES
    imgs, R_cw, t_cw = imgs[:n], R_cw[:n], t_cw[:n]
    mono = os.path.join(root, "mono")
    datasets.write_tum_sequence(mono, imgs, R_cw, t_cw)
    write_settings(os.path.join(mono, "settings.yaml"), cam, fps=30.0,
                   n_features=1000)
    dcam = depth_camera()
    n = APPS_RGBD_FRAMES
    rgbd = os.path.join(root, "rgbd")
    datasets.write_tum_sequence(
        rgbd, imgs[:n], R_cw[:n], t_cw[:n],
        depth=[plane_depth_map(dcam, R_cw[i], t_cw[i]) for i in range(n)],
        depth_map_factor=APPS_DEPTH_FACTOR)
    write_settings(os.path.join(rgbd, "settings.yaml"), dcam, fps=30.0,
                   n_features=1000, depth_map_factor=APPS_DEPTH_FACTOR)
    return dict(root=root, mono=mono, rgbd=rgbd, imgs=imgs, R_cw=R_cw)


def app_ms(times, metrics):
    """Median and mean ms/frame of the frames after initialization, from
    the per-frame host times an app returns (a chunk's frames share its
    time)."""
    init = next((i for i, r in enumerate(metrics) if r.get("ok")), 0)
    steady = [t * 1e3 for t in times[init + 1:]] or [float("nan")]
    return (f"{percentile(steady, 0.5):.2f}",
            f"{sum(steady) / len(steady):.2f}")


def run_apps_eval(torch, CH, inputs):
    """Phase 11a: python -m ar_orbslam2_tpu_torch.apps.run_eval tum, as a
    user runs it: load_settings, build_system at full width, precompile(),
    track_monocular_batch(chunk=8) through run_sequence, the trajectory
    files, ATE/RPE against groundtruth.txt and the 0.05 m gate."""
    from ar_orbslam2_tpu_torch.apps import run_dataset, run_eval
    d = inputs["mono"]
    prefix = os.path.join(inputs["root"], "eval")
    warm = {}
    real = run_dataset.precompile

    def counted(slam):              # the launches of the warm-up apart
        t0 = time.perf_counter()
        real(slam)
        torch.cuda.synchronize()
        warm.update(s=time.perf_counter() - t0,
                    launches=CH.fused_windowed_top2.launches)
        CH.fused_windowed_top2.launches = 0
    run_dataset.precompile = counted
    CH.fused_windowed_top2.launches = 0
    try:
        with KernelInputs(torch, CH) as rec:
            res = run_eval.run(["tum", os.path.join(d, "settings.yaml"), d,
                                "--gate-ate", str(ATE_GATE),
                                "--out", prefix])
    finally:
        run_dataset.precompile = real
    launches = CH.fused_windowed_top2.launches
    shapes = rec.check("apps-eval")
    slam = res["slam"]
    m = slam.tracking.metrics
    fused = sum(1 for r in m if r.get("fused"))
    med, mean = app_ms(res["times"], m)
    phase("apps-eval", command="run_eval tum", frames=len(m),
          code=res["code"], ate=res["ate"], rpe_t=res["rpe_t"],
          rpe_deg=res["rpe_r"], frames_evaluated=res["n_eval"],
          keyframes=slam.store.n_keyframes(), fused_frames=fused,
          chunked_frames=sum(1 for r in m if r.get("chunked")),
          precompile_s=f"{warm.get('s', float('nan')):.2f}",
          captures_after_warmup=slam.captures_after_warmup,
          ms_per_frame_median=med, ms_per_frame_mean=mean,
          kernel_launches=launches, precompile_launches=warm.get("launches"),
          launches_per_fused_frame=f"{launches / max(fused, 1):.2f}",
          searches_bit_identical=shapes)
    if res["code"] != 0:
        fail(f"apps-eval: run_eval exited {res['code']} (ATE {res['ate']})")
    for suffix in ("_tum.txt", "_kitti.txt"):
        if not os.path.getsize(prefix + suffix):
            fail(f"apps-eval: {prefix + suffix} is empty")
    if not warm:
        fail("apps-eval: run_eval did not precompile")
    if slam.captures_after_warmup != 0:
        fail(f"apps-eval: {slam.captures_after_warmup} graph captures after "
             "warm-up")
    if fused == 0 or launches < 2 * fused:
        fail(f"apps-eval: {launches} kernel launches for {fused} fused "
             "frames")
    return launches


def run_apps_ar(torch, CH, inputs):
    """Phase 11b: python -m ar_orbslam2_tpu_torch.apps.run_ar on the same
    directory: a cube anchored at frame APPS_CUBE_AT on the plane fitted to
    that frame's tracked landmarks, an overlay per frame whose tracked dots
    are that frame's keypoints."""
    import cv2
    import numpy as np

    from ar_orbslam2_tpu_torch.apps import run_ar
    from ar_orbslam2_tpu_torch.frontend.orb import OrbConfig, extract_orb
    d = inputs["mono"]
    out_dir = os.path.join(inputs["root"], "ar")
    read_ms = []
    real = run_ar.tracked_frame

    def timed(slam, rec):           # the fused frame's readback, timed
        lf = slam.tracking.last_frame
        t0 = time.perf_counter()
        frame = real(slam, rec)
        if lf is None or lf.frame_id != rec["frame_id"]:
            read_ms.append((time.perf_counter() - t0) * 1e3)
        return frame
    run_ar.tracked_frame = timed
    CH.fused_windowed_top2.launches = 0
    try:
        with KernelInputs(torch, CH) as rec:
            out = run_ar.main([os.path.join(d, "settings.yaml"), d,
                               "--out", out_dir,
                               "--max-frames", str(APPS_AR_FRAMES),
                               "--add-cube-at", str(APPS_CUBE_AT)])
    finally:
        run_ar.tracked_frame = real
    launches = CH.fused_windowed_top2.launches
    shapes = rec.check("apps-ar")
    slam, viewer = out["slam"], out["viewer"]
    m = slam.tracking.metrics
    fused = [r["frame_id"] for r in m if r.get("fused")]
    # the plane's normal in the camera of the cube's frame, estimated
    # (R_cw n) against the rendered plane's (world z = 3, facing the
    # camera) in the ground-truth camera: no alignment, no scale
    angle = float("nan")
    plane = viewer.plane
    rec_at = next((r for r in m if r["frame_id"] == APPS_CUBE_AT), {})
    if plane is not None and "R" in rec_at:
        n_est = rec_at["R"] @ plane.normal
        n_true = inputs["R_cw"][APPS_CUBE_AT] @ np.array([0.0, 0.0, -1.0])
        angle = float(np.degrees(np.arccos(np.clip(n_est @ n_true,
                                                   -1.0, 1.0))))
    shapes_ok = {cv2.imread(os.path.join(out_dir, f)).shape
                 for f in sorted(os.listdir(out_dir))}
    # every APPS_DOT_EVERY-th fused frame: its dots against an extraction
    # of its own image (the share that the image before it also has is
    # printed: consecutive frames share many integer corner positions)
    cfg = OrbConfig(n_features=slam.cfg.tracking.max_kp)

    def gaps(dots, i):
        f = extract_orb(torch.as_tensor(inputs["imgs"][i], device="cuda"),
                        cfg)
        kp = f["uv"][f["valid"]]
        dd = torch.as_tensor(dots, device="cuda")
        return (dd[:, None, :] - kp[None]).abs().amax(-1).amin(1).cpu()
    worst, stale_share, checked = 0.0, 0.0, 0
    for i in fused[::APPS_DOT_EVERY]:
        dots = out["dots"][i]
        if len(dots) == 0:
            fail(f"apps-ar: frame {i} drew no tracked dots")
        worst = max(worst, float(gaps(dots, i).max()))
        stale_share = max(stale_share, float(
            (gaps(dots, i - 1) <= APPS_DOT_TOL_PX).float().mean()))
        checked += 1
    med, mean = app_ms([t / 1e3 for t in out["frame_ms"]], m)
    phase("apps-ar", command="run_ar", frames=len(m),
          tracked=sum(1 for r in m if r.get("ok")), fused_frames=len(fused),
          cube_frame=out["cube_frame"], cubes=len(viewer.cubes),
          plane_inliers=None if plane is None else plane.n_inliers,
          normal_error_deg=f"{angle:.3f}",
          detect_plane_ms=(f"{out['plane_ms']:.2f}"
                           if out["plane_ms"] is not None else "none"),
          frame_readback_ms_median=(f"{percentile(read_ms, 0.5):.3f}"
                                    if read_ms else "none"),
          ms_per_frame_median=med, ms_per_frame_mean=mean,
          overlays=len(os.listdir(out_dir)),
          overlay_shapes=sorted(shapes_ok), dot_frames_checked=checked,
          dot_gap_px_max=worst,
          dots_also_on_previous_image_max=f"{stale_share:.3f}",
          captures=slam.n_captures, kernel_launches=launches,
          searches_bit_identical=shapes)
    if out["cube_frame"] != APPS_CUBE_AT or len(viewer.cubes) != 1:
        fail(f"apps-ar: {len(viewer.cubes)} cubes, anchored at "
             f"{out['cube_frame']} (one at {APPS_CUBE_AT} expected)")
    if plane.n_inliers < APPS_PLANE_INLIERS:
        fail(f"apps-ar: the plane kept {plane.n_inliers} inliers")
    if not angle < APPS_NORMAL_GATE_DEG:
        fail(f"apps-ar: the plane's normal is {angle:.2f} deg off")
    if len(os.listdir(out_dir)) != APPS_AR_FRAMES \
            or shapes_ok != {(502, 640, 3)}:
        fail(f"apps-ar: overlays {len(os.listdir(out_dir))} of shapes "
             f"{shapes_ok}")
    if out["drawn"] != list(range(APPS_AR_FRAMES)):
        fail(f"apps-ar: overlays drew frames {out['drawn']}")
    if checked == 0 or worst > APPS_DOT_TOL_PX:
        fail(f"apps-ar: tracked dots {worst} px from their image's "
             "keypoints")
    if launches < 2 * len(fused):
        fail(f"apps-ar: {launches} kernel launches for {len(fused)} fused "
             "frames")
    return launches


def run_apps_multi(torch, CH, inputs):
    """Phase 11c: python -m ar_orbslam2_tpu_torch.apps.run_multi
    --synthetic 2: two SlamSystems interleaved chunk by chunk on the card,
    each with its own captured frame step (no precompile, as in the JAX
    package)."""
    from ar_orbslam2_tpu_torch.apps import run_multi
    settings = os.path.join(inputs["mono"], "settings.yaml")
    CH.fused_windowed_top2.launches = 0
    with KernelInputs(torch, CH) as rec:
        out = run_multi.main([settings, "--synthetic", "2", "--frames",
                              str(APPS_MULTI_FRAMES), "--chunk", str(CHUNK)])
    launches = CH.fused_windowed_top2.launches
    shapes = rec.check("apps-multi")
    rows = []
    for src, slam in zip(out["sources"], out["systems"]):
        m = slam.tracking.metrics
        rows.append(dict(name=src["name"],
                         tracked=sum(1 for r in m if r.get("ok")),
                         frames=len(src["frames"]),
                         keyframes=slam.store.n_keyframes(),
                         fused=sum(1 for r in m if r.get("fused")),
                         captures=slam.n_captures))
    phase("apps-multi", command="run_multi --synthetic 2",
          aggregate_fps=f"{out['fps']:.2f}", wall_s=f"{out['wall_s']:.2f}",
          systems=json.dumps(rows, separators=(",", ":")),
          kernel_launches=launches, searches_bit_identical=shapes)
    stores = {id(s.store) for s in out["systems"]}
    if len(stores) != len(out["systems"]):
        fail("apps-multi: two systems share a store")
    for r in rows:
        if not r["tracked"] > APPS_MULTI_TRACKED * r["frames"] \
                or r["keyframes"] < 2:
            fail(f"apps-multi: {r}")
        if r["captures"] != 1:
            fail(f"apps-multi: {r['name']} captured {r['captures']} graphs "
                 "(its frame step once expected)")
    fused = sum(r["fused"] for r in rows)
    if fused == 0 or launches < 2 * fused:
        fail(f"apps-multi: {launches} kernel launches for {fused} fused "
             "frames")
    return launches


def run_apps_recall(torch):
    """Phase 11d: the loop-recall study at run_study's defaults on the card
    and on the CPU through the port: equal recalls and ranks, but for at
    most one query whose float32 score ties order differently."""
    from ar_orbslam2_tpu_torch.loop import recall_study
    t0 = time.perf_counter()
    card = recall_study.run_study(device="cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = recall_study.run_study(device="cpu")
    host_s = time.perf_counter() - t0
    for name, a, b in zip(("random", "k-medians"), card, host):
        differ = sum(x != y for x, y in zip(a["ranks"], b["ranks"]))
        summary = {k: v for k, v in a.items() if k != "ranks"}
        phase("apps-recall", codebook=name,
              card=json.dumps(summary, separators=(",", ":")),
              cpu=json.dumps({k: v for k, v in b.items() if k != "ranks"},
                             separators=(",", ":")),
              queries_ranked_differently=differ,
              card_s=f"{card_s:.2f}", cpu_s=f"{host_s:.2f}")
        if len(a["ranks"]) != len(b["ranks"]) or differ > 1:
            fail(f"apps-recall: {name}: {differ} queries ranked differently "
                 "on the card and on the CPU")


def run_apps_rgbd(torch, CH, inputs):
    """Phase 11e: run_eval tum-rgbd (run_dataset's RGB-D path: the 16-bit
    depth PNGs over DepthMapFactor, per-frame track_rgbd) and the ATE
    without scale alignment under the 0.05 m gate."""
    from ar_orbslam2_tpu_torch.apps import run_eval
    d = inputs["rgbd"]
    prefix = os.path.join(inputs["root"], "rgbd")
    CH.fused_windowed_top2.launches = 0
    with KernelInputs(torch, CH) as rec:
        res = run_eval.run(["tum-rgbd", os.path.join(d, "settings.yaml"), d,
                            "--gate-ate", str(ATE_GATE), "--out", prefix])
    launches = CH.fused_windowed_top2.launches
    shapes = rec.check("apps-rgbd")
    slam = res["slam"]
    m = slam.tracking.metrics
    med, mean = app_ms(res["times"], m)
    tracked = sum(1 for r in m if r.get("ok"))
    phase("apps-rgbd", command="run_eval tum-rgbd", frames=len(m),
          tracked=tracked, first_frame_tracked=bool(m and m[0].get("ok")),
          code=res["code"], ate_metric=res["ate"],
          fused_frames=sum(1 for r in m if r.get("fused")),
          keyframes=slam.store.n_keyframes(),
          ms_per_frame_median=med, ms_per_frame_mean=mean,
          kernel_launches=launches, searches_bit_identical=shapes)
    if res["code"] != 0:
        fail(f"apps-rgbd: run_eval exited {res['code']} (ATE {res['ate']})")
    if any(r.get("fused") for r in m) or tracked < TRACKED_SHARE_GATE * len(m):
        fail(f"apps-rgbd: {tracked}/{len(m)} tracked on the per-frame path")
    return launches


def run_apps_path(torch, CH):
    """Phase 11: the user's entry points on a dataset directory written
    under a temporary directory."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_apps_") as root:
        inputs = write_apps_inputs(root)
        launches = run_apps_eval(torch, CH, inputs)
        launches += run_apps_ar(torch, CH, inputs)
        launches += run_apps_multi(torch, CH, inputs)
        run_apps_recall(torch)
        launches += run_apps_rgbd(torch, CH, inputs)
    return launches


# ---------------------------------------------------------------------------
# phase 12: the distributed routes (parallel/) on the card
# ---------------------------------------------------------------------------
DIST_ROUTES = (("dense", dict(distributed=True, banded=False)),
               ("banded", dict(distributed=True, banded=True)))


def _dist_counted(dist):
    """Count the collectives issued through torch.distributed in this
    process: {name: calls}."""
    counts = {"all_reduce": 0, "all_gather_into_tensor": 0}
    for name in counts:
        real = getattr(dist, name)

        def counted(*a, _real=real, _name=name, **kw):
            counts[_name] += 1
            return _real(*a, **kw)
        setattr(dist, name, counted)
    return counts


def dist_rank(rank, world, device, map_path, out):
    """One rank of phase 12's group: 12a scaling_bench's problem at its
    defaults (65,536 landmarks x 64 cameras x 16 observations, 10 LM
    iterations), 12b global_bundle_adjustment's dense and banded routes on
    the saved map (a warm-up call, then a timed call, each on a fresh
    load), 12c multihost.selftest. Rank 0 saves the numbers."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ar_orbslam2_tpu_torch.core.camera import Camera
    from ar_orbslam2_tpu_torch.mapping import global_ba
    from ar_orbslam2_tpu_torch.mapstore.checkpoint import load_map
    from ar_orbslam2_tpu_torch.parallel import dist_ba, multihost
    from ar_orbslam2_tpu_torch.parallel import scaling_bench as sb
    counts = _dist_counted(dist)
    mesh = dist_ba.make_mesh(device=device)
    cam = Camera(**DIST_CAM_KW)
    per_iter, cost, calls = sb.run_on_mesh(
        mesh, sb.build_problem(), Camera(fx=500.0, fy=500.0, cx=320.0,
                                         cy=240.0))
    saved = dict(scaling_ms=per_iter * 1e3, scaling_cost=cost,
                 scaling_calls=calls, device=str(mesh.device))
    for name, kw in DIST_ROUTES:
        global_ba.global_bundle_adjustment(load_map(map_path), cam,
                                           device=device, **kw)
        store = load_map(map_path)
        before = dict(counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c = global_ba.global_bundle_adjustment(store, cam, device=device,
                                               **kw)
        saved.update({f"{name}_ms": (time.perf_counter() - t0) * 1e3,
                      f"{name}_cost": c, f"{name}_kf_t": store.kf_t,
                      f"{name}_mp_pos": store.mp_pos})
        for k in counts:
            saved[f"{name}_{k}"] = counts[k] - before[k]
    saved["selftest"] = multihost.selftest(device=device)
    dist.barrier()
    if rank == 0:
        np.savez(out, **saved)


def essential_graph_problem(torch, K, seed=7, drift=0.01):
    """tests/test_torch_sim3.py's drifted circle of K Sim3 vertices (the
    first fixed), with edges to the next vertex, the one after it and
    round the loop, as optimize_essential_graph's arguments on the card."""
    import numpy as np

    from ar_orbslam2_tpu_torch.core import lie
    rng = np.random.default_rng(seed)
    a = 2 * np.pi * np.arange(K) / K
    R = lie.so3_exp(torch.tensor(np.stack([0 * a, a, 0 * a], -1),
                                 dtype=torch.float32)).numpy()
    c = np.stack([np.cos(a), 0 * a, np.sin(a)], -1) * 3.0
    t = -(R @ c[..., None])[..., 0]
    ei = np.r_[np.arange(K), np.arange(K - 2)]
    ej = np.r_[(np.arange(K) + 1) % K, np.arange(2, K)]
    eR = R[ej] @ np.swapaxes(R[ei], -1, -2)
    et = t[ej] - (eR @ t[ei][..., None])[..., 0]
    dw = rng.normal(0, drift * np.arange(K)[:, None], (K, 3))
    R0 = lie.so3_exp(torch.tensor(dw, dtype=torch.float32)).numpy() @ R
    t0 = t + rng.normal(0, 2.5 * drift * np.arange(K)[:, None], (K, 3))
    E = len(ei)
    fixed = np.arange(K) == 0

    def dev(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device="cuda")
    return (dev(R0), dev(t0), dev(np.ones(K)), dev(np.ones(K), torch.bool),
            dev(fixed, torch.bool), dev(ei, torch.int32),
            dev(ej, torch.int32), dev(eR), dev(et), dev(np.ones(E)),
            dev(np.ones(E), torch.bool))


def solver_repro(torch, first, second, first_cost, second_cost):
    """One input, one result, for the solvers alone: two single-device
    global BAs of one loaded map (`first`, `second`) must leave the same
    keyframe poses and landmarks bit for bit, and the essential graph run
    twice on one input, on its dense path (K <= CG_THRESHOLD) and on its
    PCG path, the same poses."""
    import numpy as np

    from ar_orbslam2_tpu_torch.estimation import pose_graph
    kf, mp = second.keyframe_ids(), second.map_point_ids()
    gba_same = (np.array_equal(first.keyframe_ids(), kf)
                and np.array_equal(first.kf_R[kf], second.kf_R[kf])
                and np.array_equal(first.kf_t[kf], second.kf_t[kf])
                and np.array_equal(first.mp_pos[mp], second.mp_pos[mp])
                and first_cost == second_cost)
    numbers = dict(gba_bit_identical=gba_same,
                   gba_costs=f"{first_cost!r}/{second_cost!r}")
    faults = [] if gba_same else ["global BA"]
    for path, K in (("dense", pose_graph.CG_THRESHOLD // 2),
                    ("pcg", pose_graph.CG_THRESHOLD + 64)):
        args = essential_graph_problem(torch, K)
        runs, ms = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pose_graph.optimize_essential_graph(*args)
            runs.append([out[k].cpu().numpy() for k in ("R", "t", "s",
                                                        "cost")])
            ms.append((time.perf_counter() - t0) * 1e3)
        same = all(np.array_equal(a, b) for a, b in zip(*runs))
        numbers.update({f"essential_{path}_K": K,
                        f"essential_{path}_bit_identical": same,
                        f"essential_{path}_ms": "/".join(f"{x:.1f}"
                                                         for x in ms),
                        f"essential_{path}_cost": f"{float(runs[0][3]):.6g}"})
        if not same:
            faults.append(f"the essential graph's {path} path (K = {K})")
        if not all(np.isfinite(x).all() for x in runs[0]):
            faults.append(f"the essential graph's {path} path gave "
                          "non-finite poses")
    phase("solver-repro", **numbers)
    if faults:
        fail("solver-repro: another result on the second run of "
             + ", ".join(faults))


def run_dist_path(torch, CH):
    """Phase 12: a stereo map of a walk round a room with its loop closed
    (synthetic.stereo_loop_map: 100 keyframes, 16,000 landmarks, scale
    observed) saved with the port's
    checkpoint; global_bundle_adjustment on one device, then a group of
    one rank on NCCL and a group of two ranks on gloo sharing the card,
    each running dist_rank on the loaded map. Returns 0: no search runs
    on this path."""
    import tempfile
    import warnings

    import numpy as np

    from ar_orbslam2_tpu_torch.core.camera import Camera
    from ar_orbslam2_tpu_torch.data import synthetic
    from ar_orbslam2_tpu_torch.mapping import global_ba
    from ar_orbslam2_tpu_torch.mapstore.checkpoint import load_map, save_map
    from ar_orbslam2_tpu_torch.parallel import partition
    from ar_orbslam2_tpu_torch.parallel.multihost import (
        RankStoppedWarning, spawn_local)

    cam = Camera(**DIST_CAM_KW)
    t0 = time.perf_counter()
    built, _ = synthetic.stereo_loop_map(cam)
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as d:
        path = os.path.join(d, "map.npz")
        save_map(built, path)
        store = load_map(path)
        n_kf = store.n_keyframes()
        okf = store.mp_obs_kf[store.mp_valid]
        live_obs = int(store.kf_valid[okf[okf >= 0]].sum())
        band_w = {}
        for n in (1, 2):          # the banded layout covers every obs of
            # a live keyframe (tests/test_partition.py's invariant)
            gp = global_ba.gather_global_partitioned(store, n)
            lay = partition.banded_layout(store, n)
            band_w[n] = lay["band_w"]
            pos_of = np.full(store.cfg.max_keyframes, -1, np.int64)
            pos_of[lay["kf_order"]] = np.arange(len(lay["kf_order"]))
            for b, off in enumerate(lay["band_off"]):
                mps = lay["shard_mp"][b][lay["shard_mp"][b] >= 0]
                ps = pos_of[store.mp_obs_kf[mps][store.mp_obs_kf[mps] >= 0]]
                ps = ps[ps >= 0]
                if ((ps < off) | (ps >= off + lay["band_w"])).any():
                    fail(f"dist: {n} shards, shard {b} observes outside "
                         "its band")
            if int(gp["obs_valid"].sum()) != live_obs:
                fail(f"dist: the {n}-shard banded layout keeps "
                     f"{int(gp['obs_valid'].sum())} of {live_obs} "
                     "observations")
        if not band_w[2] < n_kf:
            fail(f"dist: the 2-shard band ({band_w[2]} cameras) is not "
                 f"narrower than the map ({n_kf} keyframes)")
        g = global_ba.gather_global(store)
        cost_before = float(global_ba.dispatch_global_ba(
            g, cam, n_iters=0, distributed=False, device="cuda")["cost"])
        first = load_map(path)      # warm-up, and the first of two runs
        first_cost = global_ba.global_bundle_adjustment(
            first, cam, distributed=False, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        single_cost = global_ba.global_bundle_adjustment(
            store, cam, distributed=False, device="cuda")
        single_ms = (time.perf_counter() - t1) * 1e3
        solver_repro(torch, first, store, first_cost, single_cost)
        res = {}
        for world, backend, device in ((1, "nccl", None),
                                       (2, "gloo", "cuda:0")):
            out = os.path.join(d, f"world{world}.npz")
            t1 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always", RankStoppedWarning)
                spawn_local(world, dist_rank, device, path, out,
                            backend=backend, timeout=DIST_SPAWN_LIMIT_S)
            stopped = [str(w.message) for w in caught
                       if issubclass(w.category, RankStoppedWarning)]
            if stopped:
                # a rank that hung after its work: printed with its stacks
                phase("dist-stopped-rank", world=world, backend=backend,
                      spawn_s=f"{time.perf_counter() - t1:.2f}")
                print("\n".join(stopped), flush=True)
                fail(f"dist: world {world} ({backend}): {stopped[0]}")
            res[world] = dict(np.load(out), spawn_s=time.perf_counter() - t1)
    kf, mp = store.keyframe_ids(), store.map_point_ids()
    w1, w2 = res[1], res[2]
    phase("dist-scaling", points=65536, cams=64, opp=16, iters=10,
          world1_nccl_ms_per_iter=f"{float(w1['scaling_ms']):.3f}",
          world2_gloo_shared_card_ms_per_iter=
          f"{float(w2['scaling_ms']):.3f}",
          cost_world1=f"{float(w1['scaling_cost']):.6g}",
          cost_world2=f"{float(w2['scaling_cost']):.6g}",
          collectives_per_iter=f"{float(w1['scaling_calls']):g}",
          devices=f"{w1['device']}/{w2['device']}")
    rel = abs(float(w2["scaling_cost"]) - float(w1["scaling_cost"])) \
        / abs(float(w1["scaling_cost"]))
    if not rel <= DIST_WORLD_TOL:
        fail(f"dist-scaling: world 2's cost is {rel:.2e} from world 1's")
    n_iter = 20                     # global_bundle_adjustment's default
    numbers = dict(keyframes=len(kf), landmarks=len(mp),
                   band_w_2_shards=band_w[2], band_w_1_shard=band_w[1],
                   cost_before=f"{cost_before:.6g}",
                   single_cost=f"{single_cost:.6g}",
                   single_ms=f"{single_ms:.2f}")
    faults = []                     # every number is printed before a fail
    for world, r in res.items():
        for name, _ in DIST_ROUTES:
            numbers[f"w{world}_{name}_ms"] = f"{float(r[name + '_ms']):.2f}"
            numbers[f"w{world}_{name}_cost"] = \
                f"{float(r[name + '_cost']):.6g}"
            numbers[f"w{world}_{name}_collectives_per_iter"] = round(
                (int(r[name + "_all_reduce"])
                 + int(r[name + "_all_gather_into_tensor"])) / n_iter, 2)
        dt = np.linalg.norm(r["banded_kf_t"][kf] - r["dense_kf_t"][kf],
                            axis=1).max()
        dp = np.median(np.linalg.norm(r["banded_mp_pos"][mp]
                                      - r["dense_mp_pos"][mp], axis=1))
        numbers[f"w{world}_banded_vs_dense_t"] = f"{dt:.2e}"
        numbers[f"w{world}_banded_vs_dense_mp_median"] = f"{dp:.2e}"
        if not (dt < BAND_TOL and dp < BAND_TOL):
            faults.append(f"world {world} banded vs dense {dt:.2e} "
                          f"(translations), {dp:.2e} (median landmark) >= "
                          f"{BAND_TOL}")
        for name, _ in DIST_ROUTES + (("single", None),):
            c = single_cost if name == "single" else float(r[name + "_cost"])
            if not (np.isfinite(c) and c < cost_before):
                faults.append(f"the {name} route's cost {c} is not below "
                              f"the cost before global BA {cost_before}")
    for name, _ in DIST_ROUTES:
        # world 2 vs world 1: only the order of the float32 sums differs
        # (the map's gauge is fixed: keyframe 0 and the stereo scale); the
        # routes at world 1 differ among themselves by as much
        dt = np.abs(w2[name + "_kf_t"][kf] - w1[name + "_kf_t"][kf]).max()
        dp = np.linalg.norm(w2[name + "_mp_pos"][mp]
                            - w1[name + "_mp_pos"][mp], axis=1)
        dc = abs(float(w2[name + "_cost"]) - float(w1[name + "_cost"])) \
            / float(w1[name + "_cost"])
        numbers[f"{name}_w2_vs_w1_t_cost"] = f"{dt:.2e}/{dc:.2e}"
        numbers[f"{name}_w2_vs_w1_mp_median_p90"] = \
            f"{np.median(dp):.2e}/{np.percentile(dp, 90):.2e}"
        if not (dc <= DIST_WORLD_TOL
                and max(dt, np.median(dp)) <= DIST_WORLD_POS_TOL):
            faults.append(f"{name} world 2 vs world 1: cost {dc:.2e} "
                          f"(tolerance {DIST_WORLD_TOL}), translations "
                          f"{dt:.2e}, median landmark {np.median(dp):.2e} "
                          f"(tolerance {DIST_WORLD_POS_TOL} m)")
    phase("dist-gba", map_build_s=f"{build_s:.2f}",
          spawn_s=f"{w1['spawn_s']:.2f}/{w2['spawn_s']:.2f}", **numbers)
    if faults:
        fail("dist-gba: " + "; ".join(faults))
    if int(w1["selftest"]) != 0 or int(w2["selftest"]) != 0:
        fail(f"dist-selftest: return codes {int(w1['selftest'])} (world 1), "
             f"{int(w2['selftest'])} (world 2)")
    phase("dist-selftest", world1_nccl=int(w1["selftest"]),
          world2_gloo=int(w2["selftest"]))
    return 0


# ---------------------------------------------------------------------------
# a phase in a process of its own, beside a longer one
# ---------------------------------------------------------------------------
BESIDE = (10, 11, 12)  # run beside phase 8: 8, 10 and 11 wait on the
#                        host, and none of 10's, 11's or 12's gates reads
#                        a time
BESIDE_LIMIT_S = 600  # the most they may take after phase 8


def start_beside(phases):
    """Start ``chip_smoke.py --phases <phases>`` in a child process, its
    output to a temporary file; it is stopped if this process exits
    first."""
    import atexit
    import tempfile
    out = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--phases",
         ",".join(map(str, phases)), "--contended-with", "8"],
        stdout=out, stderr=subprocess.STDOUT, text=True)
    atexit.register(stop_child, proc)
    return proc, out


def stop_child(proc):
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def finish_beside(phases, proc, out):
    """Wait for the process of `phases`, print its phase lines, and return
    (its kernel launches on the main path, {phase: seconds}); fail if it
    failed."""
    try:
        rc = proc.wait(timeout=BESIDE_LIMIT_S)
    except subprocess.TimeoutExpired:
        stop_child(proc)
        rc = None
    out.seek(0)
    lines = out.read().splitlines()
    numbers = {}
    for line in lines:
        if line.startswith(("[launches]", "[timing]")):
            numbers.update(kv.split("=", 1) for kv in line.split()[1:])
        elif line.startswith("[") and not line.startswith(("[card]",
                                                           "[build]")):
            print(line, flush=True)
    if rc != 0:
        print("\n".join(lines[-200:]), file=sys.stderr, flush=True)
        fail(f"phases {phases}, run beside phase 8, "
             + ("did not finish" if rc is None else f"exited with {rc}")
             + ": " + " | ".join(lines[-3:]))
    return int(numbers["main_path"]), {
        n: float(numbers[f"phase{n}_s"]) for n in phases}


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="",
                    help="comma-separated phases of 3-12 to run alone, for "
                         "development (the result lines are then withheld)")
    ap.add_argument("--contended-with", default="",
                    help="phases another process runs meanwhile, named on "
                         "every phase line (the script sets it for the "
                         "process it starts beside phase 8)")
    opts = ap.parse_args()
    only = {int(x) for x in opts.phases.split(",") if x}
    CONTENDED[:] = [int(x) for x in opts.contended_with.split(",") if x]
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
    card_line = smi.stdout.strip().splitlines()[0]
    print(card_line, flush=True)
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

    def wanted(n):
        return not only or n in only

    seconds = {}

    def timed(n, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[n] = round(time.perf_counter() - t0, 1)
        return out

    # 3. kernel vs plain version
    profiled, rec = timed(3, lambda: check_kernel(torch, CH)) if wanted(3) \
        else ({}, {})

    # 4. per-frame main path
    launches = timed(4, lambda: run_main_path(torch, CH)) if wanted(4) \
        else 0

    # 5. graph replay vs eager
    if wanted(5):
        timed(5, lambda: run_graph_check(torch, CH))

    # 6-12: the fused, chunked, pipelined main path; loss and
    # relocalization on it; loop closing, inline and on the mapping worker;
    # the configuration bench.py builds; the depth sensors; the apps; the
    # distributed routes. Phases 10, 11 and 12 run in a process of their
    # own beside phase 8 when it runs (BESIDE).
    beside = [m for m in BESIDE if wanted(m)] if wanted(8) else []
    for n, run in ((6, run_fused_path), (7, run_reloc_path),
                   (8, run_loop_path), (9, run_default_config),
                   (10, run_depth_path), (11, run_apps_path),
                   (12, run_dist_path)):
        if not wanted(n) or n in beside:
            continue
        child = start_beside(beside) if beside and n == 8 else None
        if child:
            CONTENDED[:] = beside
        launches += timed(n, lambda: run(torch, CH))
        if child:
            CONTENDED[:] = []
            n_child, child_seconds = finish_beside(beside, *child)
            seconds.update(child_seconds)
            launches += n_child
    phase("timing", **{f"phase{n}_s": v for n, v in seconds.items()},
          total_s=round(time.perf_counter() - START, 1),
          **({"contended": ",".join(map(str, [8] + beside))} if beside
             else {}))
    rec["launches"] = launches
    torch.cuda.synchronize()
    if profiled:                # the profiler last: see profile_searches
        profile_searches(torch, profiled, rec)
    if only:
        phase("launches", main_path=launches)
        print(f"phases {sorted(only)} passed; run without --phases for "
              "the result lines", flush=True)
        return

    print(card_line, flush=True)
    print(json.dumps({"kernels": [rec]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
