"""One run of one cell: set-up, the timed window, the traced sub-window
(``--trace 1``), and the check of what the window produced.

What a run drives is the user's path of ``ar_orbslam2_tpu_torch``:
``load_settings`` on the configuration's published settings file,
``apps.common.build_system`` (async mapping, loop closing and
relocalization on), ``apps.common.precompile``, then one
``SlamSystem.track_monocular_batch(frames[i:i+chunk], timestamps,
chunk=chunk)`` call after another in a closed loop, with host uint8
frames as a camera delivers them and timestamps = frame index / fps.

Set-up (``setup_s``: process start to the first timed call) renders the
traffic on the device, builds and precompiles the system, initialises
the map, and feeds the traffic's set-up frames (at least two fused chunk
calls after initialisation, so that every shape the window uses has run).
The window runs calls until ``seconds`` have passed, over frames it never
reuses; a traffic that runs out of frames fails the run.
"""
from __future__ import annotations

import contextlib
import gc
import math
import sys
import time
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from . import scenes
from . import spans as SP
from . import trace as TR
from .catalog import Catalog
from .reference import check as CHK
from .roofline import hamming as RH

PROFILED_CALLS = 2          # chunk calls under the profiler (--trace 1)
MIN_FUSED_SETUP_CALLS = 2   # chunk calls after initialisation in set-up
ORB_SAMPLES = 3             # window calls whose frames' ORB is checked
ORB_FRAMES_PER_SAMPLE = 2
WINDOW_MARK = "slambench.traced_window"
CALL_MARK = "slambench.call"
CLOCK_MARK = "slambench.clock"
FORBIDDEN = ("jax", "jaxlib", "flax", "ar_orbslam2_tpu")


class BenchError(RuntimeError):
    """The run cannot give a result (no card, traffic used up, ...)."""


def forbidden_modules(names=None):
    """Top-level names of loaded modules that the benchmark must not load,
    each module name compared by its part before the first dot."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    settings: object
    chunk: int
    base: str               # where the cell's kinds were found

    @property
    def orb_params(self):
        s = self.settings
        return dict(n_features=max(512, 1 << (s.n_features - 1).bit_length()),
                    scale_factor=s.scale_factor, n_levels=s.n_levels,
                    ini_th=s.ini_th_fast, min_th=s.min_th_fast)


def load_cell(name, catalog=None) -> Cell:
    from ar_orbslam2_tpu_torch.utils.config import load_settings
    cat = catalog or Catalog()
    w = cat.workload(name)
    cfg = cat.config(w["config"])
    img = cfg["image"]
    settings = load_settings(cfg["settings_path"], img["width"],
                             img["height"])
    return Cell(name, int(w["chips"]), cfg, cat.traffic(w["traffic"]),
                cat.limits(name), settings, int(cfg["system"]["chunk"]),
                cat.base)


def frames_needed(cell: Cell, seconds: float) -> int:
    t, c = cell.traffic, cell.chunk
    n = (t["init_frames_max"] + max(t["setup_frames_after_init"],
                                    MIN_FUSED_SETUP_CALLS * c)
         + math.ceil(t["render_fps"] * seconds) + (PROFILED_CALLS + 2) * c)
    return c * math.ceil(n / c)


def _pose_arrays(poses):
    R = np.stack([p[:3, :3] for p in poses]).astype(np.float64)
    t = np.stack([p[:3, 3] for p in poses]).astype(np.float64)
    return R, t


class Run:
    """State of one run; ``execute`` returns the result dict."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device="cuda", precompile=True, fault=None,
                 t_start=None):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace, self.precompile = bool(trace), precompile
        self.device = torch.device(device)
        self.fault = fault
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.spans = SP.Spans()
        self.recorder = None

    @staticmethod
    def say(*a):
        print(*a, file=sys.stderr, flush=True)

    # ------------------------------------------------------------------
    def _call(self, slam, i):
        c = self.cell.chunk
        t0 = time.perf_counter_ns()
        poses = slam.track_monocular_batch(
            self.frame_list[i:i + c], timestamps=list(self.ts[i:i + c]),
            chunk=c)
        t1 = time.perf_counter_ns()
        self.spans.record("chunk_call", t0, t1)
        return poses, t0, t1

    def _build(self):
        from ar_orbslam2_tpu_torch.apps import common
        from ar_orbslam2_tpu_torch.ops import cuda_hamming
        sysc = self.cell.config["system"]
        if self.trace and self.device.type == "cuda":
            self.recorder = RH.Recorder(cuda_hamming)
        slam = common.build_system(
            self.cell.settings, sensor=sysc["sensor"],
            enable_loops=sysc["enable_loops"],
            async_mapping=sysc["async_mapping"], device=self.device)
        if self.recorder is not None:
            self.recorder.watch_capture(slam.tracking.fused.runner)
        if self.fault is not None:
            self.fault(slam)
        if self.precompile:
            common.precompile(slam)
        if self.trace:
            SP.instrument(slam, self.spans)
        return slam

    def _setup_frames(self, slam):
        t, c = self.cell.traffic, self.cell.chunk
        i = 0
        while slam.tracking.state != "OK":
            if i >= t["init_frames_max"]:
                raise BenchError(f"not initialised after {i} frames")
            self._call(slam, i)
            i += c
        self.init_frames = i
        more = max(t["setup_frames_after_init"], MIN_FUSED_SETUP_CALLS * c)
        end = i + c * math.ceil(more / c)
        while i < end:
            self._call(slam, i)
            i += c
        return i

    def _window(self, slam, i):
        c = self.cell.chunk
        rng = np.random.default_rng(self.seed)
        sample_at = sorted(rng.uniform(0, self.seconds, ORB_SAMPLES))
        fe = slam.tracking.fused
        calls, held = [], []
        t_first = time.perf_counter()
        self.setup_s = t_first - self.t_start
        deadline = t_first + self.seconds
        while True:
            if i + c > len(self.frame_list):
                raise BenchError(f"the traffic ran out of frames at {i}: "
                                 "render_fps is too low for this rate")
            poses, t0, t1 = self._call(slam, i)
            calls.append((i, t0, t1, poses))
            # a call that ends past a sample time is sampled (once)
            due = [x for x in sample_at if x <= t1 / 1e9 - t_first]
            if due and self._chunked(slam, i):
                sample_at = sample_at[len(due):]
                held.append((i, fe._chunk_snaps))
            i += c
            if t1 / 1e9 >= deadline:
                break
        return calls, held, i

    def _chunked(self, slam, i):
        """Whether the call at frame i ran as one fused chunk (so the
        frontend's chunk snapshots are its frames')."""
        c = self.cell.chunk
        recs = slam.tracking.metrics[-c:]
        return (len(recs) == c and slam.tracking.fused._chunk_snaps is not None
                and all(r.get("chunked") and r["frame_id"] == i + k
                        for k, r in enumerate(recs)))

    def _traced(self, slam, i):
        """PROFILED_CALLS more calls under one torch.profiler session."""
        from torch.profiler import ProfilerActivity, profile, record_function
        rec = self.recorder
        graph_inputs = []
        if rec is not None:
            rec.eager = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            c0 = time.perf_counter_ns()
            with record_function(CLOCK_MARK):
                pass
            c1 = time.perf_counter_ns()
            with record_function(WINDOW_MARK):
                for _ in range(PROFILED_CALLS):
                    if i + self.cell.chunk > len(self.frame_list):
                        raise BenchError("no frames left to trace")
                    with record_function(CALL_MARK):
                        self._call(slam, i)
                    i += self.cell.chunk
                    if rec is not None:
                        graph_inputs.append(
                            [(tuple(x.to("cpu", copy=True)
                                    if torch.is_tensor(x) else x
                                    for x in a), raw)
                             for a, raw in rec.graph])
        torch.cuda.synchronize()
        summary = TR.reduce(prof, WINDOW_MARK, CLOCK_MARK, CALL_MARK,
                            (c0 + c1) // 2, self.spans.spans)
        roof = None
        if summary is not None and rec is not None:
            roof = self._roofline(summary, summary.calls, graph_inputs,
                                  rec.eager)
            rec.eager = None
        return summary, roof

    def _roofline(self, summary, calls, graph_inputs, eager):
        """(least seconds, kernel seconds, bound counts) of the Hamming
        launches whose inputs are known: the searches of the last replay
        of each traced call, and every eager launch in the sub-window."""
        least = spent = 0.0
        bounds = {"operations": 0, "bytes": 0}
        ham = [o for o in summary.ops if RH.Recorder.KERNEL in o.name]
        for (lo, hi), inputs in zip(calls, graph_inputs):
            mine = [o for o in ham if o.graph and lo <= o.start <= hi]
            if not mine or not inputs:
                continue
            last = max(o.launch for o in mine)
            last_ops = sorted((o for o in mine if o.launch == last),
                              key=lambda o: o.start)
            if len(last_ops) != len(inputs):
                self.say(f"[roofline] replay has {len(last_ops)} search "
                         f"kernels, {len(inputs)} captured searches: skipped")
                continue
            for o, (args, raw) in zip(last_ops, inputs):
                s, b = RH.least_seconds(*RH.work(args, raw))
                least += s
                bounds[b] += 1
                spent += (o.end - o.start) / 1e9
        eager_ops = [o for o in ham if not o.graph]
        if eager and len(eager_ops) == len(eager):
            for o, (args, raw) in zip(eager_ops, eager):
                s, b = RH.least_seconds(*RH.work(args, raw))
                least += s
                bounds[b] += 1
                spent += (o.end - o.start) / 1e9
        elif eager or eager_ops:
            self.say(f"[roofline] {len(eager)} eager searches recorded, "
                     f"{len(eager_ops)} eager search kernels traced: "
                     "eager launches left out")
        return (least, spent, bounds) if spent > 0 else None

    # ------------------------------------------------------------------
    def execute(self) -> dict:
        cell = self.cell
        cam = cell.settings.camera
        n = frames_needed(cell, self.seconds)
        self.seq = scenes.render(cell.traffic, cam, n, self.seed,
                                 self.device, base=cell.base)
        self.frame_list = list(self.seq.images)
        fps = cell.settings.fps
        self.ts = np.arange(n, dtype=np.float64) / fps
        slam = self._build()
        i = self._setup_frames(slam)
        w0 = i
        calls, held, i = self._window(slam, i)
        w1 = i
        dev = {"platform": "gpu" if self.device.type == "cuda" else "cpu",
               "kind": (torch.cuda.get_device_name(self.device)
                        if self.device.type == "cuda" else "cpu"),
               "count": cell.chips,
               "memory_peak_bytes": (torch.cuda.max_memory_allocated(
                   self.device) if self.device.type == "cuda" else 0)}
        captures = slam.captures_after_warmup
        summary = roof = None
        if self.trace and self.device.type == "cuda":
            summary, roof = self._traced(slam, i)
        slam.shutdown()
        if self.recorder is not None:
            self.recorder.close()

        # ---- what the window produced, on the host; the program freed --
        poses = [p for *_, ps in calls for p in ps]
        ok = np.array([p is not None for p in poses])
        records = [r for r in slam.tracking.metrics
                   if w0 <= r.get("frame_id", -1) < w1]
        s = slam.store
        kf = s.keyframe_ids()
        map_out = dict(kf_R=s.kf_R[kf].copy(), kf_t=s.kf_t[kf].copy(),
                       kf_frame=s.kf_frame_id[kf].copy(),
                       points=s.mp_pos[s.map_point_ids()].astype(np.float64))
        orb_frames = self._orb_frames(held)
        del slam, held
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

        timing = [(t0, t1, len(ps)) for _, t0, t1, ps in calls]
        e2e = end_to_end(timing, self.setup_s)
        window_s = e2e.pop("window_s")

        # ---- the check ----------------------------------------------
        readings = check_readings(cell, self.seq, w0, poses, map_out,
                                  orb_frames)
        correct, lines = CHK.judge(readings, cell.limits)

        out = dict(correct=correct, attempted=int(len(poses)),
                   failed=int((~ok).sum()), e2e=e2e, device=dev,
                   readings=readings, lines=lines, window_s=window_s,
                   captures_after_warmup=captures, records=records,
                   timing=timing,
                   spans=[x for x in self.spans.spans
                          if calls[0][1] <= x.t0 and x.t1 <= calls[-1][2]],
                   summary=summary, roofline=roof,
                   init_frames=self.init_frames, window_frames=(w0, w1),
                   calls=[ps for *_, ps in calls], map=map_out,
                   orb_frames=orb_frames)
        return out

    def _orb_frames(self, held):
        """Host copies of the held chunk snapshots: [(frame index, dict(uv,
        octave, desc bits))] for ORB_FRAMES_PER_SAMPLE frames of each,
        drawn from the seed."""
        rng = np.random.default_rng(self.seed + 1)
        out = []
        for start, snaps in held:
            for j in sorted(rng.choice(self.cell.chunk,
                                       ORB_FRAMES_PER_SAMPLE, replace=False)):
                host = {k: snaps[k][j].cpu().numpy()
                        for k in ("valid", "uv", "oct", "desc")}
                ok = host["valid"].astype(bool)
                out.append((start + int(j), dict(
                    uv=host["uv"][ok].astype(np.float64),
                    octave=host["oct"][ok],
                    desc=CHK.unpack_desc(host["desc"][ok]))))
        return out


def end_to_end(calls, setup_s):
    """The end-to-end metrics of a window of calls [(start ns, return ns,
    frames)]: frames returned over the time from the first call's start
    to the last call's return, and the set-up time."""
    window_s = (calls[-1][1] - calls[0][0]) / 1e9
    return dict(track_fps=sum(n for *_, n in calls) / window_s,
                setup_s=setup_s, window_s=window_s)


def check_readings(cell, seq, w0, poses, map_out, orb_frames):
    """The numbers the check compares, from the window's returned poses
    (frame w0 on), the map after the run and the sampled frames' ORB."""
    ok = np.array([p is not None for p in poses])
    frame_ids = np.arange(w0, w0 + len(poses))
    readings = dict(failed_frames=float((~ok).sum()))
    if ok.sum() >= 3:
        R, t = _pose_arrays([p for p in poses if p is not None])
        readings.update(CHK.pose_readings(
            seq.R_cw[frame_ids[ok]], seq.t_cw[frame_ids[ok]], R, t))
    if len(map_out["kf_frame"]) >= 3:
        fr = map_out["kf_frame"]
        readings.update(CHK.map_readings(
            seq.R_cw[fr], seq.t_cw[fr], map_out["kf_R"], map_out["kf_t"],
            map_out["points"], seq.scene.distance))
    if orb_frames:
        readings["orb_bit_err_pct"] = CHK.orb_reading(
            orb_frames, seq.images, cell.settings.camera, cell.orb_params)
    return readings


def per_layer(cell_name, out, catalog=None):
    """{metric: value} of the cell's per-layer metrics that found
    something to read."""
    cat = catalog or Catalog()
    ctx = SimpleNamespace(records=out["records"], spans=out["spans"],
                          trace=out["summary"], roofline=out["roofline"],
                          frames=out["attempted"], calls=out["timing"])
    got = {}
    for m in cat.metrics(cell_name, "per_layer"):
        v = cat.reader(m["name"])(ctx)
        if v is not None:
            got[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return got


def result_line(cell_name, out, trace, catalog=None) -> dict:
    """The run's last stdout line, with the compared numbers last."""
    cat = catalog or Catalog()
    if trace:
        metrics = per_layer(cell_name, out, cat)
    else:
        metrics = {m["name"]: {"value": float(out["e2e"][m["name"]]),
                               "unit": m["unit"]}
                   for m in cat.metrics(cell_name, "end_to_end")}
    dev = dict(out["device"])
    line = dict(correct=bool(out["correct"]), attempted=out["attempted"],
                failed=out["failed"], metrics=metrics, device=dev)
    sm = out["summary"]
    if trace and sm is not None:
        dev["busy_s"] = sm.busy_s
        dev["window_s"] = sm.window_s
        line["breakdown"] = {"device_ops": sm.device_ops,
                             "idle_gaps": sm.idle_gaps}
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit, _ in out["lines"]}
    return line


@contextlib.contextmanager
def stdout_to_stderr():
    """The program's prints go to standard error: standard output ends
    with the result line alone."""
    with contextlib.redirect_stdout(sys.stderr):
        yield
