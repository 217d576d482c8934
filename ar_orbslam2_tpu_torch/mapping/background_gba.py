"""Background, abortable global bundle adjustment.

Port of ar_orbslam2_tpu/mapping/background_gba.py (parity:
LoopClosing::RunGlobalBundleAdjustment, src/LoopClosing.cc, and the
mbStopGBA abort protocol): full-map BA runs while tracking and mapping go
on, a new loop aborts it, and on completion the corrected poses are
propagated to keyframes created meanwhile through the spanning tree.

On a CUDA device the map is snapshotted on the calling thread, and a
dispatch thread of the job's own enqueues the BA on a dedicated CUDA
stream and records an event after the result: the reference runs GBA in a
thread of its own, and in eager torch enqueuing the BA's kernels occupies
a host thread for about as long as the device runs them, which must not be
the mapping worker's. ``poll(block=False)`` asks that event
(``event.query()``, where the JAX package asks ``is_ready()``), ``poll(
block=True)`` waits for it; the write-back and the propagation run under
``store.lock`` and bump the store's version, so the fused tracking state
re-anchors at its next chunk. An aborted job is dropped unapplied, but its
tensors stay referenced until its stream has finished with them. On the
CPU the BA runs inside ``launch``: the job has finished when it returns.
The BA stays on this rank's device even inside a process group
(``distributed=False``): a loop is closed by one process, whose peers
would never join the distributed route's collectives.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..core.device import resolve_device
from .global_ba import dispatch_global_ba, gather_global, read_result


class _Job:
    __slots__ = ("g", "kf_seq", "kf_in", "mp_in", "res", "start", "event",
                 "thread", "error", "enqueue_ms")

    def __init__(self, g, kf_seq):
        self.g = g
        # keyframes by (slot, creation number): a slot reused while the BA
        # ran holds a keyframe the BA never saw
        self.kf_seq = kf_seq
        self.kf_in = set(zip((int(k) for k in g["kf_arr"][:g["n_kf"]]),
                             (int(q) for q in kf_seq)))
        self.mp_in = set(int(m) for m in g["mp_arr"][:g["n_mp"]])
        self.res = None
        self.start = None           # CUDA events around the BA
        self.event = None
        self.thread = None
        self.error = None
        self.enqueue_ms = None      # host time of the dispatch

    def finished(self) -> bool:
        """The dispatch is over and the device has run it (no wait)."""
        if self.thread is not None and self.thread.is_alive():
            return False
        return self.event is None or self.event.query()

    def wait(self):
        if self.thread is not None:
            self.thread.join()
        if self.event is not None:
            self.event.synchronize()


class BackgroundGBA:
    """Abortable asynchronous full-map BA with post-hoc propagation."""

    def __init__(self, store, cam, n_iters: int = 20, device=None):
        self.store = store
        self.cam = cam
        self.n_iters = n_iters
        self.device = resolve_device(device)
        self._stream = None         # made on first CUDA launch
        self._job = None
        self._dropped: list = []    # aborted jobs still running on device
        self.n_launched = 0
        self.n_applied = 0
        self.n_aborted = 0
        self.last_stats: dict = {}

    # ------------------------------------------------------------------
    def running(self) -> bool:
        return self._job is not None

    def abort(self):
        """Parity: mbStopGBA — drop the in-flight result unapplied."""
        if self._job is not None:
            self._dropped.append(self._job)
            self._job = None
            self.n_aborted += 1
        self._dropped = [j for j in self._dropped if not j.finished()]

    def launch(self):
        """Snapshot the map and dispatch full BA asynchronously."""
        if self._job is not None:
            self.abort()
        g = gather_global(self.store)
        job = _Job(g, self.store.kf_seq[g["kf_arr"][:g["n_kf"]]].copy())
        if self.device.type == "cuda":
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            job.start = torch.cuda.Event(enable_timing=True)
            job.event = torch.cuda.Event(enable_timing=True)
            job.thread = threading.Thread(target=self._dispatch, args=(job,),
                                          daemon=True, name="global-ba")
            job.thread.start()
        else:
            self._dispatch(job)
        self._job = job
        self.n_launched += 1

    def _dispatch(self, job):
        t0 = time.perf_counter()
        try:
            if self.device.type == "cuda":
                with torch.cuda.stream(self._stream):
                    job.start.record()
                    job.res = dispatch_global_ba(job.g, self.cam,
                                                 n_iters=self.n_iters,
                                                 distributed=False,
                                                 device=self.device)
                    job.event.record()
            else:
                job.res = dispatch_global_ba(job.g, self.cam,
                                             n_iters=self.n_iters,
                                             distributed=False,
                                             device=self.device)
        except BaseException as e:      # raised by poll on the caller
            job.error = e
        job.enqueue_ms = (time.perf_counter() - t0) * 1e3

    # ------------------------------------------------------------------
    def poll(self, block: bool = False) -> bool:
        """Apply the result if finished (or wait for it if block=True).
        Returns True when a write-back happened."""
        job = self._job
        if job is None:
            return False
        if block:
            job.wait()
        elif not job.finished():
            return False
        self._job = None
        if job.error is not None:
            raise RuntimeError("background global BA failed") from job.error
        stats = dict(n_kf=job.g["n_kf"], n_mp=job.g["n_mp"],
                     enqueue_ms=job.enqueue_ms)
        if job.event is not None:
            stats["device_ms"] = job.start.elapsed_time(job.event)
            with torch.cuda.stream(self._stream):
                cam_R, cam_t, pts, _ = read_result(job.res)
        else:
            cam_R, cam_t, pts, _ = read_result(job.res)
        with self.store.lock:
            self._apply_locked(job, cam_R, cam_t, pts)
        self.n_applied += 1
        self.last_stats = stats
        return True

    # ------------------------------------------------------------------
    def _apply_locked(self, job, cam_R, cam_t, pts):
        """Write back + propagate (the stop-the-mapper section of
        RunGlobalBundleAdjustment). Caller holds store.lock."""
        s, g = self.store, job.g
        nk, nm = g["n_kf"], g["n_mp"]
        kf_ids = g["kf_arr"][:nk]
        ok_R = (np.isfinite(cam_R[:nk]).all((-1, -2))
                & np.isfinite(cam_t[:nk]).all(-1))
        upd = kf_ids[ok_R]
        # pre-write-back snapshot (APPLY time, not launch time): every
        # keyframe, including ones created while the BA ran, has its
        # current old-map-frame pose here, which is what the relative-pose
        # propagation below is anchored to
        old_R, old_t = s.kf_R.copy(), s.kf_t.copy()
        alive = s.kf_valid[upd] & (s.kf_seq[upd] == job.kf_seq[ok_R])
        s.kf_R[upd[alive]] = cam_R[:nk][ok_R][alive]
        s.kf_t[upd[alive]] = cam_t[:nk][ok_R][alive]

        # ---- spanning-tree propagation for keyframes created since ----
        in_ba = {k for k, q in job.kf_in if s.kf_seq[k] == q}
        for k in [int(k) for k in s.keyframe_ids() if int(k) not in in_ba]:
            anc = int(s.kf_parent[k])
            hops = 0
            while anc >= 0 and anc not in in_ba and hops < 64:
                anc = int(s.kf_parent[anc])
                hops += 1
            if anc < 0 or anc not in in_ba:
                continue
            # T_k_new = (T_k_old ∘ T_anc_old^-1) ∘ T_anc_new
            R_rel = old_R[k] @ old_R[anc].T
            t_rel = old_t[k] - R_rel @ old_t[anc]
            s.kf_R[k] = R_rel @ s.kf_R[anc]
            s.kf_t[k] = R_rel @ s.kf_t[anc] + t_rel

        # ---- landmarks -------------------------------------------------
        mp_ids = g["mp_arr"][:nm]
        ok_p = np.isfinite(pts[:nm]).all(-1)
        sel = mp_ids[ok_p]
        alive_p = s.mp_valid[sel]
        s.mp_pos[sel[alive_p]] = pts[:nm][ok_p][alive_p]
        # new landmarks: correct via their reference (first-observer) KF
        in_mp = job.mp_in
        new_mps = np.asarray([int(m) for m in s.map_point_ids()
                              if int(m) not in in_mp], np.int64)
        if len(new_mps):
            ref = s.mp_obs_kf[new_mps, 0]
            good = ref >= 0
            new_mps, ref = new_mps[good], ref[good]
            X = s.mp_pos[new_mps]
            xc = np.einsum("kij,kj->ki", old_R[ref], X) + old_t[ref]
            Xn = np.einsum("kji,kj->ki", s.kf_R[ref], xc - s.kf_t[ref])
            s.mp_pos[new_mps] = Xn
        s.bump()
