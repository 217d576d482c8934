"""Asynchronous mapping stage — the reference's LocalMapping thread.

Port of ar_orbslam2_tpu/mapping/async_mapper.py. Parity: System::System
spawns LocalMapping as a long-lived thread fed through a keyframe queue;
tracking NEVER waits for mapping — it keeps tracking against the map as of
the last completed mapping step, and new keyframes are simply not accepted
while the mapper is saturated (SetAcceptKeyFrames(false)).

One worker thread drains a queue of freshly inserted keyframe ids (with
their creation numbers: a keyframe culled and its slot reused before the
worker reaches it is skipped) or deferred-insert callables and runs the
mapping stage (triangulate -> fuse -> local BA -> cull) for each. On a CUDA
device the worker's device work runs on a stream of its own, so it
overlaps the tracking thread's graph replays instead of queueing behind
them. The device-resident tracking state (system/fused.py) keeps using its
bundle snapshot while the mapper works; the host store is protected by the
coarse MapStore.lock (mMutexMapUpdate parity) held around write-backs and
chunk-boundary reads. The fused bundle refreshes at the next chunk boundary
after the mapper published.

After a keyframe's mapping step the worker hands it to the loop closer
(place-recognition insert, loop detection, and on a loop the correction,
the essential graph and the launch of a background global BA), or, without
one, adds it to the relocalizer's database: on the worker's own stream (the
database guards the shared bow matrix).
"""
from __future__ import annotations

import contextlib
import queue
import threading

import torch


class AsyncMapper:
    """Keyframe-queue worker wrapping LocalMapper."""

    def __init__(self, mapper, device=None, loop_closer=None,
                 relocalizer=None):
        self.mapper = mapper
        self.loop_closer = loop_closer
        self.relocalizer = relocalizer
        self.device = torch.device(mapper.device if device is None
                                   else device)
        self._q: queue.Queue = queue.Queue()
        self._pending = 0
        self._pending_lock = threading.Lock()
        self.error: BaseException | None = None
        self.n_processed = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="local-mapping")
        self._thread.start()

    # ------------------------------------------------------------------
    def busy(self) -> bool:
        """A mapping step is queued OR running."""
        with self._pending_lock:
            return self._pending > 0

    def queue_idle(self) -> bool:
        """Parity: LocalMapping::AcceptKeyFrames — the reference accepts
        a new keyframe while the PREVIOUS step is still running (the
        queue drains one behind); it only refuses when work is piling
        up."""
        return self._q.qsize() == 0

    def _put(self, item):
        if self.error is not None:
            raise RuntimeError("async mapper died") from self.error
        with self._pending_lock:
            self._pending += 1
        self._q.put(item)

    def submit(self, kf: int, seq: int):
        """Queue keyframe kf, created as `seq` (store.kf_seq), for
        mapping. The worker skips it if the slot holds another keyframe
        by the time it comes up (culled and its slot reused meanwhile)."""
        self._put((int(kf), int(seq)))

    def submit_task(self, fn):
        """Run an arbitrary callable on the mapping worker. The pipelined
        tracking path uses this to defer the WHOLE keyframe event
        (snapshot readback + store insert + mapping) off the tracking
        thread: a materialize readback queues behind the chunk in flight,
        and the tracking thread must not block on it."""
        self._put(fn)

    def join(self, timeout=None):
        """Drain the queue (parity: the Shutdown thread joins). timeout:
        seconds to wait for it (None: no limit); TimeoutError when the
        worker is still busy then."""
        with self._q.all_tasks_done:
            if not self._q.all_tasks_done.wait_for(
                    lambda: not self._q.unfinished_tasks, timeout):
                raise TimeoutError(
                    f"async mapper still busy after {timeout} s")
        if self.error is not None:
            raise RuntimeError("async mapper died") from self.error

    # ------------------------------------------------------------------
    def _run(self):
        if self.device.type == "cuda":
            scope = torch.cuda.stream(torch.cuda.Stream(self.device))
        else:
            scope = contextlib.nullcontext()
        with scope:
            while True:
                kf = self._q.get()
                try:
                    if self.error is None:
                        if callable(kf):
                            kf = kf()    # deferred insert -> kf id (or None)
                        else:
                            # skipped only when the slot was reused: a
                            # culled keyframe is still mapped, as in the
                            # JAX package
                            kf, seq = kf
                            if self.mapper.store.kf_seq[kf] != seq:
                                kf = None
                        if kf is not None:
                            self.mapper.process_keyframe(kf)
                            if self.loop_closer is not None:
                                self.loop_closer.insert_keyframe(kf)
                            elif self.relocalizer is not None and \
                                    self.relocalizer.kfdb is not None:
                                self.relocalizer.kfdb.add(kf)
                        self.n_processed += 1
                except BaseException as e:      # surface on next submit/join
                    self.error = e
                finally:
                    with self._pending_lock:
                        self._pending -= 1
                    self._q.task_done()
