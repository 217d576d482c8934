"""Host spans around the calls into the program's layers, recorded by the
benchmark in a traced run only: it wraps the calls at runtime and edits
no file of the program. Span names:

  * ``chunk_call``: one ``track_monocular_batch`` call of the window;
  * ``kf_event``: a keyframe event on the mapping worker (the deferred
    soft event, or the tail of a hard one);
  * ``kf_wait``: ``Tracking.wait_for_keyframe_mapping``, where a chunk
    call blocks until the worker has mapped its soft keyframe; ``pending``
    says whether one was pending when the wait began;
  * ``process_keyframe``: ``LocalMapper.process_keyframe``, with the
    mapper's own per-stage times (``last_stats``) kept beside it;
  * ``bundle_refresh``: a rebuild or refresh of the device bundle;
  * ``readback``: collecting a chunk's records from the device.
"""
from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass, field


@dataclass
class Span:
    name: str
    t0: int                 # time.perf_counter_ns()
    t1: int
    thread: int
    info: dict = field(default_factory=dict)

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) / 1e6


class Spans:
    def __init__(self):
        self.spans: list[Span] = []

    def record(self, name, t0, t1, info=None):
        self.spans.append(Span(name, t0, t1, threading.get_ident(),
                               info or {}))

    def wrap(self, obj, attr, name, info=None, before=None):
        """Replace the bound method ``obj.attr`` by one that records a
        span around each call; ``before(obj)`` runs before the call and
        ``info(obj)`` after it, and the span keeps what they return."""
        inner = getattr(obj, attr)

        @functools.wraps(inner)
        def timed(*a, **kw):
            kept = before(obj) if before else {}
            t0 = time.perf_counter_ns()
            try:
                return inner(*a, **kw)
            finally:
                if info:
                    kept.update(info(obj))
                self.record(name, t0, time.perf_counter_ns(), kept)
        setattr(obj, attr, timed)


def _mapper_stats(mapper):
    return dict(mapper.last_stats)


def _soft_pending(tracking):
    return {"pending": tracking.kf_mapped is not None}


def instrument(slam, spans: Spans):
    """Wrap the layer boundaries of a built SlamSystem."""
    t = slam.tracking
    spans.wrap(slam.mapper, "process_keyframe", "process_keyframe",
               info=_mapper_stats)
    for attr in ("_deferred_kf_event", "_finish_kf_async"):
        spans.wrap(t, attr, "kf_event")
    spans.wrap(t, "wait_for_keyframe_mapping", "kf_wait",
               before=_soft_pending)
    fe = t.fused
    if fe is not None:
        for attr in ("rebuild", "refresh_bundle", "refresh_bundle_device"):
            spans.wrap(fe, attr, "bundle_refresh")
        spans.wrap(fe, "collect_chunk", "readback")
