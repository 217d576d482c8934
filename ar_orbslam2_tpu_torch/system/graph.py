"""Graph runner — the port's counterpart of ``jit`` + ``lax.scan``.

A *step* is a Python function without arguments that reads static input
tensors, computes with fixed shapes and no host read, and writes its results
into static output tensors with ``copy_``. On a CUDA device the runner
captures the step once into a ``torch.cuda.CUDAGraph`` and replays it; on
the CPU it calls the step eagerly (that is what the CPU tests exercise).

Contract on the card:
  * the step is warmed eagerly first (lazy kernel loading, cuBLAS handles
    and the nvcc build of the hand kernel cannot happen inside a capture);
    the Hamming searches recorded into the graph get a workspace of their
    own, made before the capture begins;
    tensors named in ``restore`` are saved before and restored after the
    warm-up and the capture, so neither leaves a trace in the state;
  * capture uses ``capture_error_mode="thread_local"``: only the capturing
    thread's calls are checked, so an allocation made meanwhile by the
    mapping worker on its own stream does not abort the capture;
  * a failed capture raises. There is no eager fallback on the card;
  * ``captures`` counts captures (the port's ``compiles_after_warmup``
    reads it: after warm-up it must not grow), ``replays`` counts replays;
  * the Hamming kernel's wrapper counts a *captured* launch separately
    (``fused_windowed_top2.captured``); every replay then adds the step's
    captured launches to ``fused_windowed_top2.launches``, so the launch
    count stays "kernels that really ran".
"""
from __future__ import annotations

import time

import torch

from ..ops.cuda_hamming import (capture_workspace, fused_windowed_top2,
                                graph_node_count)

N_WARMUP = 2


class GraphRunner:
    """Capture-once / replay-many wrapper around one step function."""

    def __init__(self, step, device, restore=()):
        self.step = step
        self.device = torch.device(device)
        self.restore = list(restore)
        self.graph = None
        self.workspace = None       # the captured searches' workspace
        self.captures = 0
        self.replays = 0
        self.launches_per_replay = 0
        self.n_nodes = None
        self.warmup_s = None        # eager warm-up runs
        self.capture_s = None       # recording the step into the graph
        self.instantiate_s = None   # ending the capture: instantiation

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    # ------------------------------------------------------------------
    def capture(self):
        """Warm the step and capture it (CUDA only; a no-op on the CPU and
        when the graph already exists)."""
        if not self.on_card or self.graph is not None:
            return
        saved = [t.clone() for t in self.restore]
        t0 = time.perf_counter()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(N_WARMUP):
                self.step()
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        self.warmup_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        # keep_graph: the captured cudaGraph_t stays readable (node count)
        # and instantiation becomes a step of its own, timed apart
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = fused_windowed_top2.captured
        # the searches recorded here finish through a workspace that lives
        # and dies with this graph (eager launches keep one per stream)
        with capture_workspace(self.device) as self.workspace:
            torch.cuda.synchronize(self.device)
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self.step()
        self.launches_per_replay = fused_windowed_top2.captured - before
        t1 = time.perf_counter()
        graph.instantiate()
        torch.cuda.synchronize(self.device)
        self.capture_s = t1 - t0
        self.instantiate_s = time.perf_counter() - t1
        self.n_nodes = graph_node_count(graph.raw_cuda_graph())
        for t, s in zip(self.restore, saved):
            t.copy_(s)
        self.graph = graph
        self.captures += 1

    def run(self):
        """One step on the current stream: a replay on the card, an eager
        call on the CPU. Never waits for the device."""
        if not self.on_card:
            self.step()
            return
        if self.graph is None:
            self.capture()
        self.graph.replay()
        self.replays += 1
        fused_windowed_top2.launches += self.launches_per_replay
