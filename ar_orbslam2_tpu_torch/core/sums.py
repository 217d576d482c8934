"""Indexed sums whose order is fixed by the inputs alone.

The JAX package turns every camera- or vertex-indexed sum into a one-hot
matmul, which XLA runs in one fixed order. ``index_add_`` on a CUDA tensor
is an ``atomicAdd`` per element instead: float32 additions land in the
order the threads happen to arrive, so one input gives a different last
bit from run to run, and in a SLAM system a last bit is enough to flip a
RANSAC threshold or a keyframe decision a few frames later.

``IndexSum(idx, n)`` is one index vector's sum, planned once and applied
to many values (every LM iteration of a BA problem, every matvec of a
PCG solve), on the route that is ordered on each device:

* CUDA: the entries are cut into blocks of RUN in input order (more where
  the blocks' partial rows would pass MAX_PARTIALS elements); the plan
  sorts the keys (block, index) stably once; each call gathers the values
  in that order, sums each run of equal keys front to back
  (``torch.segment_reduce``, one thread per run and element), and adds
  the blocks' partial rows with ``sum(0)``. Every order is fixed. A run
  is summed serially, so the blocks keep runs short: a BA's padded
  observations all name camera 0, and global BA's 690,000 of them summed
  in one run took 240 ms a call on an H100 (NVIDIA H100 80GB HBM3,
  700.00 W). A sum into so many rows that two blocks do not fit is one
  level; its runs are short. The bits are those of a sorted
  ``index_put_(..., accumulate=True)`` per block, which sorts and sums
  each call.
* CPU: ``index_add_`` walks the indices in input order. (There it is
  ``index_put_`` that adds floats with atomics across threads.)

Both give the same bits for the same inputs on every run, with no
process-wide switch (``torch.use_deterministic_algorithms``) and no host
read. Every floating-point indexed sum of the port goes through this
module; tests/test_torch_sums.py holds the source to that.
"""
from __future__ import annotations

import math

import torch

RUN = 256                  # CUDA: entries of one block of the first level
MAX_PARTIALS = 1 << 24     # CUDA: elements of the blocks' partial sums


class IndexSum:
    """out[k] = sum of values[e] over every e with idx[e] == k.

    idx (E,) int64 and the row count n are fixed when the sum is made;
    each call takes values (E, ...) and returns (n, ...) of their dtype,
    rows that no index names zero. The order of each row's sum depends on
    idx and the values' shape only, never on the timing of a run."""

    def __init__(self, idx, n):
        self.idx, self.n = idx, n
        self._plans = {}            # blocks -> (order, run lengths)

    def __call__(self, values):
        if values.device.type == "cpu":
            return torch.zeros((self.n,) + tuple(values.shape[1:]),
                               dtype=values.dtype).index_add_(
                0, self.idx, values)
        return self.segmented(values)

    def segmented(self, values):
        """The CUDA route (on CPU tensors it runs too: for the tests)."""
        tail = tuple(values.shape[1:])
        blocks = self._blocks(math.prod(tail))
        if blocks not in self._plans:
            self._plans[blocks] = self._plan(blocks)
        order, lengths = self._plans[blocks]
        part = torch.segment_reduce(values[order], "sum", lengths=lengths,
                                    axis=0, unsafe=True)   # unsafe: no sync
        if blocks == 1:
            return part
        return part.reshape((blocks, self.n) + tail).sum(0)

    def _blocks(self, width):
        E = self.idx.shape[0]
        blocks = min(-(-E // RUN), MAX_PARTIALS // max(self.n * width, 1))
        return blocks if blocks >= 2 else 1

    def _plan(self, blocks):
        idx, dev = self.idx, self.idx.device
        E = idx.shape[0]
        key = idx
        if blocks > 1:
            key = torch.arange(E, device=dev) // -(-E // blocks) * self.n \
                + idx
        sorted_key, order = torch.sort(key, stable=True)
        bounds = torch.searchsorted(sorted_key, torch.arange(
            blocks * self.n + 1, device=dev))
        return order, bounds.diff()
