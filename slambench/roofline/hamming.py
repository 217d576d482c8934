"""Work and bytes of one launch of the windowed Hamming search
(``ops/cuda_hamming.py`` -> ``csrc/cuda_hamming.cu``), counted from the
arguments the launch was given, so that any implementation of the search
is held to the same work.

Operations: the (query row, keypoint) pairs that the search's definition
compares for these inputs: both valid, the keypoint inside the row's
square window (|du| <= r and |dv| <= r) and, where given, inside its
octave range. Each pair is one 256-bit distance: 8 32-bit population
counts. Bytes: every input and every output once (descriptors as the
kernel reads them, 32 bytes a row). The least time is the larger of the
two over the chip's published peaks (``peaks.py``)."""
from __future__ import annotations

import torch

from . import peaks

POPC_PER_PAIR = 8
DESC_BYTES = 32
# argument order of the search; leading batch dimensions broadcast
ARGS = ("q_desc", "q_uv", "q_radius", "q_olo", "q_ohi", "q_valid",
        "kp_desc", "kp_uv", "kp_octave", "kp_valid")
_ROW_RANK = dict(q_desc=2, q_uv=2, q_radius=1, q_olo=1, q_ohi=1, q_valid=1,
                 kp_desc=2, kp_uv=2, kp_octave=1, kp_valid=1)


def _batch(a, name):
    if not torch.is_tensor(a):
        return 1
    return a.shape[0] if a.dim() == _ROW_RANK[name] + 1 else 1


@torch.no_grad()
def work(args, raw=False):
    """(pairs, bytes) of one launch."""
    a = dict(zip(ARGS, args))
    q_uv, kp_uv = a["q_uv"], a["kp_uv"]
    n, m = q_uv.shape[-2], kp_uv.shape[-2]
    nb = max(_batch(v, k) for k, v in a.items())
    du = (q_uv[..., :, None, 0] - kp_uv[..., None, :, 0]).abs()
    dv = (q_uv[..., :, None, 1] - kp_uv[..., None, :, 1]).abs()
    r = a["q_radius"]
    r = r[..., :, None] if torch.is_tensor(r) else float(r)
    gate = (du <= r) & (dv <= r)
    if a["q_olo"] is not None:
        oct_ = a["kp_octave"][..., None, :]
        gate &= (oct_ >= a["q_olo"][..., :, None]) \
            & (oct_ <= a["q_ohi"][..., :, None])
    gate &= a["q_valid"][..., :, None] & a["kp_valid"][..., None, :]
    pairs = int(gate.sum()) * (nb if gate.dim() == 2 and nb > 1 else 1)
    per_q = DESC_BYTES + 8 + 1 + (4 if torch.is_tensor(a["q_radius"])
                                  else 0) \
        + (8 if a["q_olo"] is not None else 0)
    per_kp = DESC_BYTES + 8 + 4 + 1
    b_q = max(_batch(a[k], k) for k in ARGS[:6])
    b_kp = max(_batch(a[k], k) for k in ARGS[6:])
    out_rows = 3 if raw else 2
    nbytes = (b_q * n * per_q + b_kp * m * per_kp
              + nb * (out_rows * n * 4 + (2 * m * 4 if raw else 0)))
    return pairs, nbytes


def least_seconds(pairs, nbytes):
    """(least time, "operations" or "bytes")."""
    ops = pairs * POPC_PER_PAIR / peaks.POPC_PER_S
    mem = nbytes / peaks.HBM_BYTES_PER_S
    return (ops, "operations") if ops >= mem else (mem, "bytes")


class Recorder:
    """Keeps the arguments of the search's launches, wrapping the
    program's launch function for a traced run: the arguments recorded
    into the live frame-step graph (the tensors stay alive, so after a
    replay they hold that replay's inputs) and, while ``eager`` is a list,
    copies of every eager launch's arguments."""

    KERNEL = "hamming_search_kernel"

    def __init__(self, module):
        self.module = module
        self.inner = module._search_cuda
        self.live_capture = False
        self.graph = []            # [(args, raw)] in capture order
        self.eager = None
        module._search_cuda = self._launch

    def _launch(self, args, th, nn_ratio, mutual, raw):
        if torch.cuda.is_current_stream_capturing():
            if self.live_capture:
                self.graph.append((args, raw))
        elif self.eager is not None:
            self.eager.append((tuple(x.clone() if torch.is_tensor(x) else x
                                     for x in args), raw))
        return self.inner(args, th, nn_ratio, mutual, raw)

    def watch_capture(self, runner):
        """Record the searches that `runner` (a GraphRunner) captures."""
        inner = runner.capture

        def capture():
            self.live_capture = True
            try:
                return inner()
            finally:
                self.live_capture = False
        runner.capture = capture

    def close(self):
        self.module._search_cuda = self.inner
