"""Fused windowed Hamming search: CUDA kernel + plain torch version.

The per-frame hot op of the front end (reference: ORBmatcher::
SearchByProjection), of the mapping stage's fuse and of the relocalizer's
projection top-up. Port of ar_orbslam2_tpu/ops/pallas_hamming.py: the TPU
kernel ``_kernel`` and the filter around it become ONE launch of the
hand-written Hopper kernel ``csrc/cuda_hamming.cu`` (see its header for the
design), built with nvcc into the package's git-ignored ``build/`` directory
at first use and bound with ctypes.

``fused_windowed_top2`` takes the JAX entry's arguments and layout (±1 int8
signs); callers that hold packed descriptors ((N, 32) uint8, LSB-first) may
pass those instead. Beyond the JAX entry: ``q_radius`` may be a number (one
radius for every query), ``q_olo``/``q_ohi`` may be None (no octave gate),
and any of three argument groups may carry a leading batch dimension B —
the query descriptors, the query geometry (uv, radius, octave window,
valid) and the keypoints (descriptors, uv, octave, valid); a group without
it is shared by the B searches. One launch runs them all.

On CPU tensors the plain version runs (``fused_windowed_top2_reference``);
on CUDA tensors the kernel is launched or the call raises — there is no
fallback from the card to the plain version.

The kernel finishes the mutual-best test in the same launch through a small
persistent workspace (column keys + arrival counters) that it leaves reset.
Launches on one stream run in order, so eager calls share one workspace per
stream; a CUDA graph gets a workspace of its own, reserved by the capturing
code with ``capture_workspace`` (system/graph.py does).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading

import torch

from . import hamming as H

DESC_BITS = H.DESC_BITS
INF = DESC_BITS + 1
_INT_MAX = 2 ** 31 - 1
_MAX_ROWS = 1 << 16          # the row index lives in the key's low 16 bits

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "cuda_hamming.cu")
_BUILD_DIR = os.path.join(_PKG, "build")
_LIB = None
BUILD_LOG = ""               # nvcc's -Xptxas -v report of the last build


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (no CUDA_HOME / nvcc): "
                           "the Hamming kernel cannot be built")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_kernel() -> str:
    """Compile csrc/cuda_hamming.cu for sm_90a (once per source content)
    and return the shared library's path. Raises on a failed build."""
    global BUILD_LOG
    with open(_SRC, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:12]
    so = os.path.join(_BUILD_DIR, f"libcuda_hamming_{tag}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", tmp, _SRC]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    BUILD_LOG = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{BUILD_LOG}")
    os.replace(tmp, so)
    return so


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build_kernel())
        p = ctypes.c_void_p
        lib.hamming_search_launch.argtypes = (
            [p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_float] * 3
            + [ctypes.c_int] * 2 + [p] * 8)
        lib.hamming_search_launch.restype = ctypes.c_int
        lib.cuda_graph_node_count.argtypes = [
            p, ctypes.POINTER(ctypes.c_ulonglong)]
        lib.cuda_graph_node_count.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def graph_node_count(raw_graph: int) -> int:
    """Nodes of a captured CUDA graph (``cudaGraph_t`` handle as an int),
    through the host helper built beside the kernel."""
    count = ctypes.c_ulonglong(0)
    err = _library().cuda_graph_node_count(raw_graph, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cudaGraphGetNodes failed: CUDA error {err}")
    return int(count.value)


# ---------------------------------------------------------------------------
# descriptor layouts
# ---------------------------------------------------------------------------
def _is_packed(desc) -> bool:
    return desc.dtype == torch.uint8 and desc.shape[-1] == H.DESC_BYTES


def _as_signs(desc):
    return H.signs_from_packed(desc) if _is_packed(desc) else desc


def _as_words(desc):
    """(..., 8) int32 view of packed descriptors (4-byte aligned,
    contiguous)."""
    packed = desc if _is_packed(desc) else H.packed_from_signs(desc)
    packed = packed.contiguous()
    if packed.data_ptr() % 4:
        packed = packed.clone()
    return packed.view(torch.int32)


# ---------------------------------------------------------------------------
# the batch dimension
# ---------------------------------------------------------------------------
# base rank of each argument, in call order; a tensor of rank + 1 is batched
_RANKS = (2, 2, 1, 1, 1, 1, 2, 2, 1, 1)
_Q_DESC, _Q_GEO, _KP = (0,), (1, 2, 3, 4, 5), (6, 7, 8, 9)


def _batched(args, group):
    """Whether an argument group carries the batch dimension, and its
    size. Non-tensor members (a scalar radius, a None octave bound) follow
    the group."""
    sizes = {args[i].shape[0] for i in group
             if torch.is_tensor(args[i]) and args[i].dim() == _RANKS[i] + 1}
    if len(sizes) > 1:
        raise ValueError(f"batch sizes differ within a group: {sizes}")
    return (True, sizes.pop()) if sizes else (False, None)


def _batch_size(args):
    """B of a call, or None when no group is batched."""
    sizes = {b for g in (_Q_DESC, _Q_GEO, _KP)
             for on, b in (_batched(args, g),) if on}
    if len(sizes) > 1:
        raise ValueError(f"batch sizes differ between groups: {sizes}")
    return sizes.pop() if sizes else None


def _item(args, b):
    """Batch item b of a call's arguments."""
    return tuple(a[b] if torch.is_tensor(a) and a.dim() == _RANKS[i] + 1
                 else a for i, a in enumerate(args))


# ---------------------------------------------------------------------------
# raw top-2: (idx0, d0, d1, kp_best_d, kp_best_q)
# ---------------------------------------------------------------------------
def _top2_single(q_desc, q_uv, q_radius, q_olo, q_ohi, q_valid,
                 kp_desc, kp_uv, kp_octave, kp_valid):
    d = H.hamming_matrix(_as_signs(q_desc), _as_signs(kp_desc),
                         q_valid, kp_valid, invalid_dist=INF)
    du = (q_uv[:, None, 0] - kp_uv[None, :, 0]).abs()
    dv = (q_uv[:, None, 1] - kp_uv[None, :, 1]).abs()
    r = q_radius[:, None] if torch.is_tensor(q_radius) else float(q_radius)
    ok = (du <= r) & (dv <= r)
    if q_olo is not None:
        ok &= (kp_octave[None, :] >= q_olo[:, None]) \
            & (kp_octave[None, :] <= q_ohi[:, None])
    d = torch.where(ok, d, torch.full_like(d, INF))
    d0, idx0, d1 = H.top2_min(d)
    kp_best_q = torch.argmin(d, dim=0).to(torch.int32)
    kp_best_d = torch.gather(d, 0, kp_best_q.long()[None, :])[0]
    return idx0, d0, d1, kp_best_d, kp_best_q


def top2_reference(*args):
    """Plain torch version of the kernel's raw outputs: masked
    hamming_matrix, first-index top-2 per row, first-row minimum per column
    (pallas_hamming.py:180-194 composition). A batched call is B single
    calls, stacked."""
    n_batch = _batch_size(args)
    if n_batch is None:
        return _top2_single(*args)
    outs = [_top2_single(*_item(args, b)) for b in range(n_batch)]
    return tuple(torch.stack(o) for o in zip(*outs))


# ---------------------------------------------------------------------------
# the kernel's workspace
# ---------------------------------------------------------------------------
class Workspace:
    """Column keys (INT_MAX) and arrival counters (0) of the kernel's
    mutual-best pass. The kernel leaves both as it found them."""
    COLS = 1 << 16           # B * M of the largest call it serves
    BATCH = 1 << 10

    def __init__(self, device, cols=COLS, batch=BATCH):
        self.keys = torch.full((cols,), _INT_MAX, dtype=torch.int32,
                               device=device)
        self.counter = torch.zeros(batch, dtype=torch.int32, device=device)

    def fits(self, cols, batch) -> bool:
        return cols <= self.keys.shape[0] and batch <= self.counter.shape[0]


_STREAM_WS: dict = {}                # (device index, stream handle) -> ws
_CAPTURE = threading.local()         # .ws: the capturing thread's workspace


@contextlib.contextmanager
def capture_workspace(device):
    """Reserve a fresh workspace for the launches this thread records into a
    CUDA graph inside the block. The caller keeps the yielded workspace
    alive as long as the graph."""
    ws = Workspace(device)
    prev = getattr(_CAPTURE, "ws", None)
    _CAPTURE.ws = ws
    try:
        yield ws
    finally:
        _CAPTURE.ws = prev


def _workspace(dev, stream, cols, batch):
    if torch.cuda.is_current_stream_capturing():
        ws = getattr(_CAPTURE, "ws", None)
        if ws is None or not ws.fits(cols, batch):
            raise RuntimeError(
                "a captured search needs a workspace reserved with "
                "capture_workspace() that fits "
                f"{cols} column keys and {batch} searches")
        return ws
    key = (dev.index, stream)
    ws = _STREAM_WS.get(key)
    if ws is None or not ws.fits(cols, batch):
        ws = Workspace(dev, max(cols, Workspace.COLS),
                       max(batch, Workspace.BATCH))
        _STREAM_WS[key] = ws
    return ws


# ---------------------------------------------------------------------------
# the launch
# ---------------------------------------------------------------------------
def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _search_cuda(args, th, nn_ratio, mutual, raw):
    """One launch for the whole call. Returns (idx, d0) or, with raw, the
    five raw outputs; (B, ...) when any group is batched."""
    (q_desc, q_uv, q_radius, q_olo, q_ohi, q_valid,
     kp_desc, kp_uv, kp_octave, kp_valid) = args
    dev = q_uv.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {dev}")
    n, m = q_uv.shape[-2], kp_uv.shape[-2]
    if n >= _MAX_ROWS:
        raise ValueError(f"{n} queries: the kernel takes fewer than "
                         f"{_MAX_ROWS}")
    if m < 1:
        raise ValueError("no keypoints")
    if (q_olo is None) != (q_ohi is None):
        raise ValueError("q_olo and q_ohi: both tensors or both None")
    n_batch = _batch_size(args)
    nb = 1 if n_batch is None else n_batch
    qd_b, qg_b, k_b = (_batched(args, g)[0] for g in (_Q_DESC, _Q_GEO, _KP))
    bq = (nb,) if qd_b else ()
    bg = (nb,) if qg_b else ()
    bk = (nb,) if k_b else ()
    qw, kw = _as_words(q_desc), _as_words(kp_desc)
    radius = 0.0
    if not torch.is_tensor(q_radius):
        radius, q_radius = float(q_radius), None
    _check("q_desc", qw, torch.int32, bq + (n, 8), dev)
    _check("q_uv", q_uv, torch.float32, bg + (n, 2), dev)
    if q_radius is not None:
        _check("q_radius", q_radius, torch.float32, bg + (n,), dev)
    if q_olo is not None:
        _check("q_olo", q_olo, torch.int32, bg + (n,), dev)
        _check("q_ohi", q_ohi, torch.int32, bg + (n,), dev)
    _check("q_valid", q_valid, torch.bool, bg + (n,), dev)
    _check("kp_desc", kw, torch.int32, bk + (m, 8), dev)
    _check("kp_uv", kp_uv, torch.float32, bk + (m, 2), dev)
    _check("kp_octave", kp_octave, torch.int32, bk + (m,), dev)
    _check("kp_valid", kp_valid, torch.bool, bk + (m,), dev)
    lib = _library()
    # every output from one allocation
    rows = 3 if raw else 2
    out = torch.empty(rows * nb * n + (2 * nb * m if raw else 0),
                      dtype=torch.int32, device=dev)
    per_row = out[:rows * nb * n].view(rows, nb, n)
    per_col = out[rows * nb * n:].view(-1, nb, m)
    if n:                             # no queries: nothing to launch
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws = None
        if mutual or raw:
            ws = _workspace(dev, stream, nb * m, nb)
        err = lib.hamming_search_launch(
            qw.data_ptr(), q_uv.data_ptr(), _ptr(q_radius), _ptr(q_olo),
            _ptr(q_ohi), q_valid.data_ptr(), kw.data_ptr(),
            kp_uv.data_ptr(), kp_octave.data_ptr(), kp_valid.data_ptr(),
            n, m, nb, int(qd_b), int(qg_b), int(k_b), radius, float(th),
            float(nn_ratio), int(bool(mutual)), int(bool(raw)),
            per_row[0].data_ptr(), per_row[1].data_ptr(),
            per_row[2].data_ptr() if raw else None,
            per_col[0].data_ptr() if raw else None,
            per_col[1].data_ptr() if raw else None,
            None if ws is None else ws.keys.data_ptr(),
            None if ws is None else ws.counter.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(
                f"hamming_search launch failed: CUDA error {err}")
        # a launch recorded into a CUDA graph under capture runs only when
        # the graph is replayed: the graph runner adds it to `launches` then
        if torch.cuda.is_current_stream_capturing():
            fused_windowed_top2.captured += 1
        else:
            fused_windowed_top2.launches += 1
            _this_thread.launches = thread_launches() + 1
    elif raw:                         # a column of INFs: (INF, first row 0)
        per_col[0].fill_(INF)
        per_col[1].zero_()
    outs = tuple(per_row) + (tuple(per_col) if raw else ())
    if n_batch is None:
        outs = tuple(o[0] for o in outs)
    return outs


def top2_cuda(*args):
    """The kernel's raw outputs (same as top2_reference), one launch on the
    current stream. Inputs must be CUDA tensors of the documented dtypes."""
    return _search_cuda(args, H.TH_HIGH, 1.0, False, True)


def top2(*args):
    """Raw top-2 on the inputs' device: the plain version for CPU tensors,
    the kernel for CUDA tensors."""
    dev = args[1].device
    if dev.type == "cpu":
        return top2_reference(*args)
    if dev.type == "cuda":
        return top2_cuda(*args)
    raise ValueError(f"unsupported device {dev}")


def _filter(raw, th, nn_ratio, mutual):
    """Threshold + Lowe ratio + mutual-best, pallas_hamming.py:200-206."""
    idx0, d0, d1, kp_best_d, kp_best_q = raw
    ok = (d0 <= th) & (d0.to(torch.float32)
                       <= nn_ratio * d1.to(torch.float32))
    idx = torch.where(ok, idx0, torch.full_like(idx0, -1))
    if mutual:
        back = torch.where(kp_best_d <= INF - 1, kp_best_q,
                           torch.full_like(kp_best_q, -2))
        idx = H.mutual_filter(idx, back)
    return idx.to(torch.int32), d0


def fused_windowed_top2(q_signs, q_uv, q_radius, q_olo, q_ohi, q_valid,
                        kp_signs, kp_uv, kp_octave, kp_valid,
                        th=H.TH_HIGH, nn_ratio=1.0, mutual=True):
    """Windowed descriptor search: best keypoint per query + gates.

    Semantics identical to the JAX package's fused_windowed_top2 (threshold,
    Lowe ratio, mutual-best dedup). Descriptors: ±1 int8 (N, 256) signs or
    packed (N, 32) uint8; the module docstring says what else is accepted.
    Returns (idx (N,) int32 with -1 for no match, d0 (N,) int32), or
    (B, N) each for a batched call. On CUDA tensors this is one kernel
    launch and nothing else.
    """
    args = (q_signs, q_uv, q_radius, q_olo, q_ohi, q_valid,
            kp_signs, kp_uv, kp_octave, kp_valid)
    dev = q_uv.device
    if dev.type == "cpu":
        return fused_windowed_top2_reference(*args, th=th, nn_ratio=nn_ratio,
                                             mutual=mutual)
    if dev.type == "cuda":
        return _search_cuda(args, th, nn_ratio, mutual, False)
    raise ValueError(f"unsupported device {dev}")


fused_windowed_top2.launches = 0      # kernel launches that ran
fused_windowed_top2.captured = 0      # launches recorded into CUDA graphs
_this_thread = threading.local()


def thread_launches() -> int:
    """Eager kernel launches made so far from the calling thread (graph
    replays not included): tells one thread's searches apart from those of
    another thread running at the same time."""
    return getattr(_this_thread, "launches", 0)


def fused_windowed_top2_reference(q_signs, q_uv, q_radius, q_olo, q_ohi,
                                  q_valid, kp_signs, kp_uv, kp_octave,
                                  kp_valid, th=H.TH_HIGH, nn_ratio=1.0,
                                  mutual=True):
    """Plain torch version of fused_windowed_top2, on any device."""
    args = (q_signs, q_uv, q_radius, q_olo, q_ohi, q_valid,
            kp_signs, kp_uv, kp_octave, kp_valid)
    n_batch = _batch_size(args)
    if n_batch is None:
        return _filter(_top2_single(*args), th, nn_ratio, mutual)
    outs = [_filter(_top2_single(*_item(args, b)), th, nn_ratio, mutual)
            for b in range(n_batch)]
    return tuple(torch.stack(o) for o in zip(*outs))
