"""Fused windowed Hamming top-2 search: CUDA kernel + plain torch version.

The per-frame hot op of the front end (reference: ORBmatcher::
SearchByProjection) and of the mapping stage's fuse. Port of
ar_orbslam2_tpu/ops/pallas_hamming.py: the TPU kernel ``_kernel`` becomes
the hand-written Hopper kernel ``csrc/cuda_hamming.cu`` (see its header for
the design), built with nvcc into the package's git-ignored ``build/``
directory at first use and bound with ctypes.

``fused_windowed_top2`` takes the JAX entry's arguments and layout (±1 int8
signs); callers that hold packed descriptors ((N, 32) uint8, LSB-first) may
pass those instead. On CPU tensors it runs the plain version
(``fused_windowed_top2_reference``); on CUDA tensors it launches the kernel
or raises — there is no fallback from the card to the plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

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
        lib.hamming_top2_launch.argtypes = [p] * 10 + [
            ctypes.c_int, ctypes.c_int] + [p] * 5
        lib.hamming_top2_launch.restype = ctypes.c_int
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
    """(N, 8) int32 view of packed descriptors (4-byte aligned, contiguous)."""
    packed = desc if _is_packed(desc) else H.packed_from_signs(desc)
    packed = packed.contiguous()
    if packed.data_ptr() % 4:
        packed = packed.clone()
    return packed.view(torch.int32)


# ---------------------------------------------------------------------------
# raw top-2: (idx0, d0, d1, kp_best_d, kp_best_q)
# ---------------------------------------------------------------------------
def top2_reference(q_desc, q_uv, q_radius, q_olo, q_ohi, q_valid,
                   kp_desc, kp_uv, kp_octave, kp_valid):
    """Plain torch version of the kernel: masked hamming_matrix, first-index
    top-2 per row, first-row minimum per column (pallas_hamming.py:180-194
    composition, with the kernel's raw outputs)."""
    d = H.hamming_matrix(_as_signs(q_desc), _as_signs(kp_desc),
                         q_valid, kp_valid, invalid_dist=INF)
    du = (q_uv[:, None, 0] - kp_uv[None, :, 0]).abs()
    dv = (q_uv[:, None, 1] - kp_uv[None, :, 1]).abs()
    r = q_radius[:, None]
    ok = (du <= r) & (dv <= r)
    ok &= (kp_octave[None, :] >= q_olo[:, None]) \
        & (kp_octave[None, :] <= q_ohi[:, None])
    d = torch.where(ok, d, torch.full_like(d, INF))
    d0, idx0, d1 = H.top2_min(d)
    kp_best_q = torch.argmin(d, dim=0).to(torch.int32)
    kp_best_d = torch.gather(d, 0, kp_best_q.long()[None, :])[0]
    return idx0, d0, d1, kp_best_d, kp_best_q


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


def top2_cuda(q_desc, q_uv, q_radius, q_olo, q_ohi, q_valid,
              kp_desc, kp_uv, kp_octave, kp_valid):
    """Launch the kernel on the current stream; same outputs as
    top2_reference. Inputs must be CUDA tensors of the documented dtypes."""
    dev = q_uv.device
    n, m = q_uv.shape[0], kp_uv.shape[0]
    if dev.type != "cuda":
        raise ValueError(f"top2_cuda needs CUDA tensors, got {dev}")
    if n >= _MAX_ROWS:
        raise ValueError(f"{n} queries: the kernel takes fewer than "
                         f"{_MAX_ROWS}")
    if m < 1:
        raise ValueError("no keypoints")
    qw, kw = _as_words(q_desc), _as_words(kp_desc)
    _check("q_desc", qw, torch.int32, (n, 8), dev)
    _check("q_uv", q_uv, torch.float32, (n, 2), dev)
    _check("q_radius", q_radius, torch.float32, (n,), dev)
    _check("q_olo", q_olo, torch.int32, (n,), dev)
    _check("q_ohi", q_ohi, torch.int32, (n,), dev)
    _check("q_valid", q_valid, torch.bool, (n,), dev)
    _check("kp_desc", kw, torch.int32, (m, 8), dev)
    _check("kp_uv", kp_uv, torch.float32, (m, 2), dev)
    _check("kp_octave", kp_octave, torch.int32, (m,), dev)
    _check("kp_valid", kp_valid, torch.bool, (m,), dev)
    lib = _library()
    idx0 = torch.empty(n, dtype=torch.int32, device=dev)
    d0 = torch.empty(n, dtype=torch.int32, device=dev)
    d1 = torch.empty(n, dtype=torch.int32, device=dev)
    key = torch.full((m,), _INT_MAX, dtype=torch.int32, device=dev)
    if n:                             # no queries: nothing to launch
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hamming_top2_launch(
            qw.data_ptr(), q_uv.data_ptr(), q_radius.data_ptr(),
            q_olo.data_ptr(), q_ohi.data_ptr(), q_valid.data_ptr(),
            kw.data_ptr(), kp_uv.data_ptr(), kp_octave.data_ptr(),
            kp_valid.data_ptr(), n, m, idx0.data_ptr(), d0.data_ptr(),
            d1.data_ptr(), key.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(
                f"hamming_top2 launch failed: CUDA error {err}")
        # a launch recorded into a CUDA graph under capture runs only when
        # the graph is replayed: the graph runner adds it to `launches` then
        if torch.cuda.is_current_stream_capturing():
            fused_windowed_top2.captured += 1
        else:
            fused_windowed_top2.launches += 1
    unset = key == _INT_MAX           # every row INF: (INF, first row 0)
    kp_best_d = torch.where(unset, INF, key >> 16).to(torch.int32)
    kp_best_q = torch.where(unset, 0, key & 0xFFFF).to(torch.int32)
    return idx0, d0, d1, kp_best_d, kp_best_q


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
    packed (N, 32) uint8. Returns (idx (N,) int32 with -1 for no match,
    d0 (N,) int32).
    """
    raw = top2(q_signs, q_uv, q_radius, q_olo, q_ohi, q_valid,
               kp_signs, kp_uv, kp_octave, kp_valid)
    return _filter(raw, th, nn_ratio, mutual)


fused_windowed_top2.launches = 0      # kernel launches that ran
fused_windowed_top2.captured = 0      # launches recorded into CUDA graphs


def fused_windowed_top2_reference(q_signs, q_uv, q_radius, q_olo, q_ohi,
                                  q_valid, kp_signs, kp_uv, kp_octave,
                                  kp_valid, th=H.TH_HIGH, nn_ratio=1.0,
                                  mutual=True):
    """Plain torch version of fused_windowed_top2, on any device."""
    raw = top2_reference(q_signs, q_uv, q_radius, q_olo, q_ohi, q_valid,
                         kp_signs, kp_uv, kp_octave, kp_valid)
    return _filter(raw, th, nn_ratio, mutual)
