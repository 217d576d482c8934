"""ctypes loader for the native map-graph runtime (mapgraph.cpp).

Builds libmapgraph.so with g++ on first use (into the package's git-ignored
build/ directory),
then binds the C ABI. All entry points operate zero-copy on the MapStore's
numpy buffers. If the toolchain or build is unavailable the loader reports
available() == False and MapStore falls back to its vectorized numpy
implementations (the parity oracle — tests/test_native_mapgraph.py).

Set AR_ORBSLAM2_NATIVE=0 to force the numpy paths.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "mapgraph.cpp")
_SO = os.path.join(os.path.dirname(_HERE), "build", "libmapgraph.so")

_lib = None
_tried = False


def _build() -> None:
    if os.path.exists(_SO) and \
            os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    # build under a per-process name, then rename: concurrent test
    # workers must never load a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
           "-fPIC", "-pthread", "-o", tmp, _SRC]
    subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    os.replace(tmp, _SO)


def _bind(lib) -> None:
    i64 = ctypes.c_int64
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.mg_version.restype = ctypes.c_int
    lib.mg_distinctive_descriptors.argtypes = [
        u8p, i64p, i64p, i32p, u8p, i64p, i64, i64, i64]
    lib.mg_update_normal_and_depth.argtypes = [
        i64p, i64p, i32p, f32p, f32p, f32p, i32p,
        f32p, f32p, f32p, i64p, i64, i64, i64,
        ctypes.c_float, ctypes.c_int]
    lib.mg_update_connections.argtypes = [
        i64p, i64p, i32p, i32p, i64p, i64, i64, i64, i64, ctypes.c_int]
    lib.mg_hamming_matrix.argtypes = [u8p, i64, u8p, i64, i32p]


def available() -> bool:
    """True when the native library is loaded (builds it on first call)."""
    global _lib, _tried
    if _tried:
        return _lib is not None
    _tried = True
    if os.environ.get("AR_ORBSLAM2_NATIVE", "1") == "0":
        return False
    try:
        _build()
        lib = ctypes.CDLL(_SO)
        _bind(lib)
        assert lib.mg_version() == 1
        _lib = lib
    except Exception:
        _lib = None
    return _lib is not None


# ---------------------------------------------------------------------------
# MapStore-facing wrappers (zero-copy on the store's numpy arrays)
# ---------------------------------------------------------------------------
def distinctive_descriptors(store, mp_ids: np.ndarray) -> None:
    mp_ids = np.ascontiguousarray(mp_ids, np.int64)
    _lib.mg_distinctive_descriptors(
        store.kf_desc, store.mp_obs_kf, store.mp_obs_feat, store.mp_nobs,
        store.mp_desc, mp_ids, len(mp_ids),
        store.cfg.max_kp, store.cfg.max_obs)


def update_normal_and_depth(store, mp_ids: np.ndarray) -> None:
    mp_ids = np.ascontiguousarray(mp_ids, np.int64)
    _lib.mg_update_normal_and_depth(
        store.mp_obs_kf, store.mp_obs_feat, store.mp_nobs, store.mp_pos,
        store.kf_R, store.kf_t, store.kf_octave,
        store.mp_normal, store.mp_dmin, store.mp_dmax,
        mp_ids, len(mp_ids), store.cfg.max_kp, store.cfg.max_obs,
        store.cfg.scale_factor, store.cfg.n_levels)


def update_connections(store, kf: int) -> None:
    _lib.mg_update_connections(
        store.kf_mp, store.mp_obs_kf, store.mp_nobs,
        store.covis, store.kf_parent,
        kf, store.cfg.max_keyframes, store.cfg.max_kp, store.cfg.max_obs,
        store.cfg.covis_threshold)


def hamming_matrix(a_packed: np.ndarray, b_packed: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a_packed, np.uint8)
    b = np.ascontiguousarray(b_packed, np.uint8)
    out = np.empty((len(a), len(b)), np.int32)
    _lib.mg_hamming_matrix(a, len(a), b, len(b), out)
    return out
