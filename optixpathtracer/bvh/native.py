"""ctypes bindings for the native acceleration-structure compiler
(native/src/accel.cpp) — the C++ runtime path for scene builds.

The reference builds its acceleration structures in native code on dedicated
hardware (optixAccelBuild, SimplePathtracer.cpp:457-601); here the same role
is a C++ library compiled on first use, with the numpy builders (lbvh.py,
wide.py) as both the semantic reference and the automatic fallback. Both
entry points are drop-in: `build_binary` and `wide_collapse` are bit-exact
vs their numpy counterparts (tested in tests/test_accel_native.py).

Set OPTIXPT_NO_NATIVE=1 to force the numpy path.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "src", "accel.cpp")
_BUILD_DIR = os.path.join(_REPO_ROOT, "native", "build")
_LIB = os.path.join(_BUILD_DIR, "libaccel.so")

_lock = threading.Lock()
_lib = None
_tried = False

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)


def _build() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-o", _LIB, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=180)
        return True
    except (subprocess.SubprocessError, FileNotFoundError):
        return False


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    if os.environ.get("OPTIXPT_NO_NATIVE", "") not in ("", "0"):
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB) or (
            os.path.exists(_SRC) and os.path.getmtime(_SRC) > os.path.getmtime(_LIB)
        ):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None
        lib.accel_build_binary.restype = ctypes.c_int32
        lib.accel_build_binary.argtypes = [
            _f32p, _f32p, _f32p, ctypes.c_int64, ctypes.c_int32,
            _i64p, _i32p, _i32p, _f32p, _f32p, _f32p, _f32p, _i32p,
        ]
        lib.accel_wide_collapse.restype = ctypes.c_int32
        lib.accel_wide_collapse.argtypes = [
            _i32p, _i32p, _f32p, _f32p, _f32p, _f32p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            _f32p, _i32p, _i64p,
        ]
        _lib = lib
        return _lib


def _c_arr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def build_binary(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, leaf_size: int):
    """Native morton+sort+Karras+levels+refit. Returns the same dict shape
    the numpy path produces, or None if the library is unavailable:
    (order, left, right, lmin, lmax, rmin, rmax, level, depth)."""
    lib = get_lib()
    if lib is None:
        return None
    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    t = v0.shape[0]
    k = int(leaf_size)
    pad_to = max(k, ((t + k - 1) // k) * k)
    n_leaves = pad_to // k
    m = max(1, n_leaves - 1)
    order = np.empty(pad_to, np.int64)
    left = np.empty(m, np.int32)
    right = np.empty(m, np.int32)
    lmin = np.empty((m, 3), np.float32)
    lmax = np.empty((m, 3), np.float32)
    rmin = np.empty((m, 3), np.float32)
    rmax = np.empty((m, 3), np.float32)
    level = np.empty(m, np.int32)
    depth = lib.accel_build_binary(
        _c_arr(v0, ctypes.c_float), _c_arr(v1, ctypes.c_float),
        _c_arr(v2, ctypes.c_float), t, k,
        _c_arr(order, ctypes.c_int64), _c_arr(left, ctypes.c_int32),
        _c_arr(right, ctypes.c_int32), _c_arr(lmin, ctypes.c_float),
        _c_arr(lmax, ctypes.c_float), _c_arr(rmin, ctypes.c_float),
        _c_arr(rmax, ctypes.c_float), _c_arr(level, ctypes.c_int32),
    )
    if depth < 0:
        return None
    return dict(order=order, left=left, right=right, lmin=lmin, lmax=lmax,
                rmin=rmin, rmax=rmax, level=level, depth=int(depth),
                padded_count=pad_to)


def wide_collapse(left, right, lmin, lmax, rmin, rmax, num_leaves: int,
                  width: int):
    """Native wide-BVH collapse. Returns (bbox (Wn, W, 6), refs (Wn, W),
    depth) or None."""
    lib = get_lib()
    if lib is None:
        return None
    left = np.ascontiguousarray(left, np.int32)
    right = np.ascontiguousarray(right, np.int32)
    lmin = np.ascontiguousarray(lmin, np.float32)
    lmax = np.ascontiguousarray(lmax, np.float32)
    rmin = np.ascontiguousarray(rmin, np.float32)
    rmax = np.ascontiguousarray(rmax, np.float32)
    m = left.shape[0]
    w = int(width)
    bbox = np.empty((m, w, 6), np.float32)
    refs = np.empty((m, w), np.int32)
    wn = ctypes.c_int64(0)
    depth = lib.accel_wide_collapse(
        _c_arr(left, ctypes.c_int32), _c_arr(right, ctypes.c_int32),
        _c_arr(lmin, ctypes.c_float), _c_arr(lmax, ctypes.c_float),
        _c_arr(rmin, ctypes.c_float), _c_arr(rmax, ctypes.c_float),
        m, int(num_leaves), w,
        _c_arr(bbox, ctypes.c_float), _c_arr(refs, ctypes.c_int32),
        ctypes.byref(wn),
    )
    if depth < 0:
        return None
    n = int(wn.value)
    return bbox[:n], refs[:n], int(depth)
