"""ctypes loader for the C++ host-ops library (native/hostops.cc).

The native seam of SURVEY §2: dense-array encoding kernels for the
snapshot layer live in C++ (built by build/Makefile, or on demand here
with g++), with pure-Python/numpy fallbacks so every path works without a
toolchain. `lib()` returns the loaded library or None; the public
functions below pick the fast path automatically and are bit-identical
either way (tests/test_native.py asserts both sides).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from kubernetes_tpu_torch.analysis import lockcheck
from typing import Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "hostops.cc")
_SO = os.path.join(_ROOT, "native", "libhostops.so")

_lock = lockcheck.make_lock("native._lock")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64 = ctypes.c_int64
    lib.fill_port_bitmaps.argtypes = [
        ctypes.POINTER(i64), i64, ctypes.POINTER(ctypes.c_uint32), i64, i64]
    lib.fill_port_bitmaps.restype = None
    lib.fill_multi_hot.argtypes = [
        ctypes.POINTER(i64), i64, ctypes.POINTER(ctypes.c_int8), i64, i64]
    lib.fill_multi_hot.restype = None
    lib.fnv1a64.argtypes = [ctypes.POINTER(ctypes.c_uint8), i64]
    lib.fnv1a64.restype = ctypes.c_uint64
    return lib


def lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it once with g++ if absent. None when
    no prebuilt .so exists and the build fails (no toolchain)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) and os.path.exists(_SRC):
            try:
                subprocess.run(
                    ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                     "-o", _SO, _SRC],
                    check=True, capture_output=True, timeout=120)
            except Exception:
                return None
        if os.path.exists(_SO):
            try:
                _lib = _bind(ctypes.CDLL(_SO))
            except OSError:
                _lib = None
    return _lib


def available() -> bool:
    return lib() is not None


def _as_pairs(pairs) -> np.ndarray:
    a = np.ascontiguousarray(pairs, dtype=np.int64)
    if a.ndim != 2 or a.shape[1] != 2:
        raise ValueError("pairs must be [n, 2]")
    return a


def fill_port_bitmaps(pairs, bitmap: np.ndarray) -> None:
    """OR (row, port) pairs into the uint32 [N, W] bitmap in place."""
    a = _as_pairs(pairs)
    l = lib()
    if l is not None and bitmap.flags.c_contiguous:
        l.fill_port_bitmaps(
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(a),
            bitmap.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            bitmap.shape[0], bitmap.shape[1])
        return
    words = bitmap.shape[1]
    for row, port in a:
        if 0 <= row < bitmap.shape[0] and 0 < port < words * 32:
            bitmap[row, port // 32] |= np.uint32(1 << (port % 32))


def fill_multi_hot(pairs, out: np.ndarray) -> None:
    """Set (row, col) entries of the int8 [R, W] matrix to 1 in place."""
    a = _as_pairs(pairs)
    l = lib()
    if l is not None and out.flags.c_contiguous:
        l.fill_multi_hot(
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(a),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            out.shape[0], out.shape[1])
        return
    rows, width = out.shape
    for row, col in a:
        if 0 <= row < rows and 0 <= col < width:
            out[row, col] = 1


def fnv1a64(data: bytes) -> int:
    l = lib()
    if l is not None:
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        return int(l.fnv1a64(buf, len(data)))
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h
