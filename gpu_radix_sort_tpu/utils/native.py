"""ctypes loader for the native host-runtime library (libsortcore.so).

Builds lazily with `make` on first use if the shared object is missing
(the toolchain is part of the supported environment); every entry point
degrades gracefully to a pure-numpy fallback in the caller when the native
library is unavailable.  Reference analog: the Go/cgo and Python/ctypes
bindings both dlopen libsort.so (benchmark/pkg/sort/libsort.go:24,
faasTest/pylibsort/__init__.py:13-20); here the native library carries only
host-side work (keygen, CPU oracles) since device compute is XLA.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libsortcore.so")

_lib = None
_lib_lock = threading.Lock()
_load_failed = False


def _load():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            if not os.path.exists(_SO_PATH):
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
            lib = ctypes.CDLL(_SO_PATH)
            lib.pcg32_fill.restype = ctypes.c_uint64
            lib.pcg32_fill.argtypes = [
                ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.c_uint64,
            ]
            lib.cpu_sort_u32.restype = ctypes.c_bool
            lib.cpu_sort_u32.argtypes = [
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.c_uint64,
            ]
            lib.cpu_partial_u32.restype = ctypes.c_bool
            lib.cpu_partial_u32.argtypes = [
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.c_uint64,
                ctypes.c_uint32,
                ctypes.c_uint32,
            ]
            lib.histogram_u32.restype = None
            lib.histogram_u32.argtypes = [
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.c_uint64,
                ctypes.c_uint32,
                ctypes.c_uint32,
                ctypes.POINTER(ctypes.c_uint64),
            ]
            _lib = lib
        except Exception:
            _load_failed = True
    return _lib


def available() -> bool:
    return _load() is not None


def _u32_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def pcg32_fill(state: np.uint64, n: int):
    """Returns (array | None, new_state). None array means no native lib."""
    lib = _load()
    if lib is None:
        return None, state
    out = np.empty(n, dtype=np.uint32)
    new_state = lib.pcg32_fill(ctypes.c_uint64(int(state)), _u32_ptr(out), n)
    return out, np.uint64(new_state)


def cpu_sort(keys: np.ndarray) -> np.ndarray | None:
    """Ascending sort (copy); None if no native lib."""
    lib = _load()
    if lib is None:
        return None
    out = np.ascontiguousarray(keys, dtype=np.uint32).copy()
    lib.cpu_sort_u32(_u32_ptr(out), out.size)
    return out


def cpu_partial(keys: np.ndarray, offset: int, width: int):
    """(sorted_copy, boundaries) with reference contract; None if no lib."""
    lib = _load()
    if lib is None:
        return None
    out = np.ascontiguousarray(keys, dtype=np.uint32).copy()
    boundaries = np.zeros(1 << width, dtype=np.uint32)
    ok = lib.cpu_partial_u32(
        _u32_ptr(out), _u32_ptr(boundaries), out.size, offset, width
    )
    if not ok:
        raise ValueError(f"invalid partial-sort args offset={offset} width={width}")
    return out, boundaries


def histogram(keys: np.ndarray, offset: int, width: int) -> np.ndarray | None:
    if width <= 0 or width > 32 or offset < 0 or offset + width > 32:
        # histogram_u32 itself has no return channel for bad ranges; an
        # out-of-range shift is C++ UB (x86 shifts mod 32 — wrong counts,
        # silently)
        raise ValueError(f"invalid digit range offset={offset} width={width}")
    lib = _load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    counts = np.zeros(1 << width, dtype=np.uint64)
    lib.histogram_u32(
        _u32_ptr(keys),
        keys.size,
        offset,
        width,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    return counts
