"""Native (C++/OpenMP) host kernels with build-on-first-import + ctypes.

The port's copy of visrag_tpu/native: host code, not a device kernel. The
host-side data-loader hot loops (the role torchvision's C++ kernels play for
the reference) are native C++ here. The shared object is compiled once with
g++ into the git-ignored visrag_tpu_torch/build/ (keyed by source mtime) and
bound with ctypes — no pybind11/pip needed. Every entry
point has a numpy fallback so the package works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "patchify.cc")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _build() -> str:
    cache = os.path.join(os.path.dirname(_HERE), "build")
    os.makedirs(cache, exist_ok=True)
    tag = int(os.stat(_SRC).st_mtime)
    so = os.path.join(cache, f"_patchify_{tag}.so")
    if not os.path.exists(so):
        tmp = so + f".tmp{os.getpid()}"
        subprocess.run(
            ["g++", "-O3", "-fopenmp", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    return so


def _lib():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            lib = ctypes.CDLL(_build())
            lib.patchify_u8.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
                ctypes.c_void_p]
            lib.patchify_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
            _LIB = lib
        except Exception:      # no toolchain / unusual platform → numpy path
            _LIB = None
    return _LIB


def patchify_u8_native(arr: np.ndarray, ps: int, out: np.ndarray) -> bool:
    """(H, W, 3) uint8 → out[: gh*gw] rows of (3*ps*ps) u8 patch pixels.
    Returns False if the native library is unavailable (caller falls back)."""
    lib = _lib()
    if lib is None:
        return False
    arr = np.ascontiguousarray(arr)
    h, w, _ = arr.shape
    lib.patchify_u8(arr.ctypes.data, h, w, ps, out.ctypes.data)
    return True


def patchify_f32_native(arr: np.ndarray, ps: int, mean: np.ndarray,
                        std: np.ndarray, out: np.ndarray) -> bool:
    """(H, W, 3) uint8 → normalized fp32 patch rows ((x/255 - mean)/std)."""
    lib = _lib()
    if lib is None:
        return False
    arr = np.ascontiguousarray(arr)
    h, w, _ = arr.shape
    mean = np.ascontiguousarray(mean, np.float32)
    inv_std = np.ascontiguousarray(1.0 / np.asarray(std, np.float32))
    lib.patchify_f32(arr.ctypes.data, h, w, ps, mean.ctypes.data,
                     inv_std.ctypes.data, out.ctypes.data)
    return True
