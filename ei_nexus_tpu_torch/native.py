"""Native host-side event wire encoder (C++/OpenMP via ctypes).

Counterpart of `ei_nexus_tpu/native/__init__.py`, with its own copy of the
source (`csrc/event_ops.cpp`). `lib()` builds the library once with `g++
-O3 -fopenmp` into `ei_nexus_tpu_torch/_build/` (never next to the source;
the file name carries a digest of the source and flags) and loads it.
`compact_encode` fuses the wire encode of `train/steps.py:
compact_event_view` (float event arrays -> uint16 fixed-point coordinates,
uint8 polarity, per-row valid counts) into one parallel pass. Without a
C++ toolchain `lib()` is None and callers take the numpy path.

The two paths round differently at exact half quanta: the C++ loop
truncates v * 64 + 0.5 (half up), numpy's `np.round` rounds half to even,
as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "event_ops.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def library_path() -> Path:
    """Where the library is built: a digest of the source and the flags in
    its file name, so an edited source is rebuilt."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libeventops-{h.hexdigest()[:16]}.so"


def build() -> Optional[Path]:
    """Compile the library if it is missing (with -march=native, else
    without). Returns its path, or None when no toolchain builds it."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    base = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    for cmd in (base[:1] + ["-march=native"] + base[1:], base):
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except (OSError, subprocess.CalledProcessError):
            continue
        os.replace(tmp, out)
        return out
    tmp.unlink(missing_ok=True)
    return None


def lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built at the first call; None without a
    toolchain (the result of the first attempt is kept)."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        path = build()
        if path is None:
            return None
        L = ctypes.CDLL(str(path))
        i64 = ctypes.c_int64
        L.compact_encode.argtypes = [_f32p, _f32p, _f32p, _u8p, i64, i64,
                                     ctypes.c_float, _u16p, _u16p, _u8p,
                                     _i32p]
        L.compact_encode.restype = None
        _LIB = L
        return _LIB


def compact_encode(x: np.ndarray, y: np.ndarray, p: np.ndarray,
                   valid: np.ndarray, scale: float
                   ) -> Optional[Tuple[np.ndarray, ...]]:
    """(B, L) float32 event arrays -> (xq u16, yq u16, pq u8, n i32) in one
    OpenMP pass, or None when the library is unavailable or the inputs do
    not have the fast path's layout."""
    L = lib()
    if L is None:
        return None
    if not (x.dtype == y.dtype == p.dtype == np.float32) or x.ndim != 2:
        return None
    x = np.ascontiguousarray(x)
    y = np.ascontiguousarray(y)
    p = np.ascontiguousarray(p)
    v = np.ascontiguousarray(valid).view(np.uint8)
    B, n_ev = x.shape
    xq = np.empty((B, n_ev), np.uint16)
    yq = np.empty((B, n_ev), np.uint16)
    pq = np.empty((B, n_ev), np.uint8)
    n = np.empty((B,), np.int32)
    L.compact_encode(x, y, p, v, B, n_ev, np.float32(scale), xq, yq, pq, n)
    return xq, yq, pq, n
