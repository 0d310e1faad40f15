"""ctypes loader for the native COLMAP reader (native/colmap_io.cpp).

Port of instascene_tpu/data/native.py:36-85 (`get_lib`,
`points3d_parse_native`). The same C++ source, unedited, is built on first
use with g++ into instascene_tpu_torch/_build/ (listed in .gitignore),
named by a hash of the source and flags, and memoized. As in the JAX
package the library is an accelerator, never a dependency: without g++ or
the source, `get_lib` returns None and the reader takes its pure-Python
path; a malformed buffer parses to None.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG.parent / "native" / "colmap_io.cpp"
_FLAGS = ["-O2", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _target() -> Path:
    h = hashlib.sha256(SRC.read_bytes() + " ".join(_FLAGS).encode())
    return _PKG / "_build" / f"libcolmap_io-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(SRC)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, out)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None if it cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not SRC.exists():
            return None
        so = _target()
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        lib.points3d_parse.restype = ctypes.c_longlong
        lib.points3d_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_double)]
        _lib = lib
        return _lib


def points3d_parse_native(data: bytes):
    """Parse a points3D.bin buffer natively: (xyz [N,3] f64, rgb [N,3] u8,
    errors [N,1] f64), or None when the library is unavailable or the
    buffer is malformed."""
    lib = get_lib()
    if lib is None or len(data) < 8:
        return None
    n = int(np.frombuffer(data[:8], np.uint64)[0])
    if n > (len(data) - 8) // 51:     # a record takes at least 51 bytes
        return None
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty((n, 1), np.float64)
    got = lib.points3d_parse(
        data, len(data),
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        err.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if got != n:
        return None
    return xyz, rgb, err
