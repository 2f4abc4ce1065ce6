"""ctypes bindings for the native (C++ libpng/libjpeg) stacked-frame decoder.

Counterpart of monkeynet_tpu/data/native.py. The source is the repository's
native/monkeynet_io.cpp, compiled unchanged with the flags of native/Makefile
into the port's git-ignored build directory on first use (never into
native/). Callers fall back to the Pillow path when the library does not
build or load (io.decode_video does the dispatch).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = _PACKAGE_DIR.parent / "native" / "monkeynet_io.cpp"
BUILD_DIR = _PACKAGE_DIR / "_kernels_build"
# native/Makefile's CXXFLAGS and LDLIBS
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
LD_LIBS = ("-lpng", "-ljpeg", "-lz")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LD_LIBS).encode())
    return BUILD_DIR / f"libmonkeynet_io_{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> bool:
    """Compile SOURCE into `lib` (staged, then renamed, so two processes
    compiling at once never load a half-written file). False if it cannot
    build."""
    cxx = os.environ.get("CXX", "g++")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            staged = Path(tmp) / lib.name
            subprocess.run(
                [cxx, *CXX_FLAGS, "-o", str(staged), str(SOURCE), *LD_LIBS],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(staged, lib)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            path = library_path()
        except OSError:  # the source is not beside the package
            _load_failed = True
            return None
        if not path.exists() and not _build(path):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _load_failed = True
            return None
        lib.mk_probe.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.mk_probe.restype = ctypes.c_int
        lib.mk_decode_stacked.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
        ]
        lib.mk_decode_stacked.restype = ctypes.c_int
        _lib = lib
        return _lib


def read_stacked(path: str, frame_h: int, frame_w: int) -> Optional[np.ndarray]:
    """Decode a stacked-frame PNG/JPG to (T, frame_h, frame_w, 3) float32,
    or None when the native decoder is unavailable or declines the file."""
    lib = get_lib()
    if lib is None:
        return None
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.mk_probe(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    # Native decode only at the file's own frame size: the file height must
    # equal the requested frame height and the width must tile into
    # requested-width frames. Other sizes take the Pillow path, which
    # slices at the native size and then resizes.
    if h.value != frame_h or w.value % frame_w != 0:
        return None
    max_frames = w.value // frame_w
    out = np.empty((max_frames, frame_h, frame_w, 3), np.float32)
    t = lib.mk_decode_stacked(
        path.encode(), frame_h, frame_w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_frames,
    )
    if t <= 0:
        return None
    return out[:t]
