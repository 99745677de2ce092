"""ctypes binding and on-demand build of the native video decoder
(trace_tpu/native/videodec.py).

``videodec.cpp`` beside this file is compiled with g++ against the system
FFmpeg libraries (libavformat, libavcodec, libavutil, libswscale) at first
use, into ``_build/`` beside this file; the library's name carries a hash of
the source and the flags, so an edited source is rebuilt. It is the first
reader of video containers (``video/io.py``): where g++ or FFmpeg's
development files are missing, the first use raises
``NativeDecoderUnavailable`` with the compiler's message, and so does every
later one, and ``video/io.py`` reads containers through OpenCV instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "videodec.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("avformat", "avcodec", "avutil", "swscale")

_lock = threading.Lock()
_lib = None    # the loaded library, once built
_error = None  # the build's failure message, once it failed


class NativeDecoderUnavailable(OSError):
    """The decoder cannot be built or loaded on this machine."""


def _target() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(GXX_FLAGS + LIBS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libvideodec-{digest}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp), *(f"-l{n}" for n in LIBS)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise NativeDecoderUnavailable(f"native decoder: g++ not found ({e})") from e
    if proc.returncode != 0:
        raise NativeDecoderUnavailable(
            f"native decoder build failed (FFmpeg's development files for "
            f"{', '.join(LIBS)} are needed):\n{proc.stderr[-2000:]}")
    os.replace(tmp, out)  # concurrent builds each rename a whole file


def load() -> ctypes.CDLL:
    """The decoder library, built at the first call."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        # a new exception each time: one raised again would collect the
        # frames of every caller in its traceback and keep their locals
        if _error is not None:
            raise NativeDecoderUnavailable(_error)
        out = _target()
        try:
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except OSError as e:
            _error = str(e) if isinstance(e, NativeDecoderUnavailable) else \
                f"native decoder: cannot load {out}: {e}"
            raise NativeDecoderUnavailable(_error) from None
        lib.vd_probe.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.vd_probe.restype = ctypes.c_int
        lib.vd_read_frames.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.vd_read_frames.restype = ctypes.c_int
        lib.vd_last_error.argtypes = []
        lib.vd_last_error.restype = ctypes.c_char_p
        _lib = lib
        return lib


def probe(path: str) -> Tuple[int, float, int, int]:
    """(num_frames, fps, width, height) from the container's header."""
    lib = load()
    nf = ctypes.c_int64()
    fps = ctypes.c_double()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.vd_probe(os.fsencode(path), ctypes.byref(nf), ctypes.byref(fps),
                      ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"probe failed: {lib.vd_last_error().decode()}")
    return int(nf.value), float(fps.value), int(w.value), int(h.value)


def read_frames(path: str, indices: Sequence[int], max_side: int | None = None
                ) -> np.ndarray:
    """Decode the given frame indices -> uint8 [n, H, W, 3] RGB.

    ``max_side`` decodes pre-scaled (aspect-preserving, longest side capped,
    even dims) in the same libswscale pass that converts YUV to RGB, so an
    HD source never lands on the host at its own resolution."""
    lib = load()
    _, _, w, h = probe(path)
    if max_side and max(w, h) > max_side:
        s = max_side / max(w, h)
        w, h = max(2, int(w * s)) & ~1, max(2, int(h * s)) & ~1
    idx = np.ascontiguousarray(np.asarray(indices, np.int64))
    n = len(idx)
    out = np.empty((n, h, w, 3), np.uint8)
    rc = lib.vd_read_frames(
        os.fsencode(path),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        w, h,
    )
    if rc != 0:
        raise IOError(f"decode failed ({rc}): {lib.vd_last_error().decode()}")
    return out
