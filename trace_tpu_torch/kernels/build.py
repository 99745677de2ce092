"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each source under ``csrc/`` compiles on its own (all nvcc processes start
together) into a shared library with a plain C interface, in ``_build/``
beside this file. A library's file name carries a hash of its source and
flags, so an edited source is rebuilt and an unchanged one is reused. The
build happens at first use, never at import: machines without a CUDA
toolkit import every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("attention.cu", "decode_attention.cu", "decode_attention_int8.cu",
           "quant_matmul.cu", "quant_matmul_p4.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """The nvcc binary: $CUDA_HOME/bin/nvcc, else the one on PATH, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(source: str) -> Path:
    digest = hashlib.sha256(
        (CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build_all() -> dict[str, Path]:
    """Compile every source that has no up-to-date library, in parallel.
    Raises with nvcc's output if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {s: _target(s) for s in SOURCES}
    procs = {}
    for src, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    errors = []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return targets


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source under csrc/, built if needed."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            path = build_all()[source]
            lib = ctypes.CDLL(str(path))
            _LIBS[source] = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
