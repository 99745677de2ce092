"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each source under ``csrc/`` compiles on its own (all nvcc processes start
together) into a shared library with a plain C interface, in ``_build/``
beside this file. A library's file name carries a hash of its source, the
shared headers (``*.cuh``) and the flags, so an edited source is rebuilt and
an unchanged one is reused. The
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
SOURCES = ("attention.cu", "attention_bwd.cu", "decode_attention.cu",
           "decode_attention_int8.cu", "quant_matmul.cu", "quant_matmul_p4.cu",
           # the backward's dq and dk/dv kernels at width 256 (hd 129-256)
           "attention_bwd_256.cu",
           # the decode kernels' instances at head dims other than 64 and 128
           # (libraries of their own, so that they compile in parallel): up to
           # 128, and at width 256 (hd 256, then 132 ... 252)
           "decode_attention_pad.cu", "decode_attention_int8_pad.cu",
           "decode_attention_256.cu", "decode_attention_int8_256.cu",
           "decode_attention_256_pad.cu", "decode_attention_int8_256_pad.cu",
           # the fp32 forms, chosen by the wrappers for fp32 operands (the
           # decode kernels' fp32 instances live in their bf16 sources)
           "attention_f32.cu", "attention_bwd_f32.cu", "quant_matmul_f32.cu")
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
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        (CSRC / source).read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
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


_COUNTS = threading.Lock()


def count_launch(fn, table: str = None, key=None) -> None:
    """One launch of ``fn``'s kernel: ``fn.launches`` (or, with ``table``,
    ``getattr(fn, table)`` plus one if it is an int, else its ``[key]``)
    plus one, under a lock, so that threads launching at once (the corpus's
    encode and decode threads) lose no count."""
    with _COUNTS:
        if table is None:
            fn.launches += 1
        elif key is None:
            setattr(fn, table, getattr(fn, table) + 1)
        else:
            getattr(fn, table)[key] += 1


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
