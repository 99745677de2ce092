"""Profiling and run telemetry (trace_tpu/utils/profiling.py):

* ``trace`` records ``torch.profiler`` around a block and writes a Chrome
  trace (view in Perfetto or chrome://tracing);
* ``StepTimer`` sums device-synchronized wall times per section;
* ``MetricsLogger`` appends JSONL step metrics, written by the training loop.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Record the enclosed block with ``torch.profiler`` (the CPU, and the
    CUDA card where there is one) and write it as a Chrome trace
    ``trace_<pid>_<ns>.json`` into ``log_dir`` (default: a folder in the
    temporary directory). Yields ``log_dir``."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "trace_tpu_torch_profile")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _synchronize(sync) -> None:
    """Wait for the card's work on every CUDA tensor of ``sync`` (a tensor,
    or a list, tuple or dict of them); CPU tensors need no wait."""
    if isinstance(sync, dict):
        sync = list(sync.values())
    if isinstance(sync, (list, tuple)):
        for t in sync:
            _synchronize(t)
    elif torch.is_tensor(sync) and sync.is_cuda:
        torch.cuda.synchronize(sync.device)


class StepTimer:
    """Device-synchronized section timing: ``with timer("name", sync=t):``
    adds the block's wall time to ``name``, after waiting for the card to
    finish ``t`` (its device's queue) where ``t`` lies on one."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            _synchronize(sync)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_s": round(self.totals[name] / self.counts[name], 4),
            }
            for name in self.totals
        }


class MetricsLogger:
    """Append-only JSONL metrics stream."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a")
        self._t0 = time.time()

    def log(self, step: int, metrics: dict) -> None:
        rec = {"step": step, "wall_s": round(time.time() - self._t0, 2)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
