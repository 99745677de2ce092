"""Run telemetry (``MetricsLogger`` of trace_tpu/utils/profiling.py): an
append-only JSONL stream of step metrics, written by the training loop."""

from __future__ import annotations

import json
import os
import time


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
