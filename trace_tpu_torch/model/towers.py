"""Time / score / sync embedding towers (trace_tpu/model/towers.py): small
learned tables over each field's local vocab (13 ids for time and score, 1
for sync), held as plain tensors in the params dict. The score and sync
rows reach the decoder through the combined embedding table
(model/trace_model.py); the time rows also follow each frame's slots."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from trace_tpu_torch.tokenizers.event_codec import TIME_CODEC


def embed_time(towers: dict, local_ids: torch.Tensor) -> torch.Tensor:
    return towers["time"][local_ids]


def frame_time_tokens(timestamps_sec: Sequence) -> np.ndarray:
    """Per-frame timestamps ([[sec], ...] or [sec, ...]) -> [T, 6] local
    time-token ids (the terminating <sync> of each value is dropped)."""
    rows = []
    for t in list(timestamps_sec):
        t = float(t[0]) if isinstance(t, (list, tuple)) else float(t)
        rows.append(TIME_CODEC.encode_value(t))
    return np.asarray(rows, np.int64)
