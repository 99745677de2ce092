"""Frame index sampling schemes (a copy of trace_tpu/video/sampling.py).

Reference: frame_sample inside process_video (reference trace/
mm_utils.py:380-398). Pure-numpy, host-side.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from trace_tpu_torch.constants import MAX_FRAMES, NUM_FRAMES_PER_SECOND


def sample_frame_indices(
    duration: int,
    num_frames: int,
    scheme: str = "uniform",
    *,
    fps: Optional[float] = None,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Pick frame indices in [0, duration) by scheme.

    - 'uniform': evenly spaced (mm_utils.py:381-382)
    - 'fps':     one frame per NUM_FRAMES_PER_SECOND seconds (mm_utils.py:383-386)
    - 'rand':    jittered per-interval choice used for stage-2 SFT
                 (mm_utils.py:387-396, --sample_scheme rand in sft-128.sh:71)
    """
    if scheme == "uniform":
        return np.linspace(0, duration - 1, num_frames, dtype=int)
    if scheme == "fps":
        if fps is None:
            raise ValueError("fps sampling needs the stream fps")
        segment_len = min(int(fps) // NUM_FRAMES_PER_SECOND, duration)
        segment_len = max(segment_len, 1)
        return np.arange(segment_len // 2, duration, segment_len, dtype=int)
    if scheme == "rand":
        rng = rng or np.random.default_rng()
        intervals = np.linspace(0, duration - 1, num=num_frames + 1).astype(int)
        indices = []
        for lo, hi in zip(intervals[:-1], intervals[1:] - 1):
            candidates = np.linspace(lo, hi, num=6).astype(int)[:-1]
            indices.append(int(rng.choice(candidates)))
        return np.asarray(indices, dtype=int)
    raise ValueError(f"Unsupported frame sampling scheme: {scheme}")


def cap_to_max_frames(indices: np.ndarray, duration: int) -> np.ndarray:
    """Re-sample uniformly if over MAX_FRAMES (mm_utils.py:407-431)."""
    if len(indices) > MAX_FRAMES:
        return np.linspace(0, duration - 1, MAX_FRAMES, dtype=int)
    return indices


def frame_timestamps(indices: Sequence[int], fps: float) -> list[list[float]]:
    """Per-frame timestamps in seconds, the reference's nested-list shape
    (mm_utils.py:439,452,467-470). Raises on >9999 s (6-char serialization cap)
    and on negative timestamps."""
    ts = [[float(i) / fps] for i in indices]
    if ts and ts[-1][0] > 9999:
        raise ValueError("The video is too long (timestamp exceeds 9999 s)")
    if ts and ts[0][0] < 0:
        raise ValueError("Timestamp can not be less than zero")
    return ts
