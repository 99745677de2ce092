"""Scene cut detection + merging (aux path; a copy of trace_tpu/video/scene.py).

Pure-numpy replacement for the reference's PySceneDetect/OpenCV dependency
(split_video_into_scenes / merge_scenes, mm_utils.py:24-122): HSV content
delta between consecutive frames against a threshold, then greedy merging of
the shortest adjacent scenes down to a cap.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

Scene = Tuple[float, float]  # (start_sec, end_sec)


def _rgb_to_hsv(frames: np.ndarray) -> np.ndarray:
    """uint8 RGB [T, H, W, 3] -> float HSV in [0, 255] scale (cv2 convention
    approximation sufficient for content deltas)."""
    f = frames.astype(np.float32) / 255.0
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    maxc = f.max(-1)
    minc = f.min(-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-9), 0.0)
    h = np.zeros_like(maxc)
    mask = delta > 0
    rc = np.where(mask, (maxc - r) / np.maximum(delta, 1e-9), 0)
    gc = np.where(mask, (maxc - g) / np.maximum(delta, 1e-9), 0)
    bc = np.where(mask, (maxc - b) / np.maximum(delta, 1e-9), 0)
    h = np.where(maxc == r, bc - gc, h)
    h = np.where(maxc == g, 2.0 + rc - bc, h)
    h = np.where(maxc == b, 4.0 + gc - rc, h)
    h = (h / 6.0) % 1.0
    return np.stack([h * 255, s * 255, v * 255], axis=-1)


def detect_scenes(
    frames: np.ndarray,
    fps: float,
    threshold: float = 27.0,
    min_scene_len: int = 15,
) -> List[Scene]:
    """Content-delta scene splitting over decoded frames.

    Mirrors PySceneDetect's ContentDetector decision rule: mean absolute HSV
    channel delta between consecutive frames above ``threshold`` opens a new
    scene; scenes shorter than ``min_scene_len`` frames never split.
    """
    T = frames.shape[0]
    if T == 0:
        return []
    hsv = _rgb_to_hsv(frames)
    deltas = np.abs(np.diff(hsv, axis=0)).mean(axis=(1, 2, 3))  # [T-1]

    cuts = [0]
    for i, d in enumerate(deltas, start=1):
        if d >= threshold and (i - cuts[-1]) >= min_scene_len:
            cuts.append(i)
    cuts.append(T)
    return [(a / fps, b / fps) for a, b in zip(cuts[:-1], cuts[1:])]


def merge_scenes(scenes: List[Scene], max_scenes: int = 10) -> List[Scene]:
    """Greedy merge of the shortest adjacent scene pair until <= max_scenes
    (reference merge_scenes, mm_utils.py:24-41)."""
    scenes = list(scenes)
    while len(scenes) > max_scenes:
        lengths = [
            (scenes[i][1] - scenes[i][0]) + (scenes[i + 1][1] - scenes[i + 1][0])
            for i in range(len(scenes) - 1)
        ]
        i = int(np.argmin(lengths))
        scenes[i : i + 2] = [(scenes[i][0], scenes[i + 1][1])]
    return scenes
