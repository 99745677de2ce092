"""Video decode front end: batched random-access frame extraction
(trace_tpu/video/io.py).

Readers by path, as in the JAX package:

* ``.npy`` tensors (uint8 [T, H, W, 3]; 30 fps) and frame directories
  (3 fps, read with PIL);
* single images, replicated across the frame axis with zero timestamps
  (PIL);
* gif (imageio; 10 fps);
* every other container (mp4, webm, mkv, ...) through the native
  libavformat/libavcodec decoder (``native/videodec``) alone. The JAX
  package falls back to OpenCV where that decoder is missing; the port has
  no such fallback: where the decoder cannot build, reading a container
  raises ``NativeDecoderUnavailable`` naming what is missing.

PIL and imageio are imported where they are used, so a machine without them
reads ``.npy`` and containers. Every reader returns (frames uint8
[T, H, W, 3] RGB, timestamps [[sec], ...]).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from trace_tpu_torch.constants import NUM_FRAMES
from trace_tpu_torch.video.sampling import (
    cap_to_max_frames,
    frame_timestamps,
    sample_frame_indices,
)

Frames = np.ndarray
Timestamps = list

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
FRAME_DIR_EXTS = (".jpg", ".jpeg", ".png")
GIF_FPS = 10.0       # the reference hard-codes gif fps=10 (mm_utils.py:406)
FRAME_DIR_FPS = 3.0  # MVBench frame dirs are 3 fps (mvbench/evaluate.py:270)
NPY_FPS = 30.0


def _read_gif(path: str, indices: np.ndarray) -> Frames:
    import imageio

    reader = imageio.get_reader(path)
    wanted = set(int(i) for i in indices)
    frames = [np.asarray(f)[..., :3] for i, f in enumerate(reader) if i in wanted]
    return np.stack(frames)


def probe(path: str) -> Tuple[int, float]:
    """(frame_count, fps) of a video container, from the native decoder's
    reading of its header."""
    from trace_tpu_torch.native import videodec

    count, fps, _, _ = videodec.probe(path)
    return count, fps or 30.0


def probe_media(path: str) -> None:
    """Cheap openability check: container header only, no frame decode.

    Raises on missing / unreadable media. Eval drivers use it to pre-filter
    corpora without a second full decode pass."""
    if os.path.isdir(path):
        if not any(f.lower().endswith(FRAME_DIR_EXTS) for f in os.listdir(path)):
            raise IOError(f"no frame images in directory: {path}")
        return
    if not os.path.exists(path):
        raise IOError(f"no such file: {path}")
    if path.endswith(".npy") or path.lower().endswith(IMAGE_EXTS):
        return  # existence is enough; decode failures surface in the loader
    if path.endswith(".gif"):
        import imageio

        imageio.get_reader(path).close()
        return
    count, _fps = probe(path)
    if count <= 0:
        raise IOError(f"no frames reported by container: {path}")


def read_frames_at(path: str, indices: np.ndarray,
                   max_side: int | None = None) -> Frames:
    """Random-access decode of specific frame indices of a container.
    ``max_side`` caps the decoded resolution in the decoder's swscale pass
    (one resample; HD never reaches host RAM at full size)."""
    from trace_tpu_torch.native import videodec

    return videodec.read_frames(path, indices, max_side=max_side)


def load_video_frames(
    path: str,
    num_frames: int = NUM_FRAMES,
    sample_scheme: str = "uniform",
    *,
    rng: Optional[np.random.Generator] = None,
    max_side: int | None = None,
) -> Tuple[Frames, Timestamps]:
    """Decode + sample frames from a video file / gif / image dir / npy /
    image, routed by path as the reference's process_video routes containers
    (mm_utils.py:400-448), capped at MAX_FRAMES, with per-frame timestamps in
    the reference's nested shape."""
    if os.path.isdir(path):
        return _load_image_dir(path, num_frames)
    if path.endswith(".npy"):
        return _load_npy(path, num_frames)
    if path.lower().endswith(IMAGE_EXTS):
        return load_image_as_video(path, num_frames)

    if path.endswith(".gif"):
        import imageio

        reader = imageio.get_reader(path)
        duration = reader.get_length()
        if not np.isfinite(duration) or duration <= 0:
            duration = sum(1 for _ in imageio.get_reader(path))
        indices = sample_frame_indices(duration, num_frames, sample_scheme,
                                       fps=GIF_FPS, rng=rng)
        indices = cap_to_max_frames(indices, duration)
        return _read_gif(path, indices), frame_timestamps(indices, GIF_FPS)

    duration, fps = probe(path)
    indices = sample_frame_indices(duration, num_frames, sample_scheme, fps=fps, rng=rng)
    indices = cap_to_max_frames(indices, duration)
    frames = read_frames_at(path, indices, max_side=max_side)
    return frames, frame_timestamps(indices, fps)


def load_image_as_video(path: str, num_frames: int = NUM_FRAMES) -> Tuple[Frames, Timestamps]:
    """Image modality: the image replicated across the frame axis with zero
    timestamps (reference: trace_arch.py:221 expand, train_mt.py:838
    video_timestamps=[[0]]*num_frames)."""
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"))
    frames = np.broadcast_to(img, (num_frames,) + img.shape).copy()
    return frames, [[0.0]] * num_frames


def _load_image_dir(path: str, num_frames: int) -> Tuple[Frames, Timestamps]:
    """A directory of ordered frame images (MVBench 'frame' reader style,
    reference mvbench/evaluate.py:268-289)."""
    from PIL import Image

    files = sorted(f for f in os.listdir(path) if f.lower().endswith(FRAME_DIR_EXTS))
    duration = len(files)
    indices = sample_frame_indices(duration, num_frames, "uniform")
    indices = cap_to_max_frames(indices, duration)
    frames = np.stack([
        np.asarray(Image.open(os.path.join(path, files[int(i)])).convert("RGB"))
        for i in indices
    ])
    return frames, frame_timestamps(indices, FRAME_DIR_FPS)


def _load_npy(path: str, num_frames: int) -> Tuple[Frames, Timestamps]:
    """Pre-decoded uint8 [T, H, W, 3] tensor (tests / cached decode)."""
    video = np.load(path)
    duration = video.shape[0]
    indices = sample_frame_indices(duration, num_frames, "uniform")
    indices = cap_to_max_frames(indices, duration)
    return video[indices], frame_timestamps(indices, NPY_FPS)
