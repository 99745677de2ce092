"""Video decode front end: batched random-access frame extraction
(trace_tpu/video/io.py).

Readers by path, as in the JAX package:

* ``.npy`` tensors (uint8 [T, H, W, 3]; 30 fps) and frame directories
  (3 fps, read with PIL);
* single images, replicated across the frame axis with zero timestamps
  (PIL);
* gif (imageio; 10 fps);
* every other container (mp4, webm, mkv, ...) through the native
  libavformat/libavcodec decoder (``native/videodec``) where it builds and
  reads the file, else through OpenCV (``cv2``, FFmpeg-backed), in the JAX
  package's order. ``container_reader()`` names the route this machine
  takes, and ``CONTAINER_READS`` counts the reads of each route. On the
  OpenCV route ``max_side`` is ignored, as in the JAX package: frames come
  back at the source's size.

PIL, imageio and cv2 are imported where they are used, so a machine without
them reads ``.npy`` and the rest. Every reader returns (frames uint8
[T, H, W, 3] RGB, timestamps [[sec], ...]).
"""

from __future__ import annotations

import os
import threading
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


# reads of a container by the route that returned its frames
CONTAINER_READS = {"native": 0, "opencv": 0}
_reads_lock = threading.Lock()


def _count_read(route: str) -> None:
    with _reads_lock:
        CONTAINER_READS[route] += 1


def _read_cv2(path: str, indices: np.ndarray) -> Frames:
    """The given frame indices of a container through OpenCV, at the
    source's size: a seek where an index does not follow the last one."""
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            raise IOError(f"cannot open video: {path}")
        frames = []
        last_pos = -2
        for idx in indices:
            idx = int(idx)
            if idx != last_pos + 1:
                cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
            ok, frame = cap.read()
            if not ok:
                raise IOError(f"failed to read frame {idx} of {path}")
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            last_pos = idx
    finally:
        cap.release()
    return np.stack(frames)


def _probe_cv2(path: str) -> Tuple[int, float]:
    """(frame_count, fps) from OpenCV's reading of the container (30 fps
    where it reports none)."""
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            raise IOError(f"cannot open video: {path}")
        duration = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        fps = float(cap.get(cv2.CAP_PROP_FPS)) or 30.0
    finally:
        cap.release()
    return duration, fps


def container_reader() -> str:
    """The route video containers take on this machine: ``"native"`` where
    the native decoder builds and loads, else ``"opencv (native decoder
    unavailable: <the first line of its build error>)"``."""
    from trace_tpu_torch.native import videodec

    try:
        videodec.load()
    except videodec.NativeDecoderUnavailable as e:
        return f"opencv (native decoder unavailable: {str(e).splitlines()[0]})"
    return "native"


def probe(path: str) -> Tuple[int, float]:
    """(frame_count, fps) of a video container: the native decoder's reading
    of its header where it loads, else OpenCV's."""
    if container_reader() == "native":
        from trace_tpu_torch.native import videodec

        count, fps, _, _ = videodec.probe(path)
        return count, fps or 30.0
    return _probe_cv2(path)


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


def read_frames_at(path: str, indices: np.ndarray, use_native: bool = True,
                   max_side: int | None = None) -> Frames:
    """Random-access decode of specific frame indices of a container: the
    native decoder where ``use_native`` is set and it loads, OpenCV where it
    does not or its read fails, as in the JAX package. ``max_side`` caps the
    decoded resolution in the native decoder's swscale pass (one resample;
    HD never reaches host RAM at full size); OpenCV ignores it."""
    if use_native:
        from trace_tpu_torch.native import videodec

        try:
            frames = videodec.read_frames(path, indices, max_side=max_side)
        except OSError:  # NativeDecoderUnavailable too
            pass
        else:
            _count_read("native")
            return frames
    frames = _read_cv2(path, indices)
    _count_read("opencv")
    return frames


def load_video_frames(
    path: str,
    num_frames: int = NUM_FRAMES,
    sample_scheme: str = "uniform",
    *,
    rng: Optional[np.random.Generator] = None,
    use_native: bool = True,
    max_side: int | None = None,
) -> Tuple[Frames, Timestamps]:
    """Decode + sample frames from a video file / gif / image dir / npy /
    image, routed by path as the reference's process_video routes containers
    (mm_utils.py:400-448), capped at MAX_FRAMES, with per-frame timestamps in
    the reference's nested shape. A container is probed and read through
    the native decoder where ``use_native`` is set and it loads, else
    through OpenCV (``read_frames_at``)."""
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

    duration, fps = probe(path) if use_native else _probe_cv2(path)
    indices = sample_frame_indices(duration, num_frames, sample_scheme, fps=fps, rng=rng)
    indices = cap_to_max_frames(indices, duration)
    frames = read_frames_at(path, indices, use_native, max_side)
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
