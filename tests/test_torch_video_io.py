"""The port's video front end (trace_tpu_torch/video/{io,sampling,scene,
anyres}.py, native/videodec) against the JAX package's on the same files:
frame indices, frames and timestamps equal, element for element.

Files are written in the test: ``.npy`` tensors, frame directories and
images (PIL), a gif (imageio) and an mp4 (``cv2.VideoWriter``). The JAX
package reads the mp4 with its own native decoder where that builds, else
through OpenCV; the port reads containers with its native decoder alone, and
the mp4 tests skip where it cannot build."""

import numpy as np
import pytest

from trace_tpu.video import anyres as janyres
from trace_tpu.video import io as jio
from trace_tpu.video import sampling as jsampling
from trace_tpu.video import scene as jscene
from trace_tpu_torch.native import videodec
from trace_tpu_torch.video import anyres as tanyres
from trace_tpu_torch.video import io as tio
from trace_tpu_torch.video import sampling as tsampling
from trace_tpu_torch.video import scene as tscene


def _assert_same(got, want):
    (gf, gts), (wf, wts) = got, want
    assert gf.dtype == wf.dtype == np.uint8 and gf.shape == wf.shape
    np.testing.assert_array_equal(gf, wf)
    assert gts == wts


@pytest.fixture
def decoder():
    try:
        videodec.load()
    except videodec.NativeDecoderUnavailable as e:
        pytest.skip(f"the native decoder does not build here: {e}")


@pytest.fixture(scope="module")
def mp4(tmp_path_factory):
    """A 40-frame 96x64 mp4 at 25 fps whose frames differ (a moving bar)."""
    import cv2

    path = str(tmp_path_factory.mktemp("mp4") / "clip.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (96, 64))
    assert writer.isOpened()
    for i in range(40):
        frame = np.full((64, 96, 3), 40, np.uint8)
        frame[:, (2 * i) % 96:(2 * i) % 96 + 8] = (200, 60 + 4 * i, 30)
        writer.write(frame)
    writer.release()
    return path


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("duration, num", [(100, 8), (7, 16), (1, 4), (3000, 128)])
@pytest.mark.parametrize("scheme", ["uniform", "fps", "rand"])
def test_sample_frame_indices_match_jax(scheme, duration, num):
    kw = dict(fps=29.97)
    got = tsampling.sample_frame_indices(duration, num, scheme,
                                         rng=np.random.default_rng(7), **kw)
    want = jsampling.sample_frame_indices(duration, num, scheme,
                                          rng=np.random.default_rng(7), **kw)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(tsampling.cap_to_max_frames(got, duration),
                                  jsampling.cap_to_max_frames(want, duration))
    assert tsampling.frame_timestamps(got, 29.97) == jsampling.frame_timestamps(want, 29.97)


def test_sampling_errors_match_jax():
    with pytest.raises(ValueError):
        tsampling.sample_frame_indices(10, 4, "bogus")
    with pytest.raises(ValueError, match="too long"):
        tsampling.frame_timestamps([10_000 * 30], 30.0)


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T, num", [(50, 8), (5, 8)])
def test_npy_matches_jax(tmp_path, T, num):
    video = np.random.default_rng(T).integers(0, 256, (T, 24, 32, 3), dtype=np.uint8)
    np.save(tmp_path / "v.npy", video)
    _assert_same(tio.load_video_frames(str(tmp_path / "v.npy"), num),
                 jio.load_video_frames(str(tmp_path / "v.npy"), num))


def test_frame_dir_and_image_match_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(3)
    (tmp_path / "frames").mkdir()
    for i in range(11):
        Image.fromarray(rng.integers(0, 256, (20, 28, 3), dtype=np.uint8)).save(
            tmp_path / "frames" / f"{i:04d}.png")
    (tmp_path / "frames" / "notes.txt").write_text("not a frame")
    _assert_same(tio.load_video_frames(str(tmp_path / "frames"), 4),
                 jio.load_video_frames(str(tmp_path / "frames"), 4))
    Image.fromarray(rng.integers(0, 256, (30, 18, 3), dtype=np.uint8)).save(tmp_path / "i.png")
    _assert_same(tio.load_video_frames(str(tmp_path / "i.png"), 5),
                 jio.load_video_frames(str(tmp_path / "i.png"), 5))
    _assert_same(tio.load_image_as_video(str(tmp_path / "i.png"), 3),
                 jio.load_image_as_video(str(tmp_path / "i.png"), 3))


def test_gif_matches_jax(tmp_path):
    imageio = pytest.importorskip("imageio")
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, (9, 16, 20, 3), dtype=np.uint8)
    imageio.mimsave(tmp_path / "a.gif", list(frames), duration=0.1)
    for num in (4, 12):  # 12 > 9 frames: repeated indices, read once each
        _assert_same(tio.load_video_frames(str(tmp_path / "a.gif"), num),
                     jio.load_video_frames(str(tmp_path / "a.gif"), num))


@pytest.mark.parametrize("scheme, max_side", [("uniform", None), ("fps", None),
                                              ("uniform", 48)])
def test_mp4_matches_jax(decoder, mp4, scheme, max_side):
    """The native decoder's frames and timestamps equal the JAX package's
    reading of the same file (its native decoder, or OpenCV where that does
    not build), with and without the pre-scaled decode."""
    got = tio.load_video_frames(mp4, 8, scheme, max_side=max_side)
    want = jio.load_video_frames(mp4, 8, scheme, max_side=max_side)
    _assert_same(got, want)
    assert got[0].shape[1:] == ((32, 48, 3) if max_side else (64, 96, 3))
    assert len({f.tobytes() for f in got[0]}) == len(got[0])  # other frames each
    assert tio.probe(mp4) == jio.probe(mp4) == (40, 25.0)
    idx = np.array([39, 3, 3, 17])
    np.testing.assert_array_equal(tio.read_frames_at(mp4, idx),
                                  jio.read_frames_at(mp4, idx))


def test_probe_media_matches_jax(tmp_path, decoder, mp4):
    np.save(tmp_path / "ok.npy", np.zeros((2, 4, 4, 3), np.uint8))
    (tmp_path / "bad.mp4").write_bytes(b"not a video container at all" * 10)
    (tmp_path / "empty").mkdir()
    for path in (mp4, str(tmp_path / "ok.npy")):
        tio.probe_media(path)
        jio.probe_media(path)
    for path in ("missing.mp4", "bad.mp4", "empty"):
        for mod in (tio, jio):
            with pytest.raises((IOError, OSError)):
                mod.probe_media(str(tmp_path / path))
    with pytest.raises(IOError):
        tio.load_video_frames(str(tmp_path / "bad.mp4"), 4)


def test_containers_need_the_native_decoder(tmp_path, monkeypatch):
    """Where the decoder cannot build, reading a container raises an error
    that names what is missing, and never returns other frames."""
    broken = tmp_path / "broken.cpp"
    broken.write_text("#include <libavformat/no_such_header.h>\n")
    monkeypatch.setattr(videodec, "SOURCE", broken)
    monkeypatch.setattr(videodec, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(videodec, "_lib", None)
    monkeypatch.setattr(videodec, "_error", None)
    (tmp_path / "v.mp4").write_bytes(b"\0" * 64)
    for _ in range(2):  # the failure is kept: no second build
        with pytest.raises(videodec.NativeDecoderUnavailable, match="avformat"):
            tio.load_video_frames(str(tmp_path / "v.mp4"), 4)
    np.save(tmp_path / "v.npy", np.ones((3, 4, 4, 3), np.uint8))
    assert tio.load_video_frames(str(tmp_path / "v.npy"), 3)[0].shape == (3, 4, 4, 3)


# ---------------------------------------------------------------------------
# Scenes and anyres tiling
# ---------------------------------------------------------------------------

def test_scene_and_anyres_match_jax():
    rng = np.random.default_rng(5)
    frames = np.concatenate([np.full((20, 8, 8, 3), c, np.uint8) for c in (10, 200, 60)])
    frames = np.clip(frames + rng.integers(0, 4, frames.shape), 0, 255).astype(np.uint8)
    assert tscene.detect_scenes(frames, 10.0) == jscene.detect_scenes(frames, 10.0)
    scenes = [(float(i), float(i) + 1 + (i % 3)) for i in range(15)]
    assert tscene.merge_scenes(scenes, 4) == jscene.merge_scenes(scenes, 4)
    image = rng.integers(0, 256, (50, 90, 3), dtype=np.uint8)
    for size in ((90, 50), (336, 336), (1000, 200)):
        assert (tanyres.select_best_resolution(size, [(336, 672), (672, 336), (672, 672)])
                == janyres.select_best_resolution(size, [(336, 672), (672, 336), (672, 672)]))
        assert (tanyres.get_anyres_image_grid_shape(size, 14)
                == janyres.get_anyres_image_grid_shape(size, 14))
    got = tanyres.process_anyres_image(image, 28)
    want = janyres.process_anyres_image(image, 28)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
