"""The port's video front end (trace_tpu_torch/video/{io,sampling,scene,
anyres}.py, native/videodec) against the JAX package's on the same files:
frame indices, frames and timestamps equal, element for element.

Files are written in the test: ``.npy`` tensors, frame directories and
images (PIL), a gif (imageio) and an mp4 (``cv2.VideoWriter``). Both
packages read containers through their native decoder where it builds, else
through OpenCV. The mp4 tests run on each route: the native one where the
port's decoder builds (they skip where it does not), the OpenCV one always,
reached through ``use_native=False`` and through a decoder whose build is
made to fail, against the JAX package's OpenCV route."""

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


def break_native_decoder(monkeypatch, where):
    """Make the port's native decoder fail to build (a source that includes
    a header no machine has, built into ``where``), as on a machine without
    FFmpeg's development files; returns the list of its build attempts."""
    broken = where / "broken.cpp"
    broken.write_text("#include <libavformat/no_such_header.h>\n")
    builds = []
    real_build = videodec._build

    def counting_build(out):
        builds.append(out)
        real_build(out)

    monkeypatch.setattr(videodec, "SOURCE", broken)
    monkeypatch.setattr(videodec, "BUILD_DIR", where / "_build")
    monkeypatch.setattr(videodec, "_build", counting_build)
    monkeypatch.setattr(videodec, "_lib", None)
    monkeypatch.setattr(videodec, "_error", None)
    return builds


def force_opencv(monkeypatch, where):
    """Neither package's native decoder loads (the port's fails to build,
    the JAX package's to load), as on a machine without FFmpeg's development
    files: both read containers through OpenCV."""
    from trace_tpu.native import videodec as jvd

    def unavailable():
        raise jvd.NativeDecoderUnavailable("native decoder build failed (made to fail)")

    monkeypatch.setattr(jvd, "_load", unavailable)
    break_native_decoder(monkeypatch, where)


@pytest.fixture
def no_decoder(tmp_path, monkeypatch):
    return break_native_decoder(monkeypatch, tmp_path)


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


def test_native_decoder_writes_only_its_frames(tmp_path, decoder):
    """A 40-pixel RGB24 row is 120 bytes, no multiple of swscale's vector
    stores, which run past a row's end: the decoder fills the caller's
    buffer with the frames it asked for and writes nothing past them."""
    import ctypes
    import os

    import cv2

    path = str(tmp_path / "narrow.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (40, 40))
    assert writer.isOpened()
    rng = np.random.default_rng(8)
    for _ in range(12):
        writer.write(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8))
    writer.release()
    idx = np.array([0, 5, 11], np.int64)
    nbytes = len(idx) * 40 * 40 * 3
    out = np.full(nbytes + 4096, 0xA5, np.uint8)
    rc = videodec.load().vd_read_frames(
        os.fsencode(path), idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), 40, 40)
    assert rc == 0
    assert (out[nbytes:] == 0xA5).all()
    frames = out[:nbytes].reshape(len(idx), 40, 40, 3)
    np.testing.assert_array_equal(frames, videodec.read_frames(path, idx))
    assert len({f.tobytes() for f in frames}) == len(idx)


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


@pytest.mark.parametrize("route", ["use_native=False", "decoder fails"])
@pytest.mark.parametrize("scheme, max_side", [("uniform", None), ("fps", None),
                                              ("uniform", 48)])
def test_mp4_through_opencv_matches_jax(mp4, tmp_path, monkeypatch, route, scheme, max_side):
    """The OpenCV route: frames and timestamps equal to the JAX package's
    OpenCV reading of the same file, at the source's size whatever
    ``max_side`` asks (OpenCV ignores it there too); ``probe`` equal to JAX's;
    each read counted on the OpenCV route."""
    kw = {"use_native": False} if route == "use_native=False" else {}
    if route == "decoder fails":
        break_native_decoder(monkeypatch, tmp_path)
    before = dict(tio.CONTAINER_READS)
    got = tio.load_video_frames(mp4, 8, scheme, max_side=max_side, **kw)
    want = jio.load_video_frames(mp4, 8, scheme, use_native=False, max_side=max_side)
    _assert_same(got, want)
    assert got[0].shape[1:] == (64, 96, 3)
    assert len({f.tobytes() for f in got[0]}) == len(got[0])
    assert tio.probe(mp4) == jio.probe(mp4) == (40, 25.0)
    idx = np.array([39, 3, 3, 17])
    np.testing.assert_array_equal(tio.read_frames_at(mp4, idx, **kw),
                                  jio.read_frames_at(mp4, idx, use_native=False))
    assert tio.CONTAINER_READS == {**before, "opencv": before["opencv"] + 2}


def test_probe_media_through_opencv_matches_jax(tmp_path, mp4, no_decoder):
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
    for mod, kw in ((tio, {}), (jio, {"use_native": False})):
        with pytest.raises(IOError, match="cannot open video"):
            mod.load_video_frames(str(tmp_path / "bad.mp4"), 4, **kw)


def test_containers_need_the_native_decoder(tmp_path, mp4, no_decoder):
    """Where the decoder cannot build, containers read through OpenCV, equal
    to the JAX package's OpenCV reading; ``container_reader`` names that
    route with the build's reason, the build is tried once, and a junk
    container raises OpenCV's error."""
    assert tio.container_reader().startswith(
        "opencv (native decoder unavailable: native decoder build failed")
    (tmp_path / "v.mp4").write_bytes(b"\0" * 64)
    for _ in range(2):  # the failure is kept: no second build
        _assert_same(tio.load_video_frames(mp4, 4),
                     jio.load_video_frames(mp4, 4, use_native=False))
        with pytest.raises(IOError, match="cannot open video"):
            tio.load_video_frames(str(tmp_path / "v.mp4"), 4)
    assert len(no_decoder) == 1
    np.save(tmp_path / "v.npy", np.ones((3, 4, 4, 3), np.uint8))
    assert tio.load_video_frames(str(tmp_path / "v.npy"), 3)[0].shape == (3, 4, 4, 3)


def test_a_failed_decoder_keeps_no_caller_alive(mp4, no_decoder):
    """Where the decoder cannot build, each read that tries it and goes on
    through OpenCV lets its callers' frames go: the kept build failure holds
    no traceback into them (it held every caller's locals, the pipeline and
    its card memory among them)."""
    import gc
    import weakref

    class Held:
        pass

    def read():
        held = Held()
        tio.load_video_frames(mp4, 4)
        tio.probe(mp4)
        return weakref.ref(held)

    refs = [read() for _ in range(3)]
    gc.collect()
    assert [r() for r in refs] == [None] * 3 and len(no_decoder) == 1


def test_container_reader_names_the_native_route(decoder, mp4):
    before = tio.CONTAINER_READS["native"]
    tio.read_frames_at(mp4, np.array([0, 5]))
    assert tio.container_reader() == "native"
    assert tio.CONTAINER_READS["native"] == before + 1


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
