"""The port's yuv420 preprocessing against the JAX package's.

Host side (numpy): the JAX package runs OpenCV (``cv2.resize`` INTER_CUBIC,
``cvtColor`` RGB2YUV_I420); the port computes the same bytes without it, and
every case here is held bit for bit on random frames.

Device side (torch): the same elementwise operations in the same order as
the JAX programs, run on the CPU in fp32. XLA's CPU compiler fuses some of
them (a multiply into a following add, a division by a constant) where
PyTorch rounds each, so they differ by a few fp32 ulps: 2e-6 absolute on
values of at most ~2.2 (measured 1e-6). Rounded to bf16 such a difference
flips an element by one bf16 step where it lies on a rounding boundary: at
most one step (2^-7 of the value) and in at most 1e-3 of the elements
(measured 5e-5). Within the port, the patch route equals the pixel route bit
for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trace_tpu.model.config import TraceConfig as JTraceConfig
from trace_tpu.runtime import pipeline as jpipe
from trace_tpu.runtime.pipeline import TracePipeline as JaxPipeline
from trace_tpu.tokenizers.text import ByteTokenizer as JaxByteTokenizer
from trace_tpu.video import preprocess as jpre
from trace_tpu_torch.model.config import TraceConfig
from trace_tpu_torch.model.vit import extract_patches
from trace_tpu_torch.runtime.pipeline import PreparedSampleNP, TracePipeline
from trace_tpu_torch.tokenizers.text import ByteTokenizer
from trace_tpu_torch.video import preprocess as tpre

F32_TOL = 2e-6
S = 336


def _frames(seed, T, H, W):
    return np.random.default_rng(seed).integers(0, 256, (T, H, W, 3), dtype=np.uint8)


# (T, H, W): 640x360 (the band route), 480x640 portrait (falls back to the
# full resize), square, near-square landscape (the band is the whole
# canvas), and 90x100 (an upscale)
HOST_CASES = {
    "640x360_band": (3, 360, 640),
    "480x640_portrait": (2, 640, 480),
    "square": (2, 400, 400),
    "near_square_landscape": (2, 470, 480),
    "90x100_upscale": (2, 100, 90),
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_downscale_bit_identical(case):
    T, H, W = HOST_CASES[case]
    frames = _frames(sorted(HOST_CASES).index(case), T, H, W)
    want = jpre.host_downscale(frames, S)
    got = tpre.host_downscale(frames, S)
    assert got.dtype == np.uint8 and got.shape == want.shape == (T, S, S, 3)
    np.testing.assert_array_equal(got, want)
    jband, tband = jpre.host_downscale_band(frames, S), tpre.host_downscale_band(frames, S)
    if W > H:
        assert tband[1:] == jband[1:]
        np.testing.assert_array_equal(tband[0], jband[0])
        top, h, left, w = tpre.content_band(H, W, S)
        np.testing.assert_array_equal(tband[0], got[:, top:top + h, left:left + w])
        if case == "near_square_landscape":
            assert (h, w) == (S, S)
    else:
        assert tband is None and jband is None
    np.testing.assert_array_equal(tpre.rgb_to_i420_np(got), jpre.rgb_to_i420_np(want))


def test_resize_other_shapes_bit_identical():
    """Both axes up and down, odd sizes, a border-heavy 4x upscale."""
    import cv2

    rng = np.random.default_rng(5)
    for (H, W), (h, w) in [((48, 64), (30, 40)), ((37, 53), (64, 96)),
                           ((16, 12), (64, 48)), ((720, 1280), (189, 336))]:
        frames = rng.integers(0, 256, (2, H, W, 3), dtype=np.uint8)
        want = np.stack([cv2.resize(f, (w, h), interpolation=cv2.INTER_CUBIC) for f in frames])
        np.testing.assert_array_equal(tpre.resize_cubic_u8(frames, h, w), want)


def test_rgb_to_i420_bit_identical():
    rng = np.random.default_rng(1)
    for H, W in [(64, 96), (192, 336), (4, 4)]:
        frames = rng.integers(0, 256, (3, H, W, 3), dtype=np.uint8)
        np.testing.assert_array_equal(tpre.rgb_to_i420_np(frames), jpre.rgb_to_i420_np(frames))
    # every colour once (Y of each pixel; U and V of each block's top-left)
    colours = np.stack(np.meshgrid(*[np.arange(256)] * 3, indexing="ij"), -1)
    frames = colours.reshape(1, 4096, 4096, 3).astype(np.uint8)
    np.testing.assert_array_equal(tpre.rgb_to_i420_np(frames), jpre.rgb_to_i420_np(frames))


def test_content_band_geometry_matches_jax():
    for H, W in [(360, 640), (360, 480), (720, 1280), (1080, 1920), (480, 360),
                 (640, 480), (100, 100), (2, 10_000), (10_000, 2), (470, 480)]:
        for size in (56, 336):
            assert tpre.content_band(H, W, size) == jpre.content_band(H, W, size)


def test_i420_fill_rgb01_matches_jax():
    fill = (np.asarray(jpre.CLIP_IMAGE_MEAN) * 255).astype(np.uint8)
    np.testing.assert_array_equal(tpre.i420_fill_rgb01(tpre.pad_fill_u8()), jpre.i420_fill_rgb01(fill))
    for colour in ([0, 0, 0], [255, 255, 255], [10, 200, 30]):
        c = np.asarray(colour, np.uint8)
        want = jpre.i420_fill_rgb01(c)
        got = tpre.i420_fill_rgb01(c)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _band(seed=3, T=4, h=32, w=56):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (T, h * 3 // 2, w), np.uint8), \
        np.asarray([0.45, 0.43, 0.41], np.float32)


def _close_bf16(got, want):
    """At most one bf16 step apart, in at most 1e-3 of the elements."""
    diff = np.abs(got - want)
    assert (diff <= 2 ** -7 * np.abs(want) + F32_TOL).all()
    assert (diff != 0).mean() <= 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_band_to_patches_matches_jax(dtype):
    band, canvas = _band()
    size, patch, top = 56, 14, 12
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jpipe._preprocess_yuv_band_patches_jit(
        jnp.asarray(band), jnp.int32(top), jnp.int32(0), jnp.asarray(canvas), size, patch,
        out_dtype=jd).astype(jnp.float32))
    got = tpre.i420_band_to_patches(torch.from_numpy(band), top, 0, torch.from_numpy(canvas),
                                    size, patch, td)
    assert got.dtype == td and tuple(got.shape) == want.shape == (4, 16, 3 * 14 * 14)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    else:
        _close_bf16(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_pixel_routes_match_jax(dtype):
    band, canvas = _band(seed=4)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jpipe._preprocess_yuv_band_jit(
        jnp.asarray(band), jnp.int32(12), jnp.int32(0), jnp.asarray(canvas), 56,
        out_dtype=jd).astype(jnp.float32))
    got = tpre.preprocess_yuv_band(torch.from_numpy(band), 12, 0, torch.from_numpy(canvas),
                                   56, td).float().numpy()
    full = np.random.default_rng(6).integers(0, 256, (4, 84, 56), np.uint8)
    want_full = np.asarray(jpipe._preprocess_yuv_jit(jnp.asarray(full), out_dtype=jd)
                           .astype(jnp.float32))
    got_full = tpre.preprocess_yuv(torch.from_numpy(full), td).float().numpy()
    for g, w in ((got, want), (got_full, want_full)):
        assert g.shape == w.shape
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=0, atol=F32_TOL)
        else:
            _close_bf16(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_patches_equal_pixel_path_exactly(dtype):
    """The planar patch route is the pixel route plus extract_patches, bit
    for bit (a layout permutation only)."""
    band, canvas = _band(seed=7, T=3, h=32, w=48)
    args = (torch.from_numpy(band), 8, 0, torch.from_numpy(canvas), 48)
    pixels = tpre.preprocess_yuv_band(*args, dtype)
    got = tpre.i420_band_to_patches(*args, 8, dtype)
    torch.testing.assert_close(got, extract_patches(pixels, 8), rtol=0, atol=0)


def test_band_upload_equals_full_frame():
    """Uploading the band and rebuilding the canvas on the device gives the
    same pixels as uploading the whole squared frame."""
    rng = np.random.default_rng(2)
    size = 64
    for H, W in [(48, 64), (64, 40), (36, 64)]:
        base = rng.normal(size=(2, H // 4, W // 4, 3))
        frames = np.clip(255 * (base - base.min()) / (base.max() - base.min()), 0, 255)
        frames = np.repeat(np.repeat(frames.astype(np.uint8), 4, axis=1), 4, axis=2)
        squared = tpre.host_downscale(frames, size, "pad")
        full = tpre.preprocess_yuv(torch.from_numpy(tpre.rgb_to_i420_np(squared)))
        top, h, left, w = tpre.content_band(H, W, size)
        assert (h, w) != (size, size)
        band = np.ascontiguousarray(squared[:, top:top + h, left:left + w])
        got = tpre.preprocess_yuv_band(
            torch.from_numpy(tpre.rgb_to_i420_np(band)), top, left,
            torch.from_numpy(tpre.i420_fill_rgb01(tpre.pad_fill_u8())), size)
        torch.testing.assert_close(got, full, rtol=0, atol=1e-5)


def test_prepared_np_band_route_matches_jax():
    """prepare_sample_host_np on the band route: the same tags, bytes and
    placement as the JAX package's, no tensor anywhere in it; and the
    upload gives what the direct (deferred) route gives."""
    cfg = dataclasses.replace(TraceConfig.tiny(), upload_format="yuv420")
    jcfg = dataclasses.replace(JTraceConfig.tiny(), upload_format="yuv420")
    jp = JaxPipeline(params={}, config=jcfg, tokenizer=JaxByteTokenizer())
    tp = TracePipeline({}, cfg, ByteTokenizer(), device="cpu")
    T, size = cfg.num_frames, cfg.vision.image_size
    frames = np.repeat(np.repeat(
        _frames(3, T, (size * 3) // 8, (size * 4) // 8), 4, axis=1), 4, axis=2)  # 1.5 S x 2 S
    ts = [[float(i)] for i in range(T)]
    want = jp.prepare_sample_host_np(frames, ts, "q")
    got = tp.prepare_sample_host_np(frames, ts, "q")
    assert isinstance(got, PreparedSampleNP)
    leaves = [got.token_ids, got.time_ids, *got.frames_spec]
    assert not any(isinstance(x, torch.Tensor) for x in leaves)
    np.testing.assert_array_equal(got.token_ids, want.token_ids)
    assert got.video_pos == want.video_pos
    np.testing.assert_array_equal(got.time_ids, want.time_ids)
    assert got.frames_spec[0] == want.frames_spec[0] == "yuv_band_p"
    assert len(got.frames_spec) == len(want.frames_spec)
    for a, b in zip(got.frames_spec[1:], want.frames_spec[1:]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    direct = tp._prepare_sample_host(frames, ts, "q", defer_preprocess=True)
    up = tp._upload_prepared(got)
    np.testing.assert_array_equal(direct[0], up[0])
    assert direct[1] == up[1]
    np.testing.assert_array_equal(direct[3], up[3])
    assert direct[2][0] == up[2][0]
    for a, b in zip(direct[2][1:], up[2][1:]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_vit_takes_patches():
    """vit_forward on pre-extracted patches equals it on the images, and the
    JAX package's on the same patches (fp32, 1e-5)."""
    from trace_tpu.model import trace_model as jtm
    from trace_tpu.model import vit as jvit
    from trace_tpu_torch.model import vit as tvit
    from trace_tpu_torch.params import from_jax_params

    jcfg, cfg = JTraceConfig.tiny(), TraceConfig.tiny()
    jp = jtm.init_trace_params(jcfg, jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    size, patch = cfg.vision.image_size, cfg.vision.patch_size
    x = np.random.default_rng(0).standard_normal((2, size, size, 3)).astype(np.float32)
    patches = extract_patches(torch.from_numpy(x), patch)
    got = tvit.vit_forward(tp["vision"], cfg.vision, patches)
    torch.testing.assert_close(got, tvit.vit_forward(tp["vision"], cfg.vision, torch.from_numpy(x)),
                               rtol=0, atol=0)
    want = jvit.vit_forward(jp["vision"], jcfg.vision, jnp.asarray(patches.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_fused_multiply_add_rounds_once():
    """The resize's fused multiply-add is rounded once: where the fp64 sum
    lands on the midpoint of two fp32 values that the exact sum misses
    (here by 2^-60), the result is the exact sum's rounding, not the
    midpoint's (half to even)."""
    a = np.array([1 + 2.0 ** -18, 1 + 2.0 ** -18, 3.0], np.float32)
    b = np.array([2.0 ** -24 * (1 - 2.0 ** -18), 2.0 ** -24 * (1 + 2.0 ** -18), 0.25],
                 np.float32)
    c = np.array([1 + 2.0 ** -23, 1.0, 0.125], np.float32)
    got = tpre._fma32(a, b, c)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.array([1 + 2.0 ** -23, 1 + 2.0 ** -23, 0.875],
                                                np.float32))
    # the plain fp64 sum rounds the first onto the even neighbour
    assert (a.astype(np.float64) * b + c).astype(np.float32)[0] == np.float32(1 + 2.0 ** -22)
