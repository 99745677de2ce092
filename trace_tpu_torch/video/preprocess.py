"""Frame preprocessing: the host side in numpy and the device side in torch
(trace_tpu/video/preprocess.py).

Host (numpy, no device): pad-to-square and the bicubic downscale of frames
larger than the ViT input (``host_downscale``, ``host_downscale_band``),
the content band of a pad-squared frame (``content_band``), and the I420
wire format (``rgb_to_i420_np``, ``i420_fill_rgb01``). The JAX package
runs these through OpenCV (``cv2.resize`` with ``INTER_CUBIC``, whose x86
build computes it through Intel IPP, and ``cvtColor`` ``RGB2YUV_I420``); the
port computes the same bytes with numpy alone:

* I420 is integer arithmetic: Y from every pixel, U and V from the top-left
  pixel of each 2x2 block, each a sum of 20-bit fixed-point products rounded
  once (``_I420_*``).
* The bicubic resize is separable in fp32 (``_cubic_table``, ``_hpass``,
  ``_vpass``): the A = -0.75 kernel evaluated in fp64 on fp32 tap distances
  and rounded to fp32, border taps clamped, the row pass first (four fused
  multiply-adds in tap order), then the column pass (two fused pairs,
  added), rounded half to even. Each fused multiply-add is rounded once, as
  the hardware's is (``_fma32``).

Device (torch, on the tensor's device): the I420 planes back to RGB, the
content band on a canvas of the fill colour, CLIP normalisation, and the
planar patch extraction that feeds the ViT's pre-extracted-patch input
(``i420_band_to_patches``). ``preprocess_frames`` is the rgb upload's
device preprocess: its resize reproduces ``jax.image.resize(method=
"bicubic", antialias=True)``: a separable product with one weight matrix
per spatial axis, computed as JAX's ``compute_weight_mat`` computes them
(Keys cubic kernel with a = -0.5, the kernel widened by the downscale
factor, columns normalised, samples outside the input zeroed).
``torch.nn.functional.interpolate`` uses a = -0.75 and no such widening, so
it gives other pixels.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from trace_tpu_torch.model.vit import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys (1981) cubic convolution kernel, a = -0.5, on |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def resize_weights(input_size: int, output_size: int, device=None) -> torch.Tensor:
    """[input_size, output_size] fp32 weights of an antialiased bicubic
    resize along one axis (scale = output/input, no translation)."""
    f32 = torch.float32
    inv_scale = 1.0 / (output_size / input_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(output_size, dtype=f32, device=device) + 0.5) \
        * inv_scale - 0.0 * inv_scale - 0.5
    x = (sample_f[None, :]
         - torch.arange(input_size, dtype=f32, device=device)[:, None]).abs() \
        / kernel_scale
    weights = _keys_cubic(x)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    weights = torch.where(
        total.abs() > eps,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights),
    )
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def preprocess_frames(
    frames: torch.Tensor,  # [T, H, W, 3] uint8 or float in [0, 255]
    image_size: int = 336,
    *,
    aspect_ratio: str = "pad",
    normalize: bool = True,
) -> torch.Tensor:
    """uint8 frames -> CLIP-ready [T, S, S, 3] float32 on the frames' device.

    'pad' centers the frame on a square mean-color canvas before the resize;
    otherwise the frame is resized directly."""
    T, H, W, C = frames.shape
    dev = frames.device
    x = frames.float() / 255.0
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=torch.float32, device=dev)

    if aspect_ratio == "pad" and H != W:
        side = max(H, W)
        canvas = mean.expand(T, side, side, C).clone()
        top, left = (side - H) // 2, (side - W) // 2
        canvas[:, top:top + H, left:left + W] = x
        x = canvas

    if x.shape[1] != image_size or x.shape[2] != image_size:
        if x.shape[1] != image_size:
            wh = resize_weights(x.shape[1], image_size, dev)
            x = torch.einsum("thwc,hk->tkwc", x, wh)
        if x.shape[2] != image_size:
            ww = resize_weights(x.shape[2], image_size, dev)
            x = torch.einsum("thwc,wk->thkc", x, ww)
        x = x.clamp(0.0, 1.0)

    if normalize:
        x = (x - mean) / std
    return x


# ---------------------------------------------------------------------------
# Host side: numpy only, no device
# ---------------------------------------------------------------------------

# a frame chunk of the host resize holds about this many fp32 row-pass outputs
_RESIZE_CHUNK_ELEMS = 1 << 19


def _fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """fp32 a * b + c rounded once (a, b, c hold fp32 values in any float
    type). The fp64 product of two fp32 values is exact; the fp64 sum is
    rounded, and where it lands on the midpoint of two fp32 values (its 29
    bits below fp32 precision are 1 and 28 zeros) while the exact sum does
    not, the fp32 result follows the sign of the fp64 sum's error."""
    p = np.multiply(a, b, dtype=np.float64)
    s = p + c
    r = s.astype(np.float32)
    tie = np.flatnonzero((s.view(np.uint64) & 0x1FFFFFFF) == 0x10000000)
    if tie.size:
        st, pt = s.ravel()[tie], p.ravel()[tie]
        ct = np.broadcast_to(c, s.shape)[np.unravel_index(tie, s.shape)].astype(np.float64)
        t = st - pt
        err = (pt - (st - t)) + (ct - t)  # p + c == s + err exactly
        rt = r.ravel()[tie]
        up = np.nextafter(rt, np.float32(np.inf))
        dn = np.nextafter(rt, np.float32(-np.inf))
        fixed = np.where(err > 0, np.where(rt > st, rt, up),
                         np.where(err < 0, np.where(rt < st, rt, dn), rt))
        r.ravel()[tie] = fixed
    return r


def _cubic_kernel(t: np.ndarray, outer: bool) -> np.ndarray:
    """The A = -0.75 cubic on tap distances t, in fp64: |t| < 1 inner,
    1 <= |t| < 2 outer."""
    if outer:
        return ((-0.75 * t + 3.75) * t - 6.0) * t + 3.0
    return (1.25 * t - 2.25) * t * t + 1.0


def _cubic_table(n_in: int, n_out: int):
    """Source taps [n_out, 4] (clamped to the border) and fp32 weights
    [n_out, 4] of a bicubic resize of one axis from n_in to n_out samples.
    Output d samples at (d + 0.5) n_in / n_out - 0.5 (fp64); its fractional
    part x is rounded to fp32, the tap distances 1 + x, (1 + x) - 1, 2 - x,
    (2 - x) - 1 are taken in fp32, and the kernel at each in fp64, rounded
    to fp32."""
    pos = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    s = np.floor(pos)
    x = (pos - s).astype(np.float32)
    t0 = x + np.float32(1)
    t3 = np.float32(2) - x
    dist = (t0, t0 - np.float32(1), t3 - np.float32(1), t3)
    w = np.stack([_cubic_kernel(t.astype(np.float64), outer=k in (0, 3))
                  for k, t in enumerate(dist)], -1).astype(np.float32)
    idx = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3), 0, n_in - 1)
    return idx, w


def _hpass(x: np.ndarray, idx: np.ndarray, w: np.ndarray) -> np.ndarray:
    """[T, h, n, C] fp32 -> [T, h, m, C]: each output the four taps' products
    added in tap order, every addition fused with its product."""
    cols = lambda k: np.take(x, idx[:, k], axis=2)
    wk = lambda k: w[:, k][:, None]
    out = (cols(0) * wk(0)).astype(np.float32)
    for k in (1, 2, 3):
        out = _fma32(cols(k), wk(k), out)
    return out


def _vpass(x: np.ndarray, idx: np.ndarray, w: np.ndarray) -> np.ndarray:
    """[T, n, w, C] fp32 -> [T, m, w, C]: taps (1, 0) and (3, 2) each a
    product fused into the other's product, the two then added."""
    rows = lambda k: np.take(x, idx[:, k], axis=1)
    wk = lambda k: w[:, k][:, None, None]
    a = _fma32(rows(0), wk(0), rows(1) * wk(1))
    b = _fma32(rows(2), wk(2), rows(3) * wk(3))
    return a + b


def resize_cubic_u8(frames: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bicubic resize of uint8 frames [T, H, W, C] to [T, out_h, out_w, C],
    the bytes of OpenCV's ``INTER_CUBIC`` on x86 (see the module docstring).
    Chunks of frames run on a pool of threads (numpy releases the GIL in
    its loops), as OpenCV's resize runs on its own."""
    T, H, W, C = frames.shape
    hidx, hw = _cubic_table(W, out_w)
    vidx, vw = _cubic_table(H, out_h)
    out = np.empty((T, out_h, out_w, C), np.uint8)
    step = max(1, _RESIZE_CHUNK_ELEMS // (H * out_w * C))

    def chunk(t0: int) -> None:
        x = frames[t0:t0 + step].astype(np.float32)
        y = _vpass(_hpass(x, hidx, hw), vidx, vw)
        out[t0:t0 + step] = np.clip(np.rint(y), 0, 255)

    starts = range(0, T, step)
    if len(starts) == 1:
        chunk(0)
    else:
        with ThreadPoolExecutor(min(len(starts), os.cpu_count() or 1)) as pool:
            list(pool.map(chunk, starts))
    return out


def pad_to_square_np(frames: np.ndarray, fill: np.ndarray) -> np.ndarray:
    """Center [T, H, W, C] frames on a square canvas filled with ``fill``
    (expand2square)."""
    T, H, W, C = frames.shape
    if H == W:
        return frames
    side = max(H, W)
    canvas = np.empty((T, side, side, C), frames.dtype)
    canvas[:] = fill
    top, left = (side - H) // 2, (side - W) // 2
    canvas[:, top:top + H, left:left + W] = frames
    return canvas


def pad_fill_u8() -> np.ndarray:
    """The pad colour: the CLIP mean in uint8, truncated."""
    return (np.asarray(CLIP_IMAGE_MEAN) * 255).astype(np.uint8)


def host_downscale(frames: np.ndarray, image_size: int = 336,
                   aspect_ratio: str = "pad") -> np.ndarray:
    """Host pad-square + bicubic resize to [T, S, S, 3] uint8."""
    T, H, W, C = frames.shape
    if aspect_ratio == "pad" and H != W:
        frames = pad_to_square_np(frames, pad_fill_u8())
    return resize_cubic_u8(frames, image_size, image_size)


def host_downscale_band(frames: np.ndarray, image_size: int = 336):
    """Pad-square + bicubic resize computing only the content band.

    Returns (band_u8 [T, h, w, 3], top, left) with (top, h, left, w) =
    ``content_band(H, W, S)``, equal to
    ``host_downscale(frames, S)[:, top:top+h, left:left+w]`` without the
    padded canvas or the full output: the band's input rows start on a row
    aligned to the output grid (``bi * S % side == 0``), so the sampling
    phases inside it are the full canvas's, and every returned row's support
    lies inside it. Returns None for portrait and square frames (callers
    use ``host_downscale``)."""
    T, H, W, C = frames.shape
    S = image_size
    if not H < W:
        return None
    side = W
    top_out, h, left_out, w = content_band(H, W, S)
    assert (left_out, w) == (0, S)
    pad0 = (side - H) // 2
    p = side // math.gcd(side, S)  # input rows per aligned output block
    # input rows whose bicubic support the output band rows [top, top+h) read
    c0 = math.floor((top_out + 0.5) * side / S - 0.5) - 1
    c1 = math.floor((top_out + h - 0.5) * side / S - 0.5) + 2
    bi = max(0, (c0 // p) * p)
    be = min(side, ((c1 + p) // p) * p)
    bh_in = be - bi
    bh_out = bh_in * S // side
    bo = bi * S // side
    assert bo <= top_out and bo + bh_out >= top_out + h, (bi, be, top_out, h)
    a0, a1 = max(bi, pad0), min(be, pad0 + H)  # content rows inside the band
    r0 = top_out - bo
    band_in = np.empty((T, bh_in, W, C), np.uint8)
    band_in[:, :a0 - bi] = pad_fill_u8()
    band_in[:, a1 - bi:] = pad_fill_u8()
    band_in[:, a0 - bi:a1 - bi] = frames[:, a0 - pad0:a1 - pad0]
    out = np.ascontiguousarray(resize_cubic_u8(band_in, bh_out, S)[:, r0:r0 + h])
    return out, top_out, 0


def content_band(H: int, W: int, S: int) -> tuple:
    """Rows/cols of the pad-squared + resized S x S frame that can differ
    from the uniform fill colour: the resized content plus the bicubic bleed
    into the first pad rows. Everything outside is exactly the fill colour
    (bicubic of a constant is that constant), so only the band needs to be
    uploaded; the device rebuilds the rest.

    Returns (top, h, left, w) aligned for I420 (even offsets, sizes % 4),
    the full frame when it is square."""
    side = max(H, W)
    scale = side / S  # input px per output px
    # the bicubic support radius is 2 input px; an output px whose support
    # lies inside the uniform pad equals the fill exactly
    margin = int(np.ceil(2.0 / scale)) + 2

    def band(extent_in: int, offset_in: int):
        lo = int(np.floor(offset_in / scale)) - margin
        hi = int(np.ceil((offset_in + extent_in) / scale)) + margin
        lo, hi = max(0, lo), min(S, hi)
        lo -= lo % 2                      # chroma-pair alignment
        n = hi - lo
        n += (-n) % 4                     # I420 plane packing wants % 4
        if lo + n > S:
            lo = S - n
        return lo, n

    if W > H:
        top, h = band(H, (side - H) // 2)
        return top, h, 0, S
    if H > W:
        left, w = band(W, (side - W) // 2)
        return 0, S, left, w
    return 0, S, 0, S


# BT.601 studio swing in 20-bit fixed point: Y of every pixel, U and V of the
# top-left pixel of each 2x2 block, each sum rounded once
_I420_Y = (269484, 528482, 102760, 16)
_I420_U = (-155188, -305135, 460324, 128)
_I420_V = (460324, -385875, -74448, 128)


def _i420_sum(r, g, b, coef) -> np.ndarray:
    cr, cg, cb, off = coef
    return ((cr * r + cg * g + cb * b + (1 << 19) + (off << 20)) >> 20).astype(np.uint8)


def rgb_to_i420_np(frames: np.ndarray) -> np.ndarray:
    """uint8 RGB [T, H, W, 3] -> planar I420 [T, H*3//2, W] uint8 (the
    bytes of OpenCV's ``COLOR_RGB2YUV_I420``): Y, then U and V each packed as
    H/4 rows of width W. Half the bytes of RGB: 4:2:0 chroma, the format
    H.264 sources are stored in."""
    T, H, W, _ = frames.shape
    out = np.empty((T, H * 3 // 2, W), np.uint8)
    rgb = [frames[..., k].astype(np.int32) for k in range(3)]
    out[:, :H] = _i420_sum(*rgb, _I420_Y)
    sub = [c[:, ::2, ::2] for c in rgb]
    out[:, H:H + H // 4] = _i420_sum(*sub, _I420_U).reshape(T, H // 4, W)
    out[:, H + H // 4:] = _i420_sum(*sub, _I420_V).reshape(T, H // 4, W)
    return out


def i420_fill_rgb01(fill: np.ndarray) -> np.ndarray:
    """The fill colour's RGB in [0, 1] after the I420 round trip: what pad
    pixels come out as on the full-frame yuv420 path. The device canvas of
    the band path uses it, so a band upload is bit-identical to uploading
    the whole squared frame."""
    patch = np.empty((1, 4, 4, 3), np.uint8)
    patch[:] = fill
    yuv = rgb_to_i420_np(patch)[0]  # [6, 4]: Y x 4 rows, U, V
    y, u, v = float(yuv[0, 0]), float(yuv[4, 0]) - 128.0, float(yuv[5, 0]) - 128.0
    yf = 1.164 * (y - 16.0)
    rgb = np.asarray(
        [yf + 1.596 * v, yf - 0.391 * u - 0.813 * v, yf + 2.018 * u], np.float32)
    return np.clip(rgb, 0.0, 255.0) / 255.0


# ---------------------------------------------------------------------------
# Device side: torch, on the tensor's device
# ---------------------------------------------------------------------------


def i420_to_planes(yuv: torch.Tensor) -> tuple:
    """Planar I420 [T, H*3//2, W] uint8 -> (r, g, b) fp32 planes [T, H, W]
    in [0, 255] (BT.601 studio swing, nearest-neighbour chroma). Kept
    planar: patches are cut from the planes without a channels-minor
    [H, W, 3] tensor."""
    T, H15, W = yuv.shape
    H = H15 * 2 // 3
    y = yuv[:, :H].float()
    u = yuv[:, H:H + H // 4].reshape(T, H // 2, W // 2)
    v = yuv[:, H + H // 4:].reshape(T, H // 2, W // 2)
    up = lambda c: c.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2).float() - 128.0
    u, v = up(u), up(v)
    yf = 1.164 * (y - 16.0)
    r = yf + 1.596 * v
    g = yf - 0.391 * u - 0.813 * v
    b = yf + 2.018 * u
    return tuple(c.clamp(0.0, 255.0) for c in (r, g, b))


def i420_to_rgb(yuv: torch.Tensor) -> torch.Tensor:
    """Planar I420 -> RGB fp32 [T, H, W, 3] in [0, 255]."""
    return torch.stack(i420_to_planes(yuv), dim=-1)


def _clip_norm(ci: int, device):
    f32 = torch.float32
    return (torch.tensor(CLIP_IMAGE_MEAN[ci], dtype=f32, device=device),
            torch.tensor(CLIP_IMAGE_STD[ci], dtype=f32, device=device))


def preprocess_yuv(yuv: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """I420 frames already at the ViT size -> CLIP-normalised RGB
    [T, S, S, 3] in ``out_dtype``."""
    dev = yuv.device
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=torch.float32, device=dev)
    return ((i420_to_rgb(yuv) / 255.0 - mean) / std).to(out_dtype)


def preprocess_yuv_band(yuv_band: torch.Tensor, top: int, left: int,
                        canvas_rgb01: torch.Tensor, size: int,
                        out_dtype=torch.float32) -> torch.Tensor:
    """Content-band I420 -> CLIP-normalised S x S RGB [T, S, S, 3]: the band
    converted and placed on a canvas of the fill colour's I420 round-trip
    value, equal to converting the whole squared frame."""
    dev = yuv_band.device
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=torch.float32, device=dev)
    band = ((i420_to_rgb(yuv_band) / 255.0 - mean) / std).to(out_dtype)
    T, h, w, _ = band.shape
    fill = ((canvas_rgb01.to(dev) - mean) / std).to(out_dtype)
    canvas = fill.expand(T, size, size, 3).clone()
    top, left = _clamp_start(top, h, size), _clamp_start(left, w, size)
    canvas[:, top:top + h, left:left + w] = band
    return canvas


def _clamp_start(start, extent: int, size: int) -> int:
    """A slice start as ``dynamic_update_slice`` takes it: clamped so that
    the update fits."""
    return max(0, min(int(start), size - extent))


def patchify_plane(x: torch.Tensor, patch: int) -> torch.Tensor:
    """[T, S, S] plane -> [T, n_patches, patch*patch] (row-major patch grid,
    as one channel's block of ``extract_patches``)."""
    T, H, W = x.shape
    gh, gw = H // patch, W // patch
    x = x.reshape(T, gh, patch, gw, patch).permute(0, 1, 3, 2, 4)
    return x.reshape(T, gh * gw, patch * patch)


def i420_band_to_patches(yuv_band: torch.Tensor, top: int, left: int,
                         canvas_rgb01: torch.Tensor, size: int, patch: int,
                         out_dtype=torch.float32) -> torch.Tensor:
    """Content-band I420 -> CLIP-normalised ViT patches [T, N, 3*p*p]
    (channel-major rows): ``preprocess_yuv_band`` followed by
    ``extract_patches``, element for element, with every intermediate a
    planar [T, S, S] tensor."""
    dev = yuv_band.device
    T = yuv_band.shape[0]
    out = []
    for ci, plane in enumerate(i420_to_planes(yuv_band)):
        mean, std = _clip_norm(ci, dev)
        band = ((plane / 255.0 - mean) / std).to(out_dtype)
        fill = ((canvas_rgb01[ci].to(dev) - mean) / std).to(out_dtype)
        canvas = fill.expand(T, size, size).clone()
        h, w = band.shape[1:]
        t, l = _clamp_start(top, h, size), _clamp_start(left, w, size)
        canvas[:, t:t + h, l:l + w] = band
        out.append(patchify_plane(canvas, patch))
    return torch.cat(out, dim=-1)
