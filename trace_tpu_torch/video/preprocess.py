"""Frame preprocessing on the device: pad-to-square, resize, CLIP
normalization (``preprocess_frames`` of trace_tpu/video/preprocess.py).

The resize reproduces ``jax.image.resize(method="bicubic", antialias=True)``:
a separable product with one weight matrix per spatial axis, computed as
JAX's ``compute_weight_mat`` computes them (Keys cubic kernel with
a = -0.5, the kernel widened by the downscale factor, columns normalised,
samples outside the input zeroed). ``torch.nn.functional.interpolate`` uses
a = -0.75 and no such widening, so it gives other pixels.
"""

from __future__ import annotations

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
