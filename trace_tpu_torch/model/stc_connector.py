"""The STC / STP connector family (trace_tpu/model/stc_connector.py):
convolutional spatio-temporal downsampling projectors of the reference
(multimodal_projector/builder.py): timm RegNet stages around a 3-D conv (or
average-pool) downsampler, then an MLP readout.

  stc_connector      s1 (depth 4) -> Conv3d k = s = (2, 2, 2), pad 1 -> s2 -> mlp
  stp_connector      s1          -> AvgPool3d (2, 2, 2)             -> s2 -> mlp
  stc_connector_v35  s1          -> Conv3d k = s = (2, 2, 2), pad 0 -> s2 -> mlp
  spatial_conv       depth 0     -> Conv3d k = s = (1, 2, 2), pad 1       -> mlp
  spatial_pool       depth 0     -> AvgPool3d (1, 2, 2)                   -> mlp

A RegNet stage is ``timm.models.regnet.RegStage`` at the reference's call
(stride 1, SiLU, LayerNorm2d), block by block a Bottleneck(bottle_ratio=1,
group_size=1, se_ratio=0.25): a 1x1 conv + LayerNorm2d + SiLU, a depthwise
3x3 conv + LayerNorm2d + SiLU, squeeze-excitation (mean, 1x1 conv, SiLU, 1x1
conv, sigmoid gate), a 1x1 conv + LayerNorm2d, the shortcut (1x1 conv +
LayerNorm2d where the width changes, block 1), then SiLU. Parameters keep the
JAX package's layout (conv weights OIHW / OIDHW, the MLP's [in, out]).

The convolutions are ``torch.nn.functional.conv2d`` / ``conv3d``: the JAX
package computes them in XLA, not in a Pallas kernel. Output: the global
layout [B, T' * H' * W', D_lm], written into the video span as it is.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

from trace_tpu_torch.model.vit import layer_norm

LN_EPS = 1e-6  # timm LayerNorm2d default eps
SE_RATIO = 0.25


@dataclasses.dataclass(frozen=True)
class STCSpec:
    downsample: tuple = (2, 2, 2)  # (t, h, w)
    depth: int = 4
    mlp_depth: int = 2
    sampler: str = "conv"  # 'conv' | 'pool'
    sampler_padding: int = 1


SPECS = {
    "stc_connector": STCSpec(),
    "stp_connector": STCSpec(sampler="pool"),
    "stc_connector_v35": STCSpec(sampler_padding=0),
    "spatial_conv": STCSpec(downsample=(1, 2, 2), depth=0),
    "spatial_pool": STCSpec(downsample=(1, 2, 2), depth=0, sampler="pool"),
}


def _conv_init(r, shape):
    return r.normal(shape, scale=math.prod(shape[1:]) ** -0.5)


def _init_bottleneck(r, in_ch: int, out_ch: int) -> dict:
    """A timm RegNet Bottleneck's params (bottle_ratio 1, group_size 1)."""
    rd = int(round(in_ch * SE_RATIO))
    p = {
        "conv1": _conv_init(r, (out_ch, in_ch, 1, 1)),
        "ln1_scale": r.ones((out_ch,)),
        "ln1_bias": r.zeros((out_ch,)),
        # group_size 1: groups = out_ch, a depthwise 3x3 of weight [out, 1, 3, 3]
        "conv2": _conv_init(r, (out_ch, 1, 3, 3)),
        "ln2_scale": r.ones((out_ch,)),
        "ln2_bias": r.zeros((out_ch,)),
        "se_fc1_w": _conv_init(r, (rd, out_ch, 1, 1)),
        "se_fc1_b": r.zeros((rd,)),
        "se_fc2_w": _conv_init(r, (out_ch, rd, 1, 1)),
        "se_fc2_b": r.zeros((out_ch,)),
        "conv3": _conv_init(r, (out_ch, out_ch, 1, 1)),
        "ln3_scale": r.ones((out_ch,)),
        "ln3_bias": r.zeros((out_ch,)),
    }
    if in_ch != out_ch:
        p["down_conv"] = _conv_init(r, (out_ch, in_ch, 1, 1))
        p["down_ln_scale"] = r.ones((out_ch,))
        p["down_ln_bias"] = r.zeros((out_ch,))
    return p


def init_stc_params(r, mm_hidden: int, lm_hidden: int, spec: STCSpec) -> dict:
    params: dict = {"s1": [], "s2": []}
    in_ch = mm_hidden
    for _ in range(spec.depth):
        params["s1"].append(_init_bottleneck(r, in_ch, lm_hidden))
        in_ch = lm_hidden
    mid_ch = lm_hidden if spec.depth else mm_hidden
    if spec.sampler == "conv":
        params["sampler_w"] = _conv_init(r, (mid_ch, mid_ch) + tuple(spec.downsample))
        params["sampler_b"] = r.zeros((mid_ch,))
    for _ in range(spec.depth):
        params["s2"].append(_init_bottleneck(r, mid_ch, lm_hidden))
        mid_ch = lm_hidden
    params["mlp"] = [{"weight": r.normal((mid_ch if i == 0 else lm_hidden, lm_hidden)),
                      "bias": r.zeros((lm_hidden,))} for i in range(spec.mlp_depth)]
    return params


def _ln2d(x, scale, bias):
    """timm LayerNorm2d: normalise the channel axis of NCHW."""
    return layer_norm(x.permute(0, 2, 3, 1), scale, bias, LN_EPS).permute(0, 3, 1, 2)


def _conv2d(x, w, groups: int = 1):
    """A stride-1 'SAME' convolution (1x1 or 3x3), NCHW / OIHW."""
    return F.conv2d(x, w.to(x.dtype), padding=w.shape[-1] // 2, groups=groups)


def _bottleneck(x, p):
    """A timm RegNet Bottleneck (see the module docstring), [N, C, H, W]."""
    shortcut = x
    h = F.silu(_ln2d(_conv2d(x, p["conv1"]), p["ln1_scale"], p["ln1_bias"]))
    h = F.silu(_ln2d(_conv2d(h, p["conv2"], groups=h.shape[1]), p["ln2_scale"],
                     p["ln2_bias"]))
    se = h.mean(dim=(2, 3), keepdim=True)
    se = F.silu(_conv2d(se, p["se_fc1_w"]) + p["se_fc1_b"].to(h.dtype)[None, :, None, None])
    se = _conv2d(se, p["se_fc2_w"]) + p["se_fc2_b"].to(h.dtype)[None, :, None, None]
    h = h * torch.sigmoid(se)
    h = _ln2d(_conv2d(h, p["conv3"]), p["ln3_scale"], p["ln3_bias"])
    if "down_conv" in p:
        shortcut = _ln2d(_conv2d(shortcut, p["down_conv"]), p["down_ln_scale"],
                         p["down_ln_bias"])
    return F.silu(h + shortcut)


def stc_forward(params: dict, x: torch.Tensor, spec: STCSpec) -> torch.Tensor:
    """x [B, T, N, D_mm] (N = hw x hw patches) -> [B, T' * H' * W', D_lm]:
    stage 1 per frame, the 3-D downsampler over (t, h, w), stage 2 per
    frame, the MLP readout (reference STCConnector.forward)."""
    B, T, N, D = x.shape
    hw = int(round(N ** 0.5))
    h = x.reshape(B, T, hw, hw, D).permute(0, 1, 4, 2, 3).reshape(B * T, D, hw, hw)
    for blk in params["s1"]:
        h = _bottleneck(h, blk)
    C = h.shape[1]
    h = h.reshape(B, T, C, h.shape[2], h.shape[3]).transpose(1, 2)  # [B, C, T, h, w]

    kernel = tuple(spec.downsample)
    if spec.sampler == "conv":
        h = F.conv3d(h, params["sampler_w"].to(h.dtype), stride=kernel,
                     padding=spec.sampler_padding)
        h = F.silu(h + params["sampler_b"].to(h.dtype)[None, :, None, None, None])
    else:
        h = F.silu(F.avg_pool3d(h, kernel, stride=kernel))

    _, C2, T2, H2, W2 = h.shape
    h = h.transpose(1, 2).reshape(B * T2, C2, H2, W2)
    for blk in params["s2"]:
        h = _bottleneck(h, blk)
    C3 = h.shape[1]
    h = h.reshape(B, T2, C3, H2 * W2).transpose(2, 3).reshape(B, T2 * H2 * W2, C3)
    for i, layer in enumerate(params["mlp"]):
        if i:
            h = F.gelu(h)
        h = (h.float() @ layer["weight"].float() + layer["bias"].float()).to(x.dtype)
    return h


def build(projector_type: str) -> tuple[Callable, Callable]:
    """(init_fn(r, mm_hidden, lm_hidden, num_slots=8), forward_fn(params, x))
    of one STC-family type (``num_slots`` is not read)."""
    spec = SPECS[projector_type]
    return (lambda r, mm, lm, num_slots=8: init_stc_params(r, mm, lm, spec),
            lambda params, x: stc_forward(params, x, spec))
