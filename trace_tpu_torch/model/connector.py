"""Vision -> LM connectors (trace_tpu/model/connector.py): the projector
registry of the reference (multimodal_projector/builder.py), its init
layouts and forwards.

  spatial_slot       per-frame slot-attention pooling of the CLIP patch
                     tokens to ``num_slots`` tokens a frame (the released
                     checkpoints' connector): [B, T, N, D_mm] -> [B, T, S, D_lm]
  slot               global slot pooling over all T*N tokens, RoPE at the
                     frame index: -> [B, S, D_lm]
  linear, mlpNx_gelu mean over frames, then a Linear / an MLP with exact GELU
                     between its layers: -> [B, N, D_lm]
  identity           the features as they are
  spatial_time_slot  separate slot banks for the image and time parts of a
                     frame's tokens: -> [B, T, S + St, D_lm]
  stc_connector, stp_connector, stc_connector_v35, spatial_conv, spatial_pool
                     the conv family of model/stc_connector.py: -> [B, T', D_lm]

A per-frame output ([B, T, S, D]) is interleaved with each frame's time
tokens by ``trace_model.encode_video``; a global one ([B, S, D]) is written
into the video span as it is.

Every connector is plain PyTorch (small products and convolutions that the
JAX package leaves to XLA; no Pallas kernel). Init functions take an
``_Init`` of params.py (``normal(shape, scale)``, ``ones``, ``zeros``): the
JAX package's layouts and scales, from another generator.
"""

from __future__ import annotations

import re
from typing import Callable

import torch
import torch.nn.functional as F

from trace_tpu_torch.model import stc_connector
from trace_tpu_torch.model.mistral import rope_cos_sin, rotate_half
from trace_tpu_torch.model.vit import layer_norm

LN_EPS = 1e-5  # torch nn.LayerNorm default, used by ln_vision


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def init_spatial_slot_params(r, mm_hidden: int, lm_hidden: int, num_slots: int = 8) -> dict:
    return {
        "slots": r.normal((mm_hidden, num_slots), scale=1.0),
        "ln_scale": r.ones((mm_hidden,)),
        "ln_bias": r.zeros((mm_hidden,)),
        "readout": r.normal((mm_hidden, lm_hidden)),
    }


def init_linear_params(r, mm_hidden: int, lm_hidden: int) -> dict:
    return {"weight": r.normal((mm_hidden, lm_hidden)), "bias": r.zeros((lm_hidden,))}


def init_mlp_params(r, mm_hidden: int, lm_hidden: int, depth: int) -> dict:
    return {"layers": [init_linear_params(r, mm_hidden if i == 0 else lm_hidden, lm_hidden)
                       for i in range(depth)]}


def init_spatial_time_slot_params(r, mm_hidden: int, lm_hidden: int,
                                  num_spatial_slots: int = 8,
                                  num_time_slots: int = 1) -> dict:
    return {
        "spatial_slots": r.normal((mm_hidden, num_spatial_slots), scale=1.0),
        "time_slots": r.normal((mm_hidden, num_time_slots), scale=1.0),
        "ln_scale": r.ones((mm_hidden,)),
        "ln_bias": r.zeros((mm_hidden,)),
        "readout": r.normal((mm_hidden, lm_hidden)),
    }


# ---------------------------------------------------------------------------
# Forward functions
# ---------------------------------------------------------------------------

def _slot_pool(x: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Softmax-over-positions slot pooling: x [..., n, d], slots [d, s] ->
    [..., s, d]. Logits in fp32, softmax over the POSITION axis."""
    logits = x.float() @ slots.float()
    probs = torch.softmax(logits, dim=-2).to(x.dtype)
    return (probs.transpose(-1, -2) @ x).to(x.dtype)


def _rope_over_positions(x: torch.Tensor, n: int, base: float = 10000.0) -> torch.Tensor:
    """Rotary embedding over position ids 0..n-1, applied to the token
    features themselves (dim = the feature width, 1024 for CLIP-L)."""
    positions = torch.arange(max(n, 0), dtype=torch.int32, device=x.device)
    cos, sin = rope_cos_sin(positions, x.shape[-1], base)  # [n, d]
    return x * cos.to(x.dtype) + rotate_half(x) * sin.to(x.dtype)


def _readout(x: torch.Tensor, weight: torch.Tensor, bias=None, dtype=None) -> torch.Tensor:
    """x @ weight (+ bias) with an fp32 sum, cast to ``dtype`` (x's)."""
    y = x.float() @ weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype or x.dtype)


def spatial_slot_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Per-frame slot pooling: [B, T, N, D_mm] -> [B, T, S, D_lm].
    LayerNorm -> RoPE over the N patch positions -> slot pool -> linear
    readout (no bias)."""
    N = x.shape[2]
    h = layer_norm(x, params["ln_scale"], params["ln_bias"], LN_EPS)
    h = _rope_over_positions(h, N)
    pooled = _slot_pool(h, params["slots"])  # [B, T, S, D]
    return (pooled @ params["readout"].to(pooled.dtype)).to(x.dtype)


def slot_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Global slot pooling over all T*N tokens: [B, T, N, D_mm] ->
    [B, S, D_lm], RoPE at the FRAME index repeated per patch (reference
    SlotPool)."""
    B, T, N, D = x.shape
    h = layer_norm(x.reshape(B, T * N, D), params["ln_scale"], params["ln_bias"], LN_EPS)
    positions = torch.arange(T, dtype=torch.int32, device=x.device).repeat_interleave(N)
    cos, sin = rope_cos_sin(positions, D, 10000.0)
    h = h * cos.to(h.dtype) + rotate_half(h) * sin.to(h.dtype)
    pooled = _slot_pool(h, params["slots"])
    return _readout(pooled, params["readout"], dtype=x.dtype)


def _frame_mean(x: torch.Tensor) -> torch.Tensor:
    return x.float().mean(dim=1).to(x.dtype)  # [B, N, D]


def linear_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Mean over frames, then the Linear: [B, T, N, D_mm] -> [B, N, D_lm]."""
    return _readout(_frame_mean(x), params["weight"], params["bias"])


def mlp_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Mean over frames, then the MLP with exact GELU between its layers."""
    h = _frame_mean(x)
    for i, layer in enumerate(params["layers"]):
        if i:
            h = F.gelu(h)
        h = _readout(h, layer["weight"], layer["bias"], dtype=x.dtype)
    return h


def identity_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x


def spatial_time_slot_forward(params: dict, x: torch.Tensor,
                              image_dim: int = 576) -> torch.Tensor:
    """Split image / time token pools (reference SpatialTimeSlotPool): the
    first ``image_dim`` tokens of a frame LayerNorm + RoPE + slot pool
    through the readout; the rest RoPE + slot pool unnormed, read out only
    where its width is not the output's. [B, T, N, D_mm] ->
    [B, T, S + St, D_lm]."""
    N = x.shape[2]
    img, tim = x[:, :, :image_dim], x[:, :, image_dim:]
    h = layer_norm(img, params["ln_scale"], params["ln_bias"], LN_EPS)
    h = _rope_over_positions(h, image_dim)
    img_out = _readout(_slot_pool(h, params["spatial_slots"]), params["readout"],
                       dtype=x.dtype)
    tim_out = _slot_pool(_rope_over_positions(tim, N - image_dim), params["time_slots"])
    if tim_out.shape[-1] != img_out.shape[-1]:
        tim_out = _readout(tim_out, params["readout"], dtype=x.dtype)
    return torch.cat([img_out, tim_out], dim=2)


def build_connector(projector_type: str) -> tuple[Callable, Callable]:
    """(init_fn(r, mm_hidden, lm_hidden, num_slots=8), forward_fn(params, x))
    of a projector type; ``num_slots`` is read by the slot connectors only."""
    mlp_match = re.match(r"^mlp(\d+)x_gelu$", projector_type)
    if mlp_match:
        depth = int(mlp_match.group(1))
        return (lambda r, mm, lm, num_slots=8: init_mlp_params(r, mm, lm, depth),
                mlp_forward)
    if projector_type == "linear":
        return lambda r, mm, lm, num_slots=8: init_linear_params(r, mm, lm), linear_forward
    if projector_type == "spatial_slot":
        return init_spatial_slot_params, spatial_slot_forward
    if projector_type == "slot":
        return init_spatial_slot_params, slot_forward
    if projector_type == "spatial_time_slot":
        return (lambda r, mm, lm, num_slots=8: init_spatial_time_slot_params(
            r, mm, lm, num_spatial_slots=num_slots), spatial_time_slot_forward)
    if projector_type == "identity":
        return lambda r, mm, lm, num_slots=8: {}, identity_forward
    if projector_type in stc_connector.SPECS:
        return stc_connector.build(projector_type)
    raise ValueError(f"Unknown projector type: {projector_type}")
