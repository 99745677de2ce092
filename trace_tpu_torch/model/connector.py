"""The ``spatial_slot`` vision -> LM connector (trace_tpu/model/connector.py
``spatial_slot_forward``): per-frame slot-attention pooling of the 576 CLIP
patch tokens down to ``num_slots`` tokens per frame."""

from __future__ import annotations

import torch

from trace_tpu_torch.model.mistral import rope_cos_sin, rotate_half
from trace_tpu_torch.model.vit import layer_norm

LN_EPS = 1e-5  # torch nn.LayerNorm default, used by ln_vision


def _slot_pool(x: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Softmax-over-positions slot pooling: x [..., n, d], slots [d, s] ->
    [..., s, d]. Logits in fp32, softmax over the POSITION axis."""
    logits = x.float() @ slots.float()
    probs = torch.softmax(logits, dim=-2).to(x.dtype)
    return (probs.transpose(-1, -2) @ x).to(x.dtype)


def _rope_over_positions(x: torch.Tensor, n: int, base: float = 10000.0) -> torch.Tensor:
    """Rotary embedding over position ids 0..n-1, applied to the token
    features themselves (dim = the feature width, 1024 for CLIP-L)."""
    positions = torch.arange(n, dtype=torch.int32, device=x.device)
    cos, sin = rope_cos_sin(positions, x.shape[-1], base)  # [n, d]
    return x * cos.to(x.dtype) + rotate_half(x) * sin.to(x.dtype)


def spatial_slot_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Per-frame slot pooling: [B, T, N, D_mm] -> [B, T, S, D_lm].
    LayerNorm -> RoPE over the N patch positions -> slot pool -> linear
    readout (no bias)."""
    N = x.shape[2]
    h = layer_norm(x, params["ln_scale"], params["ln_bias"], LN_EPS)
    h = _rope_over_positions(h, N)
    pooled = _slot_pool(h, params["slots"])  # [B, T, S, D]
    return (pooled @ params["readout"].to(pooled.dtype)).to(x.dtype)
