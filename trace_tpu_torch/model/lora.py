"""LoRA adapters for the decoder (trace_tpu/model/lora.py), training-time.

Adapters live as extra leaves inside ``params['layers']`` (``<name>_lora_a``
[L, in, r], ``<name>_lora_b`` [L, r, out_flat]), stacked like the base
weights; a projection's delta is ``x @ A @ B * (alpha / r)``. The trainable
group is every name containing ``_lora_`` (plus towers and heads per the
stage recipe, train/train.py).
"""

from __future__ import annotations

import torch

from trace_tpu_torch.kernels.quant_matmul import matmul_f32
from trace_tpu_torch.model.config import DecoderConfig

# target -> (in_dim, out_flat) over the config
_TARGETS = {
    "wq": lambda c: (c.hidden_size, c.num_heads * c.head_dim),
    "wk": lambda c: (c.hidden_size, c.num_kv_heads * c.head_dim),
    "wv": lambda c: (c.hidden_size, c.num_kv_heads * c.head_dim),
    "wo": lambda c: (c.num_heads * c.head_dim, c.hidden_size),
    "w_gate": lambda c: (c.hidden_size, c.intermediate_size),
    "w_up": lambda c: (c.hidden_size, c.intermediate_size),
    "w_down": lambda c: (c.intermediate_size, c.hidden_size),
}


def add_lora_params(
    params: dict,
    config: DecoderConfig,
    generator: torch.Generator,
    targets: tuple = ("wq", "wk", "wv", "wo"),
    dtype=torch.float32,
) -> dict:
    """Return params with LoRA leaves added on the generator's device
    (A ~ N(0, 1) / r, B = 0: the adapted model starts identical to the base)."""
    if config.lora_r <= 0:
        raise ValueError("set config.lora_r")
    r, L = config.lora_r, config.num_layers
    dev = generator.device
    out = dict(params)
    layers = dict(params["layers"])
    for name in targets:
        d_in, d_out = _TARGETS[name](config)
        a = torch.randn((L, d_in, r), generator=generator, device=dev,
                        dtype=torch.float32) / r
        layers[f"{name}_lora_a"] = a.to(dtype)
        layers[f"{name}_lora_b"] = torch.zeros((L, r, d_out), dtype=dtype, device=dev)
    out["layers"] = layers
    return out


def lora_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               config: DecoderConfig, low=None) -> torch.Tensor:
    """x [..., in] through one layer's adapter (a [in, r], b [r, out_flat]):
    the delta [..., out_flat] in x's dtype, both products summed in fp32.
    ``low`` maps the rank-r product before the second one (a tensor-parallel
    rank's collective, model/mistral.py)."""
    scale = config.lora_alpha / config.lora_r
    u = matmul_f32(x.reshape(-1, x.shape[-1]), a)
    if low is not None:
        u = low(u)
    out = matmul_f32(u, b) * scale
    return out.to(x.dtype).reshape(x.shape[:-1] + (b.shape[-1],))


def merge_lora_into_base(params: dict, config: DecoderConfig) -> dict:
    """Fold the adapters into the base weights and drop the LoRA leaves (the
    final-save merge)."""
    layers = dict(params["layers"])
    scale = config.lora_alpha / config.lora_r
    for name in _TARGETS:
        a = layers.pop(f"{name}_lora_a", None)
        b = layers.pop(f"{name}_lora_b", None)
        if a is None:
            continue
        w = layers[name]
        delta = torch.einsum("ldr,lro->ldo", a.float(), b.float()) * scale
        layers[name] = (w.reshape(delta.shape).float() + delta).reshape(w.shape).to(w.dtype)
    out = dict(params)
    out["layers"] = layers
    return out
