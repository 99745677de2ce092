"""Weight bridge: the JAX package's parameter tree to the port's, and a
random init in the same layout.

Both sides use one layout: nested dicts of tensors, layer weights stacked
on a leading [L, ...] axis (see model/mistral.py and model/vit.py), exactly
the pytree of ``init_trace_params`` in trace_tpu/model/trace_model.py.
"""

from __future__ import annotations

import numpy as np
import torch

from trace_tpu_torch.constants import SCORE_VOCAB_SIZE, TIME_VOCAB_SIZE
from trace_tpu_torch.model.config import DecoderConfig, TraceConfig, VisionConfig


def _to_tensor(x) -> torch.Tensor:
    a = np.array(x)  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 has no torch mapping
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype.name == "int4":  # ml_dtypes int4, [-8, 7]: one value an int8
        return torch.from_numpy(a.astype(np.int8))
    return torch.from_numpy(a)


def from_jax_params(tree) -> dict:
    """Map a tree of numpy (or array-like) leaves, as ``init_trace_params``
    of the JAX package makes it after ``jax.tree.map(np.asarray, ...)``, to
    the port's tree of CPU tensors (``TracePipeline`` and ``train_loop`` move
    them to their device). Every leaf crosses as it is, LoRA adapter leaves
    (``<name>_lora_a`` / ``_lora_b``), quantized leaves and a Mixtral tree's
    [L, E, ...] expert stacks included; native ``int4`` values (the JAX
    package's ``quant="int4"`` tree) become int8 tensors of the same values,
    the port's ``quantize_decoder_params(bits=4, pack=False)`` leaves."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):  # a connector's layers
        return [from_jax_params(v) for v in tree]
    return _to_tensor(tree)


class _Init:
    """Draws N(0, 1) * scale leaves from one generator, a leading slice at a
    time (a full-width fp32 temp of a stacked 7B leaf would be 7.5 GB)."""

    def __init__(self, generator: torch.Generator, device, dtype):
        self.g, self.device, self.dtype = generator, device, dtype

    def normal(self, shape, scale=0.02):
        out = torch.empty(shape, dtype=self.dtype, device=self.device)
        rows = out.view(shape[0], -1) if len(shape) > 2 else out[None]
        for r in rows:
            r.copy_(torch.randn(r.shape, generator=self.g, device=self.device,
                                dtype=torch.float32).mul_(scale))
        return out

    def ones(self, shape):
        return torch.ones(shape, dtype=self.dtype, device=self.device)

    def zeros(self, shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)


def _decoder(c: DecoderConfig, r: _Init, mlp: bool = True) -> dict:
    """The decoder; without ``mlp`` no dense MLP weights (a Mixtral-family
    tree takes its experts from ``model/moe.py``)."""
    L, D, I = c.num_layers, c.hidden_size, c.intermediate_size
    NH, NKV, HD = c.num_heads, c.num_kv_heads, c.head_dim
    embed = r.normal((c.vocab_size, D))
    layers = {
        "attn_norm": r.ones((L, D)),
        "mlp_norm": r.ones((L, D)),
        "wq": r.normal((L, D, NH, HD)),
        "wk": r.normal((L, D, NKV, HD)),
        "wv": r.normal((L, D, NKV, HD)),
        "wo": r.normal((L, NH, HD, D)),
    }
    if mlp:
        layers.update(w_gate=r.normal((L, D, I)), w_up=r.normal((L, D, I)),
                      w_down=r.normal((L, I, D)))
    if c.attn_qkv_bias:  # qwen2: zeros, as the JAX package's, no draw
        layers["bq"] = r.zeros((L, NH, HD))
        layers["bk"] = r.zeros((L, NKV, HD))
        layers["bv"] = r.zeros((L, NKV, HD))
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": r.ones((D,)),
        "lm_head": r.normal((D, c.vocab_size)),
        "sync_head": r.normal((D, 1)),
        "time_head": r.normal((D, c.time_vocab_size)),
        "score_head": r.normal((D, c.score_vocab_size)),
    }


def _vision(c: VisionConfig, r: _Init) -> dict:
    L, D, I, P = c.num_layers, c.hidden_size, c.intermediate_size, c.patch_size
    layers = {
        "ln1_scale": r.ones((L, D)), "ln1_bias": r.zeros((L, D)),
        "wq": r.normal((L, D, D)), "bq": r.zeros((L, D)),
        "wk": r.normal((L, D, D)), "bk": r.zeros((L, D)),
        "wv": r.normal((L, D, D)), "bv": r.zeros((L, D)),
        "wo": r.normal((L, D, D)), "bo": r.zeros((L, D)),
        "ln2_scale": r.ones((L, D)), "ln2_bias": r.zeros((L, D)),
        "fc1": r.normal((L, D, I)), "b1": r.zeros((L, I)),
        "fc2": r.normal((L, I, D)), "b2": r.zeros((L, D)),
    }
    return {
        "class_embedding": r.normal((D,)),
        "patch_embed": r.normal((P * P * 3, D)),
        "position_embedding": r.normal((c.num_patches + 1, D)),
        "pre_ln": {"scale": r.ones((D,)), "bias": r.zeros((D,))},
        "layers": layers,
    }


def _connector(config: TraceConfig, r: _Init) -> dict:
    """The connector of ``config.mm_projector_type`` in the JAX package's
    layout (model/connector.py): the slot connectors take
    ``config.num_slots``, the others their own defaults, as there."""
    from trace_tpu_torch.model.connector import build_connector

    init, _ = build_connector(config.mm_projector_type)
    kw = ({"num_slots": config.num_slots}
          if config.mm_projector_type in ("spatial_slot", "slot") else {})
    return init(r, config.vision.hidden_size, config.decoder.hidden_size, **kw)


def _towers(hidden: int, r: _Init) -> dict:
    return {
        "time": r.normal((TIME_VOCAB_SIZE, hidden)),
        "score": r.normal((SCORE_VOCAB_SIZE, hidden)),
        "sync": r.normal((1, hidden)),
    }


def init_connector_params(config: TraceConfig, generator: torch.Generator,
                          dtype=None) -> dict:
    """A fresh connector of ``config.mm_projector_type`` (spatial_slot:
    slots N(0, 1), LayerNorm 1 / 0, readout N(0, 0.02); the others as
    ``model/connector.py`` sets them) in ``dtype`` (default: the config's),
    drawn from ``generator`` on its device, as CPU tensors (a converted
    tree's place)."""
    r = _Init(generator, generator.device, dtype or config.dtype)
    return _cpu(_connector(config, r))


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cpu(v) for v in tree]
    return tree.cpu()


def init_tower_params(hidden: int, generator: torch.Generator,
                      dtype=torch.float32) -> dict:
    """Fresh time / score / sync towers, N(0, 0.02), drawn as
    ``init_connector_params`` draws the connector."""
    r = _Init(generator, generator.device, dtype)
    return {k: v.cpu() for k, v in _towers(hidden, r).items()}


def init_trace_params(config: TraceConfig, generator: torch.Generator,
                      device=None) -> dict:
    """Random params in the JAX package's layout and init scales (weights
    N(0, 0.02), norms 1, biases 0 (qwen2's qkv biases too), connector slots
    N(0, 1), convolutions N(0, 1 / fan_in)). The values
    differ from JAX's for the same seed; tests that compare the two sides
    make the weights with JAX and convert them with ``from_jax_params``.
    ``device`` defaults to the generator's. A Mixtral-family decoder config
    gets the dense decoder here too, as in the JAX package; its routed tree
    comes from ``model.moe.init_moe_decoder_params``."""
    device = torch.device(device if device is not None else generator.device)
    r = _Init(generator, device, config.dtype)
    return {
        "decoder": _decoder(config.decoder, r),
        "vision": _vision(config.vision, r),
        "connector": _connector(config, r),
        "towers": _towers(config.decoder.hidden_size, r),
    }
