"""Checkpoint layout routing: merged / base + projector / LoRA checkpoints
(trace_tpu/checkpoint/loader.py).

The three layouts of the reference's load_pretrained_model (reference
trace/model/builder.py:29-156):

1. merged dir             -> convert directly
2. base + mm_projector    -> base LM tensors + mm_projector.bin overlay
3. LoRA ('lora' in name)  -> base tensors + non_lora_trainables.bin overlay
                             + adapter_model weights merged into the base
                             (W' = W + alpha/r * B @ A, PEFT semantics)
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional

import torch

from trace_tpu_torch.checkpoint import convert as C


def get_model_name_from_path(model_path: str) -> str:
    """Checkpoint dir -> model name (reference: mm_utils.py:556-563)."""
    return "_".join(model_path.strip("/").split("/"))


def merge_lora_weights(base_sd: Dict[str, torch.Tensor],
                       adapter_sd: Dict[str, torch.Tensor],
                       lora_alpha: float, lora_r: int) -> Dict[str, torch.Tensor]:
    """Fold LoRA A/B pairs into the base weights (PEFT merge semantics), in
    fp32 as the JAX package does.

    Adapter keys look like ``base_model.model.<target>.lora_A.weight`` with
    A [r, in], B [out, r]; the merged delta (alpha / r) * B @ A is added to
    ``<target>.weight``, which becomes fp32."""
    scale = lora_alpha / lora_r
    merged = dict(base_sd)
    for key, a in adapter_sd.items():
        if ".lora_A." not in key:
            continue
        b_key = key.replace(".lora_A.", ".lora_B.")
        if b_key not in adapter_sd:
            continue
        target = re.sub(r"^base_model\.model\.", "", key.split(".lora_A.")[0]) + ".weight"
        if target not in merged:
            raise KeyError(f"LoRA target {target} not in base checkpoint")
        b = adapter_sd[b_key]
        merged[target] = merged[target].float() + scale * (b.float() @ a.float())
    return merged


def _config_dir(model_path: str, model_base: str) -> str:
    return model_path if os.path.exists(os.path.join(model_path, "config.json")) \
        else model_base


def load_pretrained(model_path: str, model_base: Optional[str] = None,
                    model_name: Optional[str] = None, *, dtype=None,
                    vision_path: Optional[str] = None):
    """Route a checkpoint layout to (params, TraceConfig); params are CPU
    tensors in ``dtype`` (default bf16)."""
    dtype = dtype or torch.bfloat16
    name = model_name or os.path.basename(model_path.rstrip("/"))

    if "lora" in name.lower() and model_base is not None:
        base_sd = C.load_checkpoint_tensors(model_base)
        extra_path = os.path.join(model_path, "non_lora_trainables.bin")
        if os.path.exists(extra_path):
            base_sd.update(C.load_torch_bin(extra_path))
        for cand in ("adapter_model.safetensors", "adapter_model.bin"):
            adapter_file = os.path.join(model_path, cand)
            if os.path.exists(adapter_file):
                adapter_sd = C.load_checkpoint_tensors(adapter_file)
                with open(os.path.join(model_path, "adapter_config.json")) as f:
                    acfg = json.load(f)
                base_sd = merge_lora_weights(base_sd, adapter_sd, acfg["lora_alpha"],
                                             acfg["r"])
                break
        hf_cfg = C.read_hf_config(_config_dir(model_path, model_base))
        return _convert_from_sd(base_sd, hf_cfg, dtype, vision_path)

    if model_base is not None:
        base_sd = C.load_checkpoint_tensors(model_base)
        proj = os.path.join(model_path, "mm_projector.bin")
        if os.path.exists(proj):
            base_sd.update(C.load_torch_bin(proj))
        hf_cfg = C.read_hf_config(_config_dir(model_path, model_base))
        return _convert_from_sd(base_sd, hf_cfg, dtype, vision_path)

    return C.convert_trace_checkpoint(model_path, dtype=dtype, vision_path=vision_path)


def _convert_from_sd(sd, hf_cfg, dtype, vision_path):
    config = C.trace_config_from_hf(hf_cfg, dtype=dtype)
    return C.convert_state_dict(sd, config, dtype=dtype, vision_path=vision_path), config
