"""HF checkpoint -> the port's parameter tree (trace_tpu/checkpoint/convert.py).

Converts the released TRACE checkpoints (TraceMistralForCausalLM merged
dirs, reference trace/model/builder.py:29-156) and their parts (the CLIP
vision tower, mm_projector.bin, the time/score/sync towers) into the layout
of ``params.init_trace_params``: nested dicts of CPU tensors, layer weights
stacked on a leading [L, ...] axis, projections as [in, out].

Reading. ``safetensors`` files are read here, without the ``safetensors``
package (bf16 has no numpy dtype without ``ml_dtypes``): an 8-byte
little-endian header length, a JSON header of ``dtype``, ``shape`` and
``data_offsets``, then the raw little-endian bytes. Each tensor is a view
into a private memory map of its file (``torch.frombuffer``): reading a
checkpoint dir copies nothing, and bf16 stays bf16 bit for bit. Torch
``.bin`` files go through ``torch.load(weights_only=True)``.

Converting. Each stacked leaf is allocated once in the target dtype and
filled layer by layer from the maps (the transpose and the cast in one
copy), so the host holds the converted tree and the pages of the file it
reads, never a second copy of the state dict or an fp32 temp of a stacked
leaf. Layer keys are built by index (``layers.{i}``). The values are the JAX
package's: a stored value cast to the target dtype, which the JAX package
reaches through fp32 (exact for every floating type below fp64).

Backbones: Mistral, llama / vicuna, qwen2 (its q / k / v biases) and
Mixtral (``block_sparse_moe`` experts into [L, E, ...] stacks).
Connectors: every type of ``model/connector.py``.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import re
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Mapping

import torch

from trace_tpu_torch.model.config import DecoderConfig, MoEConfig, TraceConfig, VisionConfig

StateDict = Mapping[str, torch.Tensor]

SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


# ---------------------------------------------------------------------------
# Raw tensor loading (safetensors / torch .bin), local files only
# ---------------------------------------------------------------------------

def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, as CPU views of a private
    (copy-on-write) memory map of it, in the stored dtype and shape."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (no header length)")
        (n,) = struct.unpack("<Q", head)
        header = json.loads(f.read(n))
        size = os.fstat(f.fileno()).st_size
        data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size else b""
    base = 8 + n
    tensors = {}
    for key, info in header.items():
        if key == "__metadata__":
            continue
        if info["dtype"] not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {key}: unsupported dtype {info['dtype']}")
        dtype = SAFETENSORS_DTYPES[info["dtype"]]
        shape = [int(d) for d in info["shape"]]
        start, end = (int(o) for o in info["data_offsets"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - start != math.prod(shape) * itemsize or base + end > size:
            raise ValueError(f"{path}: {key}: offsets {start}..{end} do not hold "
                             f"{shape} {info['dtype']}")
        if end == start:
            tensors[key] = torch.empty(shape, dtype=dtype)
            continue
        t = torch.frombuffer(data, dtype=torch.uint8, count=end - start, offset=base + start)
        if (base + start) % itemsize:  # an unaligned tensor: copy it once
            t = t.clone()
        tensors[key] = t.view(dtype).view(shape)
    return tensors


def load_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """Every ``*.safetensors`` shard of a checkpoint dir, in sorted file
    order (a key in a later shard wins, as in the JAX package)."""
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {path}")
    tensors: Dict[str, torch.Tensor] = {}
    for f in files:
        tensors.update(read_safetensors(os.path.join(path, f)))
    return tensors


def load_torch_bin(path: str) -> Dict[str, torch.Tensor]:
    """A torch-serialized state dict (e.g. mm_projector.bin) on the CPU, in
    its stored dtypes (the JAX package widens every tensor to fp32; the
    converters and ``merge_lora_weights`` cast the same values either way)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach() for k, v in state.items()}


def load_checkpoint_tensors(path: str) -> Dict[str, torch.Tensor]:
    """Tensors of a checkpoint dir (safetensors preferred, ``pytorch_model*
    .bin`` otherwise) or of a single ``.bin`` / ``.safetensors`` file."""
    if os.path.isfile(path):
        if path.endswith(".safetensors"):
            return read_safetensors(path)
        return load_torch_bin(path)
    if any(f.endswith(".safetensors") for f in os.listdir(path)):
        return load_safetensors_dir(path)
    tensors: Dict[str, torch.Tensor] = {}
    for f in sorted(os.listdir(path)):
        if f.startswith("pytorch_model") and f.endswith(".bin"):
            tensors.update(load_torch_bin(os.path.join(path, f)))
    if not tensors:
        raise FileNotFoundError(f"no model weights found in {path}")
    return tensors


# ---------------------------------------------------------------------------
# Leaves: one cast copy each, stacked leaves one layer at a time
# ---------------------------------------------------------------------------

def _leaf(w: torch.Tensor, dtype, transpose: bool = False) -> torch.Tensor:
    """``w`` (2-D and transposed with ``transpose``) as a new tensor of
    ``dtype``."""
    w = w.t() if transpose else w
    return torch.empty(w.shape, dtype=dtype).copy_(w)


def _fill(out: torch.Tensor, weights: list) -> torch.Tensor:
    """Copy ``weights[i]`` into ``out`` viewed as [len(weights), ...], slot i
    viewed as the weight's shape, on a pool of ``torch.get_num_threads()``
    threads (a transposed copy runs on one core, and the copies release the
    interpreter lock)."""
    slots = out.view(len(weights), -1)

    def put(i):
        slots[i].view(weights[i].shape).copy_(weights[i])

    with ThreadPoolExecutor(max(1, min(len(weights), torch.get_num_threads()))) as pool:
        list(pool.map(put, range(len(weights))))
    return out


def _stack(sd: StateDict, fmt: str, num_layers: int, dtype, layer_shape=None,
           transpose: bool = False) -> torch.Tensor:
    """The [L, ...] leaf of the keys ``fmt.format(i=i)``, i = 0..L-1: each
    layer's weight (2-D and transposed with ``transpose``) viewed as
    ``layer_shape`` (default: its own shape), cast into its slot."""
    weights = [sd[fmt.format(i=i)] for i in range(num_layers)]
    weights = [w.t() for w in weights] if transpose else weights
    out = torch.empty((num_layers,) + tuple(layer_shape or weights[0].shape), dtype=dtype)
    return _fill(out, weights)


def _stack_experts(sd: StateDict, fmt: str, num_layers: int, num_experts: int,
                   dtype) -> torch.Tensor:
    """The [L, E, in, out] leaf of the 2-D HF expert weights
    ``fmt.format(i=i, j=j)`` ([out, in], transposed), allocated once in
    ``dtype`` and filled an (i, j) slot at a time."""
    weights = [sd[fmt.format(i=i, j=j)].t()
               for i in range(num_layers) for j in range(num_experts)]
    out = torch.empty((num_layers, num_experts) + tuple(weights[0].shape), dtype=dtype)
    return _fill(out, weights)


# ---------------------------------------------------------------------------
# Mistral decoder
# ---------------------------------------------------------------------------

def convert_mistral_decoder(sd: StateDict, config: DecoderConfig, *,
                            prefix: str = "model.", dtype=torch.float32,
                            mlp: bool = True) -> dict:
    """HF MistralForCausalLM (+ TRACE heads) state dict -> decoder params.

    HF's ``nn.Linear`` stores [out, in] and the port's products contract
    [in, out], so every projection transposes; the attention projections
    also split heads: q_proj [NH*hd, D] -> wq [D, NH, hd], o_proj
    [D, NH*hd] -> wo [NH, hd, D]. With ``attn_qkv_bias`` (qwen2) the q / k /
    v projection biases split heads too: bq [NH, hd], bk / bv [NKV, hd].
    ``embed_tokens`` and ``lm_head`` keep their first ``vocab_size`` rows; a
    missing sync/time/score head is zeros. Without ``mlp`` the dense MLP
    keys are neither read nor converted (``convert_mixtral_decoder``)."""
    c = config
    L, D = c.num_layers, c.hidden_size
    NH, NKV, HD = c.num_heads, c.num_kv_heads, c.head_dim
    lyr = prefix + "layers.{i}."

    def stack(name, shape=None, transpose=False):
        return _stack(sd, lyr + name, L, dtype, shape, transpose)

    layers = {
        "attn_norm": stack("input_layernorm.weight"),
        "mlp_norm": stack("post_attention_layernorm.weight"),
        "wq": stack("self_attn.q_proj.weight", (D, NH, HD), True),
        "wk": stack("self_attn.k_proj.weight", (D, NKV, HD), True),
        "wv": stack("self_attn.v_proj.weight", (D, NKV, HD), True),
        "wo": stack("self_attn.o_proj.weight", (NH, HD, D), True),
    }
    if mlp:
        for name, hf_name in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                              ("w_down", "down_proj")):
            layers[name] = stack(f"mlp.{hf_name}.weight", transpose=True)
    if c.attn_qkv_bias:  # qwen2-style backbones
        for name, proj, heads in (("bq", "q", NH), ("bk", "k", NKV), ("bv", "v", NKV)):
            layers[name] = stack(f"self_attn.{proj}_proj.bias", (heads, HD))
    params = {
        "embed": _leaf(sd[f"{prefix}embed_tokens.weight"][: c.vocab_size], dtype),
        "layers": layers,
        "final_norm": _leaf(sd[f"{prefix}norm.weight"], dtype),
        "lm_head": _leaf(sd["lm_head.weight"][: c.vocab_size], dtype, transpose=True),
    }
    # TRACE's auxiliary heads (trace_mistral.py:91-94); absent in vanilla Mistral
    for name, width in (("sync_head", 1), ("time_head", c.time_vocab_size),
                        ("score_head", c.score_vocab_size)):
        key = f"{name}.weight"
        params[name] = (_leaf(sd[key], dtype, transpose=True) if key in sd
                        else torch.zeros((D, width), dtype=dtype))
    return params


def convert_mixtral_decoder(sd: StateDict, config: MoEConfig, *, prefix: str = "model.",
                            dtype=torch.float32) -> dict:
    """HF MixtralForCausalLM state dict -> MoE decoder params. Attention,
    norms, embedding and heads convert as Mistral's; each layer's
    ``block_sparse_moe`` maps to the stacked-expert layout of
    ``model/moe.py``:

      gate.weight           [E, D]  -> router  [L, D, E]
      experts.{j}.w1.weight [I, D]  -> w_gate  [L, E, D, I]
      experts.{j}.w3.weight [I, D]  -> w_up    [L, E, D, I]
      experts.{j}.w2.weight [D, I]  -> w_down  [L, E, I, D]

    Each stack is allocated once in ``dtype`` and filled an expert at a time
    (the JAX package stacks fp32 numpy copies first: ~190 GB of host memory
    at Mixtral-8x7B's 32 layers)."""
    c = config
    L, E = c.num_layers, c.num_experts
    params = convert_mistral_decoder(sd, c, prefix=prefix, dtype=dtype, mlp=False)
    moe = prefix + "layers.{i}.block_sparse_moe."
    layers = params["layers"]
    layers["router"] = _stack(sd, moe + "gate.weight", L, dtype, transpose=True)
    for name, hf_name in (("w_gate", "w1"), ("w_up", "w3"), ("w_down", "w2")):
        layers[name] = _stack_experts(sd, moe + "experts.{j}." + hf_name + ".weight",
                                      L, E, dtype)
    return params


# ---------------------------------------------------------------------------
# CLIP vision tower
# ---------------------------------------------------------------------------

def convert_clip_vision(sd: StateDict, config: VisionConfig, *,
                        prefix: str = "vision_model.", dtype=torch.float32) -> dict:
    """HF CLIPVisionModel state dict -> ViT params.

    ``patch_embedding.weight`` [D, 3, p, p] flattens channel-major into
    [3*p*p, D], the order of ``model.vit.extract_patches``. HF's historical
    typo ``pre_layrnorm`` is read where present, else ``pre_layernorm``."""
    c = config
    L, D = c.num_layers, c.hidden_size
    lyr = prefix + "encoder.layers.{i}."

    def get(name):
        return sd[prefix + name]

    def stack(name, transpose=False):
        return _stack(sd, lyr + name, L, dtype, transpose=transpose)

    pre_ln = "pre_layrnorm" if prefix + "pre_layrnorm.weight" in sd else "pre_layernorm"
    return {
        "class_embedding": _leaf(get("embeddings.class_embedding"), dtype),
        "patch_embed": _leaf(get("embeddings.patch_embedding.weight").reshape(D, -1),
                             dtype, transpose=True),
        "position_embedding": _leaf(get("embeddings.position_embedding.weight"), dtype),
        "pre_ln": {
            "scale": _leaf(get(pre_ln + ".weight"), dtype),
            "bias": _leaf(get(pre_ln + ".bias"), dtype),
        },
        "layers": {
            "ln1_scale": stack("layer_norm1.weight"),
            "ln1_bias": stack("layer_norm1.bias"),
            "wq": stack("self_attn.q_proj.weight", True),
            "bq": stack("self_attn.q_proj.bias"),
            "wk": stack("self_attn.k_proj.weight", True),
            "bk": stack("self_attn.k_proj.bias"),
            "wv": stack("self_attn.v_proj.weight", True),
            "bv": stack("self_attn.v_proj.bias"),
            "wo": stack("self_attn.out_proj.weight", True),
            "bo": stack("self_attn.out_proj.bias"),
            "ln2_scale": stack("layer_norm2.weight"),
            "ln2_bias": stack("layer_norm2.bias"),
            "fc1": stack("mlp.fc1.weight", True),
            "b1": stack("mlp.fc1.bias"),
            "fc2": stack("mlp.fc2.weight", True),
            "b2": stack("mlp.fc2.bias"),
        },
    }


# ---------------------------------------------------------------------------
# Connector (mm_projector) + towers
# ---------------------------------------------------------------------------

def convert_spatial_slot(sd: StateDict, *, prefix: str = "model.mm_projector.",
                         dtype=torch.float32) -> dict:
    """SpatialSlotPool weights (builder.py:411-424): slots [D_mm, S], the
    ln_vision LayerNorm, the bias-free readout Linear."""
    return {
        "slots": _leaf(sd[prefix + "slots"], dtype),
        "ln_scale": _leaf(sd[prefix + "ln_vision.weight"], dtype),
        "ln_bias": _leaf(sd[prefix + "ln_vision.bias"], dtype),
        "readout": _leaf(sd[prefix + "readout.weight"], dtype, transpose=True),
    }


def convert_spatial_time_slot(sd: StateDict, *, prefix: str = "model.mm_projector.",
                              dtype=torch.float32) -> dict:
    """SpatialTimeSlotPool weights (builder.py:469-487): the spatial and time
    slot banks sharing one ln_vision LayerNorm and bias-free readout."""
    return {
        "spatial_slots": _leaf(sd[prefix + "spatial_slots"], dtype),
        "time_slots": _leaf(sd[prefix + "time_slots"], dtype),
        "ln_scale": _leaf(sd[prefix + "ln_vision.weight"], dtype),
        "ln_bias": _leaf(sd[prefix + "ln_vision.bias"], dtype),
        "readout": _leaf(sd[prefix + "readout.weight"], dtype, transpose=True),
    }


def _linear(sd: StateDict, name: str, dtype) -> dict:
    """An nn.Linear ``name`` as {weight [in, out], bias}."""
    return {"weight": _leaf(sd[name + ".weight"], dtype, transpose=True),
            "bias": _leaf(sd[name + ".bias"], dtype)}


def convert_connector(sd: StateDict, config: TraceConfig, *, dtype=torch.float32) -> dict:
    """The mm_projector of ``config.mm_projector_type`` out of a state dict
    with the ``model.mm_projector.`` prefix."""
    if config.mm_projector_type == "spatial_slot":
        return convert_spatial_slot(sd, dtype=dtype)
    return _convert_generic_projector(sd, config, dtype=dtype)


def _convert_generic_projector(sd: StateDict, config: TraceConfig, *,
                               dtype=torch.float32) -> dict:
    """linear, mlpNx_gelu (GELUs at the odd indices of the Sequential), the
    STC family, slot (SlotPool has SpatialSlotPool's state-dict layout),
    spatial_time_slot and identity."""
    from trace_tpu_torch.model.stc_connector import SPECS

    t = config.mm_projector_type
    if t == "linear":
        return _linear(sd, "model.mm_projector", dtype)
    m = re.match(r"^mlp(\d+)x_gelu$", t)
    if m:
        return {"layers": [_linear(sd, f"model.mm_projector.{2 * i}", dtype)
                           for i in range(int(m.group(1)))]}
    if t in SPECS:
        return convert_stc_connector(sd, t, dtype=dtype)
    if t == "slot":
        return convert_spatial_slot(sd, dtype=dtype)
    if t == "spatial_time_slot":
        return convert_spatial_time_slot(sd, dtype=dtype)
    if t == "identity":
        return {}
    raise NotImplementedError(f"projector conversion for {t} not implemented")


def convert_stc_connector(sd: StateDict, projector_type: str, *,
                          prefix: str = "model.mm_projector.", dtype=torch.float32) -> dict:
    """An STC / STP-family state dict -> stc_connector params. Keys follow
    the reference's module tree: timm RegStage names (s1.b{i}.conv1.conv,
    .bn for the LayerNorm2d, se.fc1, downsample.conv), the Sequential
    sampler (sampler.0) and build_mlp's readout (readout.0, readout.2, ...).
    Conv weights keep their layout; the readout's Linears transpose."""
    from trace_tpu_torch.model.stc_connector import SPECS

    spec = SPECS[projector_type]

    def get(name):
        return _leaf(sd[prefix + name], dtype)

    def block(stage: str, i: int) -> dict:
        b = f"{stage}.b{i + 1}"
        p = {}
        for n in (1, 2, 3):
            p[f"conv{n}"] = get(f"{b}.conv{n}.conv.weight")
            p[f"ln{n}_scale"] = get(f"{b}.conv{n}.bn.weight")
            p[f"ln{n}_bias"] = get(f"{b}.conv{n}.bn.bias")
        for n in (1, 2):
            p[f"se_fc{n}_w"] = get(f"{b}.se.fc{n}.weight")
            p[f"se_fc{n}_b"] = get(f"{b}.se.fc{n}.bias")
        if prefix + f"{b}.downsample.conv.weight" in sd:
            p["down_conv"] = get(f"{b}.downsample.conv.weight")
            p["down_ln_scale"] = get(f"{b}.downsample.bn.weight")
            p["down_ln_bias"] = get(f"{b}.downsample.bn.bias")
        return p

    params: dict = {
        "s1": [block("s1", i) for i in range(spec.depth)],
        "s2": [block("s2", i) for i in range(spec.depth)],
    }
    if spec.sampler == "conv":
        params["sampler_w"] = get("sampler.0.weight")
        params["sampler_b"] = get("sampler.0.bias")
    params["mlp"] = [_linear(sd, f"{prefix}readout.{2 * i}", dtype)
                     for i in range(spec.mlp_depth)]
    return params


def convert_towers(sd: StateDict, *, prefix: str = "model.", dtype=torch.float32) -> dict:
    return {
        "time": _leaf(sd[prefix + "time_tower.embed_tokens.weight"], dtype),
        "score": _leaf(sd[prefix + "score_tower.embed_tokens.weight"], dtype),
        "sync": _leaf(sd[prefix + "sync_tower.embed_tokens.weight"], dtype),
    }


# ---------------------------------------------------------------------------
# Full TRACE checkpoint
# ---------------------------------------------------------------------------

def read_hf_config(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def trace_config_from_hf(hf_cfg: dict, **overrides) -> TraceConfig:
    """A TraceConfig from an HF ``config.json``: the decoder's geometry and
    the TRACE fields (projector, slots, frames, aspect); explicit
    ``overrides`` win. The vision tower is the default CLIP ViT-L/14-336,
    as in the JAX package. A qwen2 ``model_type`` sets ``attn_qkv_bias``.
    Where ``num_key_value_heads`` is missing the KV heads default to 8, as
    in the JAX package (HF's llama defaults to ``num_attention_heads``).
    A mixtral ``model_type`` or ``num_local_experts`` gives a ``MoEConfig``
    (its experts and top-k) in the dense form: the sparse form drops a
    token's expert where a bucket overflows, which the HF model the weights
    were trained under never does."""
    model_type = hf_cfg.get("model_type", "")
    hidden = hf_cfg.get("hidden_size", 4096)
    heads = hf_cfg.get("num_attention_heads", 32)
    dec_cls, moe_kw = DecoderConfig, {}
    if "mixtral" in model_type or hf_cfg.get("num_local_experts"):
        dec_cls = MoEConfig
        moe_kw = dict(num_experts=hf_cfg.get("num_local_experts", 8),
                      top_k=hf_cfg.get("num_experts_per_tok", 2), moe_impl="dense")
    dec = dec_cls(
        **moe_kw,
        vocab_size=hf_cfg.get("vocab_size", 32000),
        hidden_size=hidden,
        intermediate_size=hf_cfg.get("intermediate_size", 14336),
        num_layers=hf_cfg.get("num_hidden_layers", 32),
        num_heads=heads,
        num_kv_heads=hf_cfg.get("num_key_value_heads", 8),
        head_dim=hf_cfg.get("head_dim") or hidden // heads,
        rope_theta=hf_cfg.get("rope_theta", 10000.0),
        rms_eps=hf_cfg.get("rms_norm_eps", 1e-5),
        time_vocab_size=hf_cfg.get("time_vocab_size", 13),
        score_vocab_size=hf_cfg.get("score_vocab_size", 13),
        attn_qkv_bias="qwen2" in model_type,
    )
    kwargs = dict(
        decoder=dec,
        mm_projector_type=hf_cfg.get("mm_projector_type", "spatial_slot"),
        num_slots=hf_cfg.get("num_slots", 8),
        num_frames=hf_cfg.get("num_frames", 128),
        image_aspect_ratio=hf_cfg.get("image_aspect_ratio", "pad"),
    )
    kwargs.update(overrides)
    return TraceConfig(**kwargs)


BUNDLED_VISION = "model.vision_tower.vision_tower.vision_model."


def convert_state_dict(sd: StateDict, config: TraceConfig, *, dtype,
                       vision_path: str | None = None) -> dict:
    """A merged state dict -> params: decoder (Mixtral's routed experts for a
    ``MoEConfig``) + heads, connector, towers, and the CLIP tower bundled in
    ``sd`` or read from ``vision_path``."""
    moe = isinstance(config.decoder, MoEConfig)
    params = {
        "decoder": (convert_mixtral_decoder if moe else convert_mistral_decoder)(
            sd, config.decoder, dtype=dtype),
        "connector": convert_connector(sd, config, dtype=dtype),
        "towers": convert_towers(sd, dtype=dtype),
    }
    if any(k.startswith(BUNDLED_VISION) for k in sd):
        vision_sd, vision_prefix = sd, BUNDLED_VISION
    elif vision_path is None:
        raise FileNotFoundError(
            "checkpoint has no bundled vision tower; pass vision_path="
            "<local clip-vit-large-patch14-336 dir>")
    else:
        vision_sd, vision_prefix = load_checkpoint_tensors(vision_path), "vision_model."
    params["vision"] = convert_clip_vision(vision_sd, config.vision,
                                           prefix=vision_prefix, dtype=dtype)
    return params


def convert_trace_checkpoint(path: str, *, dtype=torch.bfloat16,
                             vision_path: str | None = None) -> tuple:
    """Merged TRACE checkpoint dir -> (params, TraceConfig), routed as
    load_pretrained_model routes a merged dir (reference model/builder.py:
    29-156): decoder, heads, mm_projector and towers from the dir, the CLIP
    tower bundled or from ``vision_path``."""
    config = trace_config_from_hf(read_hf_config(path), dtype=dtype)
    sd = load_checkpoint_tensors(path)
    return convert_state_dict(sd, config, dtype=dtype, vision_path=vision_path), config


# ---------------------------------------------------------------------------
# Stage-0 assembly: base LLM + base CLIP + fresh multimodal modules
# ---------------------------------------------------------------------------

def load_mm_projector(path: str, config: TraceConfig, *, dtype=torch.bfloat16) -> dict:
    """A standalone mm_projector.bin / dir -> connector params (reference
    builder.py:48-62 load_mm_projector). Its keys may or may not carry the
    ``model.mm_projector.`` prefix, depending on how the stage-1 run saved."""
    sd = load_checkpoint_tensors(path)
    if not any(k.startswith("model.mm_projector.") for k in sd):
        sd = {f"model.mm_projector.{k}": v for k, v in sd.items()}
    return convert_connector(sd, config, dtype=dtype)


def build_from_base_models(llm_path: str, vision_path: str, *,
                           mm_projector_path: str | None = None,
                           dtype=torch.bfloat16, generator: torch.Generator | None = None,
                           seed: int = 0, **config_overrides) -> tuple:
    """A fresh TRACE model for stage-1 pretraining: the base HF LLM's decoder
    and the base CLIP tower, converted, with a newly initialized connector,
    towers and (where the base has none) auxiliary heads (reference
    trace_arch.py:60-186, trace_mistral.py:85-96). ``mm_projector_path``
    resumes the connector from a stage-1 projector (the reference's
    --pretrain_mm_mlp_adapter flow).

    The fresh leaves are drawn from ``generator`` (default: a CPU generator
    seeded with ``seed``) at the JAX package's scales: heads and towers
    N(0, 0.02), slots N(0, 1), readout N(0, 0.02); JAX's PRNG cannot be
    matched, so their values differ from its. Returns (params, TraceConfig)."""
    from trace_tpu_torch.params import init_connector_params, init_tower_params

    config = trace_config_from_hf(read_hf_config(llm_path), dtype=dtype, **config_overrides)
    g = generator if generator is not None else torch.Generator().manual_seed(seed)
    decoder = convert_mistral_decoder(load_checkpoint_tensors(llm_path), config.decoder,
                                      dtype=dtype)
    D = config.decoder.hidden_size
    for name in ("sync_head", "time_head", "score_head"):
        if float(decoder[name].abs().max()) == 0.0:
            decoder[name] = (torch.randn(decoder[name].shape, generator=g,
                                         device=g.device) * 0.02).to(dtype).cpu()
    vision = convert_clip_vision(load_checkpoint_tensors(vision_path), config.vision,
                                 prefix="vision_model.", dtype=dtype)
    if mm_projector_path is not None:
        connector = load_mm_projector(mm_projector_path, config, dtype=dtype)
    else:
        connector = init_connector_params(config, g, dtype=dtype)
    params = {
        "decoder": decoder,
        "vision": vision,
        "connector": connector,
        "towers": init_tower_params(D, g, dtype=dtype),
    }
    return params, config
