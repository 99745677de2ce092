"""Model configuration for the PyTorch port (copy of trace_tpu/model/config.py
with torch dtypes, and ``MoEConfig`` of trace_tpu/model/moe.py): the bf16,
int8 and int4p serving configurations (int8 KV cache, W8A8 / W4A8 prefill and
W8A8 ViT; ``model/quantize.py int8_serving`` and ``int4p_serving`` set
them)."""

from __future__ import annotations

import dataclasses

import torch

from trace_tpu_torch.constants import (
    NUM_SLOTS_PER_FRAME,
    SCORE_VOCAB_SIZE,
    TEXT_VOCAB_SIZE,
    TIME_VOCAB_SIZE,
)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Mistral-7B decoder hyperparameters plus TRACE's sync/time/score heads;
    ``vicuna_7b`` and ``qwen2_7b`` give the other two backbones that the
    reference's training script selects among. Mistral v0.1's 4096-token
    sliding window never binds at TRACE's context, so attention is plain
    causal."""

    vocab_size: int = TEXT_VOCAB_SIZE
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    time_vocab_size: int = TIME_VOCAB_SIZE
    score_vocab_size: int = SCORE_VOCAB_SIZE
    # qwen2-style biases on the q / k / v projections (leaves bq [L, NH, hd],
    # bk / bv [L, NKV, hd]), added before RoPE
    attn_qkv_bias: bool = False
    # KV cache storage: 'bf16', or 'int8' (values int8, one bf16 scale per
    # layer, row, kv head and slot)
    kv_cache_dtype: str = "bf16"
    # W8A8: with int8 weights (W4A8: per-channel packed int4), chunks of more
    # than one token (prefill) quantize their activations per token and run
    # s8 x s8 -> s32 products; a T = 1 step always stays weight-only, and so
    # does every chunk of group-scaled packed int4 weights
    act_quant: bool = False
    # body of the decode-step attention over an int8 cache: 's8dot' (q rows
    # and probabilities quantized, s8 x s8 products; the JAX package's
    # default) or 'dequant' (K/V widened to bf16; its TRACE_TPU_DECODE_ATTN_S8=0)
    decode_attn_int8: str = "s8dot"
    # the packed per-channel int4 leaves hold the JAX package's native int4
    # tree (quant="int4", model/quantize.py int4_serving), which shards under
    # tensor parallelism; other packed trees are int4p, single-device only
    native_int4: bool = False
    # LoRA adapters (model/lora.py): rank (0 = none) and alpha
    lora_r: int = 0
    lora_alpha: float = 16.0

    @property
    def combined_vocab_size(self) -> int:
        return self.vocab_size + 1 + self.time_vocab_size + self.score_vocab_size

    @classmethod
    def mistral_7b(cls) -> "DecoderConfig":
        return cls()

    @classmethod
    def vicuna_7b(cls) -> "DecoderConfig":
        """Llama-2-7b-class backbone: MHA (32 kv heads), 11008 FFN, 32k vocab."""
        return cls(
            vocab_size=32000, hidden_size=4096, intermediate_size=11008,
            num_layers=32, num_heads=32, num_kv_heads=32, head_dim=128,
            rope_theta=10000.0, rms_eps=1e-5,
        )

    @classmethod
    def qwen2_7b(cls) -> "DecoderConfig":
        """Qwen2-7B-class backbone: GQA 28 / 4 (a group of 7), qkv biases,
        152064-token vocab."""
        return cls(
            vocab_size=152064, hidden_size=3584, intermediate_size=18944,
            num_layers=28, num_heads=28, num_kv_heads=4, head_dim=128,
            rope_theta=1000000.0, rms_eps=1e-6, attn_qkv_bias=True,
        )

    @classmethod
    def tiny(cls, vocab_size: int = 384) -> "DecoderConfig":
        """Small config for CPU tests. vocab_size>=259 fits ByteTokenizer."""
        return cls(
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
        )


@dataclasses.dataclass(frozen=True)
class MoEConfig(DecoderConfig):
    """A Mixtral-family decoder (trace_tpu/model/moe.py): the Mistral block
    with its MLP replaced by ``num_experts`` SwiGLU experts, ``top_k`` of them
    routed per token (``model/moe.py``)."""

    num_experts: int = 8
    top_k: int = 2
    # 'sparse': capacity-bucketed dispatch, k * capacity_factor / E of the
    # dense products; 'dense': every expert computes every token (exact, no
    # drops; what converted checkpoints get)
    moe_impl: str = "sparse"
    # an expert's bucket holds capacity_factor x the mean load; a token past
    # it loses that expert's contribution (Switch semantics)
    capacity_factor: float = 2.0

    @classmethod
    def tiny_moe(cls) -> "MoEConfig":
        return cls(
            vocab_size=384, hidden_size=64, intermediate_size=96,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            num_experts=4, top_k=2,
        )

    @classmethod
    def mixtral_8x7b(cls) -> "MoEConfig":
        """Mistral-7B's widths with 8 experts, 2 a token, as the JAX
        package's preset; a checkpoint's ``config.json`` sets the rest
        (Mixtral-8x7B-v0.1's ``rope_theta`` is 1e6)."""
        return cls(num_experts=8, top_k=2)


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """CLIP ViT-L/14-336."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    patch_size: int = 14
    image_size: int = 336
    layer_eps: float = 1e-5
    # hidden-states tap: -2 == output of layer num_layers-2 (pre-final layer),
    # CLS dropped
    select_layer: int = -2
    select_feature: str = "patch"
    # W8A8 products for int8 ViT weights (see DecoderConfig.act_quant)
    act_quant: bool = False

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.num_patches_per_side ** 2

    @classmethod
    def tiny(cls) -> "VisionConfig":
        return cls(
            hidden_size=32,
            intermediate_size=64,
            num_layers=3,
            num_heads=2,
            patch_size=14,
            image_size=56,
        )


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Full multimodal model: vision tower + connector + decoder + towers."""

    decoder: DecoderConfig = dataclasses.field(default_factory=DecoderConfig)
    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig)
    mm_projector_type: str = "spatial_slot"
    num_slots: int = NUM_SLOTS_PER_FRAME
    num_frames: int = 128
    image_aspect_ratio: str = "pad"
    dtype: torch.dtype = torch.bfloat16
    # ViT frames per sequential chunk (0 = single batch)
    vit_chunk_size: int = 16
    # Frame upload format: 'rgb' (uint8 frames, preprocessed on the device)
    # or 'yuv420' (the host sends the I420 content band of the squared,
    # downscaled frame: half of RGB's bytes and less; video/preprocess.py)
    upload_format: str = "rgb"

    @classmethod
    def tiny(cls) -> "TraceConfig":
        return cls(
            decoder=DecoderConfig.tiny(),
            vision=VisionConfig.tiny(),
            num_slots=4,
            num_frames=4,
            dtype=torch.float32,
        )
