"""Model configuration for the PyTorch port (copy of trace_tpu/model/config.py
with torch dtypes): the bf16, int8 and int4p serving configurations (int8
KV cache, W8A8 / W4A8 prefill and W8A8 ViT; ``model/quantize.py int8_serving``
and ``int4p_serving`` set them)."""

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
    """Mistral-7B decoder hyperparameters plus TRACE's sync/time/score heads
    (the JAX config's qkv-bias and LoRA fields belong to slices not ported
    yet). Mistral v0.1's 4096-token sliding window never binds at
    TRACE's context, so attention is plain causal."""

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

    @property
    def combined_vocab_size(self) -> int:
        return self.vocab_size + 1 + self.time_vocab_size + self.score_vocab_size

    @classmethod
    def mistral_7b(cls) -> "DecoderConfig":
        return cls()

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
    # Frame upload format: only 'rgb' is ported ('yuv420' needs the cv2 host
    # path, which the port does not carry)
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
