"""Model configuration for the PyTorch port (copy of trace_tpu/model/config.py
with torch dtypes)."""

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
    (the JAX config's qkv-bias, LoRA and W8A8 fields belong to slices not
    ported yet). Mistral v0.1's 4096-token sliding window never binds at
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
    # only 'bf16' is ported so far; 'int8' belongs to the quantized slice
    kv_cache_dtype: str = "bf16"

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
