"""The TRACE multimodal prefix: vision tower + connector + towers + the
combined-table splice (trace_tpu/model/trace_model.py, inference parts).

Every non-video token embeds through one gather from the combined
[V + 1 + Vt + Vs, D] table (text ++ sync ++ time ++ score), and the video
features are written over the pre-expanded video span of each row.
"""

from __future__ import annotations

from typing import Optional

import torch

from trace_tpu_torch.constants import TIME_TOKENS_PER_FRAME
from trace_tpu_torch.model.config import TraceConfig
from trace_tpu_torch.model.connector import spatial_slot_forward
from trace_tpu_torch.model.towers import embed_time
from trace_tpu_torch.model.vit import vit_forward


def build_combined_embedding(text_embed, sync_embed, time_embed, score_embed):
    """Single [combined_vocab, D] input-embedding table."""
    return torch.cat([text_embed, sync_embed, time_embed, score_embed], dim=0)


def combined_embedding(params: dict) -> torch.Tensor:
    """[32027, D] input-embedding table: text ++ sync ++ time ++ score."""
    return build_combined_embedding(
        params["decoder"]["embed"],
        params["towers"]["sync"],
        params["towers"]["time"],
        params["towers"]["score"],
    )


def tokens_per_frame(config: TraceConfig) -> int:
    return config.num_slots + TIME_TOKENS_PER_FRAME


def encode_video(
    params: dict,
    config: TraceConfig,
    frames: torch.Tensor,          # [B, T, H, W, 3] CLIP-normalized (or patches)
    frame_time_ids: torch.Tensor,  # [B, T, 6] local time-token ids per frame
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """Frames -> interleaved visual + time token features [B, T*(S+6), D_lm].

    The ViT runs over ``vit_chunk_size`` frames at a time (sequentially,
    bounding its activations), then the connector pools each frame to S
    slots and each frame's 6 time-token embeddings follow its slots."""
    if config.mm_projector_type != "spatial_slot":
        raise NotImplementedError(
            f"connector {config.mm_projector_type!r}: only spatial_slot is ported")
    B, T = frames.shape[:2]
    flat = frames.reshape((B * T,) + frames.shape[2:])
    chunk = config.vit_chunk_size

    def vit(x):
        return vit_forward(params["vision"], config.vision, x, impl=impl)

    if chunk and flat.shape[0] > chunk and flat.shape[0] % chunk == 0:
        feats = torch.cat([vit(c) for c in flat.split(chunk)], dim=0)
    else:
        feats = vit(flat)
    feats = feats.reshape(B, T, feats.shape[1], feats.shape[2])

    slots = spatial_slot_forward(params["connector"], feats)
    time_feats = embed_time(params["towers"], frame_time_ids)  # [B, T, 6, D_lm]
    merged = torch.cat([slots, time_feats.to(slots.dtype)], dim=2)
    return merged.reshape(B, T * merged.shape[2], merged.shape[3])


def build_input_embeds(
    params: dict,
    config: TraceConfig,
    token_ids: torch.Tensor,       # [B, L] combined-space ids
    video_features: torch.Tensor,  # [B, Tv, D] from encode_video
    video_pos: torch.Tensor,       # [B] start index of the video span
    table: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Gather token embeddings and write the video span. [B, L, D]."""
    if table is None:
        table = combined_embedding(params)
    embeds = table[token_ids.clamp(0, table.shape[0] - 1)]
    Tv = video_features.shape[1]
    for b, pos in enumerate(video_pos.tolist()):
        # dynamic_update_slice semantics: a span past the end is shifted in
        pos = max(0, min(pos, embeds.shape[1] - Tv))
        embeds[b, pos:pos + Tv] = video_features[b].to(embeds.dtype)
    return embeds


def encode_prefix_for_generation(
    params: dict,
    config: TraceConfig,
    token_ids: torch.Tensor,       # [B, L] combined ids with the video span
    video_pos: torch.Tensor,       # [B]
    frames: torch.Tensor,          # [B, T, H, W, 3]
    frame_time_ids: torch.Tensor,  # [B, T, 6]
    *,
    table: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Inference prefix embeds: encode the video and splice it in."""
    feats = encode_video(params, config, frames, frame_time_ids, impl=impl)
    return build_input_embeds(params, config, token_ids, feats, video_pos,
                              table=table)
