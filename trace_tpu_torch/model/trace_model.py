"""The full TRACE multimodal model: vision tower + connector + towers +
decoder (trace_tpu/model/trace_model.py): the inference prefix and the
training forward with its three-stream loss.

Every non-video token embeds through one gather from the combined
[V + 1 + Vt + Vs, D] table (text ++ sync ++ time ++ score), and the video
features are written over the pre-expanded video span of each row.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from trace_tpu_torch.constants import IGNORE_INDEX, TIME_TOKENS_PER_FRAME
from trace_tpu_torch.model.config import TraceConfig
from trace_tpu_torch.model.connector import build_connector
from trace_tpu_torch.model.mistral import compute_logits, decoder_forward
from trace_tpu_torch.model.quantize import is_quantized
from trace_tpu_torch.model.towers import embed_time
from trace_tpu_torch.model.vit import vit_forward
from trace_tpu_torch.parallel.collectives import (
    all_reduce,
    gather,
    group_rank,
    group_size,
    reduce_from_group,
)


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
    frames: torch.Tensor,          # [B, T, H, W, 3] CLIP-normalized, or [B, T, N, 3*p*p] patches
    frame_time_ids: torch.Tensor,  # [B, T, 6] local time-token ids per frame
    *,
    impl: str = "auto",
    remat_connector: bool = False,
    frame_group=None,
) -> torch.Tensor:
    """Frames -> interleaved visual + time token features [B, T*(S+6), D_lm].

    The ViT runs over ``vit_chunk_size`` frames at a time (sequentially,
    bounding its activations), then the connector of
    ``config.mm_projector_type`` runs. A per-frame connector (spatial_slot)
    pools each frame to S slots and each frame's 6 time-token embeddings
    follow its slots; a global-pooling one (slot, linear, mlpNx_gelu, the
    STC family) gives [B, S, D_lm] with no time tokens, returned as it is.

    The vision tower is frozen in every training stage: it runs under
    ``no_grad``, so nothing of it is kept for a backward. With
    ``remat_connector`` the connector runs under a checkpoint and its
    [B*T, 576, 1024] intermediates are recomputed from the ViT features in
    the backward.

    With ``frame_group`` (a mesh's 'model' group) the encode is
    frame-parallel: ``frames`` and ``frame_time_ids`` hold this rank's even
    share of each video's frames, the ViT runs on those, and its features
    and the time ids are gathered over the group before the connector, which
    runs on every frame on every rank."""
    B, T = frames.shape[:2]
    flat = frames.reshape((B * T,) + frames.shape[2:])
    chunk = config.vit_chunk_size

    def vit(x):
        return vit_forward(params["vision"], config.vision, x, impl=impl)

    with torch.no_grad():
        if chunk and flat.shape[0] > chunk and flat.shape[0] % chunk == 0:
            feats = torch.cat([vit(c) for c in flat.split(chunk)], dim=0)
        else:
            feats = vit(flat)
    feats = feats.reshape(B, T, feats.shape[1], feats.shape[2])
    if group_size(frame_group) > 1:
        feats = gather(feats, 1, frame_group)
        frame_time_ids = gather(frame_time_ids, 1, frame_group)
        T = feats.shape[1]

    _, connector = build_connector(config.mm_projector_type)
    if remat_connector and torch.is_grad_enabled():
        slots = checkpoint(connector, params["connector"], feats, use_reentrant=False)
    else:
        slots = connector(params["connector"], feats)
    if slots.ndim == 3:  # a global-pooling connector: no per-frame time tokens
        return slots
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
    has_video: Optional[torch.Tensor] = None,  # [B] bool; False = no span written
    tp_group=None,
) -> torch.Tensor:
    """Gather token embeddings and write the video span. [B, L, D].

    Rows with ``has_video`` False (text-only records) keep their token
    embeddings. Under autograd the span write sends its gradient to the video
    features and none to the table rows it overwrote. With ``tp_group`` and
    a text embedding sharded over the vocabulary (``runtime/mesh.py``), each
    rank looks up the ids of its rows and an all-reduce adds the ranks."""
    if table is None and group_size(tp_group) > 1 and (
            params["decoder"]["embed"].shape[0] < config.decoder.vocab_size):
        embeds = _sharded_lookup(params, config, token_ids, tp_group)
    else:
        if table is None:
            table = combined_embedding(params)
        embeds = table[token_ids.clamp(0, table.shape[0] - 1)]
    Tv = video_features.shape[1]
    has = has_video.tolist() if has_video is not None else [True] * embeds.shape[0]
    for b, pos in enumerate(video_pos.tolist()):
        if not has[b]:
            continue
        # dynamic_update_slice semantics: a span past the end is shifted in
        pos = max(0, min(pos, embeds.shape[1] - Tv))
        embeds[b, pos:pos + Tv] = video_features[b].to(embeds.dtype)
    return embeds


def _sharded_lookup(params: dict, config: TraceConfig, token_ids, group) -> torch.Tensor:
    """``combined_embedding(params)[ids]`` with the text rows sharded over
    ``group``: the towers' rows are whole on every rank."""
    emb = params["decoder"]["embed"]
    V, n = config.decoder.vocab_size, emb.shape[0]
    towers = torch.cat([params["towers"]["sync"], params["towers"]["time"],
                        params["towers"]["score"]], dim=0)
    ids = token_ids.clamp(0, V + towers.shape[0] - 1)
    lo = group_rank(group) * n
    mine = (ids >= lo) & (ids < lo + n)
    text = emb[(ids - lo).clamp(0, n - 1)] * mine[..., None].to(emb.dtype)
    text = reduce_from_group(text, group)
    rest = towers[(ids - V).clamp(min=0)]
    return torch.where((ids < V)[..., None], text, rest.to(text.dtype))


def encode_prefix_for_generation(
    params: dict,
    config: TraceConfig,
    token_ids: torch.Tensor,       # [B, L] combined ids with the video span
    video_pos: torch.Tensor,       # [B]
    frames: torch.Tensor,          # [B, T, H, W, 3], or [B, T, N, 3*p*p] patches
    frame_time_ids: torch.Tensor,  # [B, T, 6]
    *,
    table: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Inference prefix embeds: encode the video and splice it in."""
    feats = encode_video(params, config, frames, frame_time_ids, impl=impl)
    return build_input_embeds(params, config, token_ids, feats, video_pos,
                              table=table)


def three_stream_loss(
    dec_params: dict,
    c,
    hidden: torch.Tensor,        # [B, L, D] decoder output (final-normed)
    labels: torch.Tensor,        # [B, L] text-stream labels (or IGNORE_INDEX)
    time_labels: torch.Tensor,
    score_labels: torch.Tensor,
    *,
    chunk: int = 256,
    impl: str = "auto",
    tp_group=None,
    data_group=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Summed three-stream cross entropy (text + sync | time | score), in
    chunks of ``chunk`` positions, each under a checkpoint: the [B, L, 32027]
    fp32 logits never live whole, a chunk's are recomputed in the backward.
    hidden[t] predicts labels[t + 1]. Chunking is exact: the softmax is per
    position; sums and counts add up in fp32 / integers and normalise once,
    ``sums / max(counts, 1)`` per stream. Under a mesh the logits come
    whole from a vocab-sharded ``lm_head`` (``tp_group``), and the sums and
    counts add up over ``data_group`` before they divide: every rank's loss
    is the global batch's."""
    B, L, D = hidden.shape
    v = c.vocab_size
    h = hidden[:, :-1]
    labs = torch.stack([labels[:, 1:], time_labels[:, 1:], score_labels[:, 1:]])
    slices = (
        (0, v + 1),                                       # text + sync
        (v + 1, c.time_vocab_size),                       # time
        (v + 1 + c.time_vocab_size, c.score_vocab_size),  # score
    )

    def body(h_c, lab_c):
        logits = compute_logits(dec_params, h_c, impl=impl, tp_group=tp_group,
                                vocab_size=v)  # [B, C, CV] fp32
        sums = []
        for s, (off, width) in enumerate(slices):
            lab = lab_c[s]
            valid = lab != IGNORE_INDEX
            logp = torch.log_softmax(logits[..., off:off + width], dim=-1)
            nll = -logp.gather(-1, torch.where(valid, lab, 0)[..., None].long())[..., 0]
            sums.append(torch.where(valid, nll, 0.0).sum())
        return torch.stack(sums)

    sums = torch.zeros(3, dtype=torch.float32, device=hidden.device)
    counts = torch.zeros(3, dtype=torch.int64, device=hidden.device)
    for start in range(0, L - 1, chunk):
        h_c, lab_c = h[:, start:start + chunk], labs[:, :, start:start + chunk]
        if torch.is_grad_enabled():
            sums = sums + checkpoint(body, h_c, lab_c, use_reentrant=False)
        else:
            sums = sums + body(h_c, lab_c)
        counts += (lab_c != IGNORE_INDEX).sum(dim=(1, 2))
    sums, counts = reduce_from_group(sums, data_group), all_reduce(counts, data_group)
    losses = sums / counts.clamp_min(1)
    return losses[0], losses[1], losses[2]


def forward_train(
    params: dict,
    config: TraceConfig,
    batch: dict,
    *,
    remat: bool = True,
    impl: str = "auto",
    mesh=None,
    pp_mesh=None,
    pp_microbatches: int = 1,
) -> Tuple[torch.Tensor, dict]:
    """Training forward: the summed three-stream loss and its parts.

    ``batch`` keys (tensors on the params' device): frames [B,T,H,W,3]
    CLIP-normalized, frame_time_ids [B,T,6], token_ids [B,L], video_pos [B],
    attn_mask [B,L] bool, labels / time_labels / score_labels [B,L] (ids or
    IGNORE_INDEX), and optionally has_video [B] bool.

    The decoder's attention runs forward and backward through
    ``flash_attention_trainable``; with ``remat`` each decoder layer and the
    connector keep only their inputs for the backward. The vision tower is
    frozen. A quantized tree does not train.

    ``mesh`` (``runtime/mesh.py build_mesh``): ``batch`` holds this rank's
    'data' rows with all their frames and ``params`` its shards
    (``shard_params``). The ViT runs on the rank's share of the frames
    (frame-parallel over 'model'), the decoder and the heads
    tensor-parallel, and the loss is the global batch's.
    ``pp_mesh`` (``parallel/pipeline.py build_pp_mesh``): the decoder runs
    as a GPipe pipeline of ``pp_microbatches`` microbatches over its
    stages; the rest of the model is whole on every rank."""
    dec = params["decoder"]
    if is_quantized(dec["lm_head"]) or any(is_quantized(v) for v in dec["layers"].values()):
        raise ValueError("forward_train needs dense decoder weights, not a quantized tree")
    if mesh is not None and pp_mesh is not None:
        raise ValueError("a mesh and a pipeline mesh together are not supported")
    tp = mesh.group("model") if mesh is not None else None
    data = mesh.group("data") if mesh is not None else None
    frames, frame_ids = batch["frames"], batch["frame_time_ids"]
    if group_size(tp) > 1:  # this rank's share of each video's frames
        m, n = group_size(tp), frames.shape[1] // group_size(tp)
        if frames.shape[1] % m:
            raise ValueError(f"{frames.shape[1]} frames do not divide over 'model' ({m})")
        frames = frames[:, group_rank(tp) * n:(group_rank(tp) + 1) * n]
        frame_ids = frame_ids[:, group_rank(tp) * n:(group_rank(tp) + 1) * n]
    video_feats = encode_video(
        params, config, frames, frame_ids,
        impl=impl, remat_connector=remat, frame_group=tp)
    embeds = build_input_embeds(
        params, config, batch["token_ids"], video_feats, batch["video_pos"],
        has_video=batch.get("has_video"), tp_group=tp)
    mask = batch["attn_mask"].bool()
    positions = (mask.long().cumsum(dim=1) - 1).clamp_min(0)
    if pp_mesh is not None:
        from trace_tpu_torch.parallel.pipeline import pp_decoder_forward

        hidden = pp_decoder_forward(
            dec, config.decoder, embeds, mask, positions, mesh=pp_mesh,
            num_microbatches=pp_microbatches, remat=remat, impl=impl)
    else:
        hidden, _ = decoder_forward(
            dec, config.decoder, embeds, mask, positions,
            remat=remat, trainable=True, impl=impl, tp_group=tp)
    text_loss, time_loss, score_loss = three_stream_loss(
        dec, config.decoder, hidden,
        batch["labels"], batch["time_labels"], batch["score_labels"], impl=impl,
        tp_group=tp, data_group=data)
    loss = text_loss + time_loss + score_loss
    return loss, {"loss": loss, "text_loss": text_loss, "time_loss": time_loss,
                  "score_loss": score_loss}
