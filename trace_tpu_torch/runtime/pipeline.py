"""End-to-end inference: frames -> event triplets (the rgb serving path of
trace_tpu/runtime/pipeline.py).

  tokenize + preprocess on the device -> ViT + connector + splice
  -> prefill + FSM decode -> shared structured event decoder.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from trace_tpu_torch import conversation as conv
from trace_tpu_torch.constants import MODAL_TOKEN_INDEX
from trace_tpu_torch.model.config import TraceConfig
from trace_tpu_torch.model.towers import frame_time_tokens
from trace_tpu_torch.model.trace_model import (
    combined_embedding,
    encode_prefix_for_generation,
    tokens_per_frame,
)
from trace_tpu_torch.model.vit import fuse_vision_qkv
from trace_tpu_torch.runtime import generate as gen
from trace_tpu_torch.tokenizers.event_codec import (
    EventPredictions,
    decode_event_stream,
)
from trace_tpu_torch.tokenizers.text import TextTokenizer, splice_modal_tokens
from trace_tpu_torch.video.preprocess import preprocess_frames


def expand_prompt_ids(
    spliced_ids: Sequence[int],
    num_video_tokens: int,
    text_vocab_size: int,
) -> tuple[np.ndarray, int]:
    """Sentinel-spliced prompt ids -> combined-space ids + video span start.

    Exactly one VIDEO/IMAGE sentinel, expanded to ``num_video_tokens``
    placeholder positions (id 0, overwritten by the feature splice); SYNC
    sentinels become the combined sync id (= text_vocab_size)."""
    video_positions = [
        i for i, t in enumerate(spliced_ids)
        if t in (MODAL_TOKEN_INDEX["VIDEO"], MODAL_TOKEN_INDEX["IMAGE"])
    ]
    assert len(video_positions) == 1, "only have one video inputs!"
    vp = video_positions[0]

    out: list[int] = []
    for i, t in enumerate(spliced_ids):
        if i == vp:
            out.extend([0] * num_video_tokens)
        elif t == MODAL_TOKEN_INDEX["SYNC"]:
            out.append(text_vocab_size)
        else:
            assert t >= 0, f"unexpected sentinel {t} in inference prompt"
            out.append(int(t))
    return np.asarray(out, np.int32), vp


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TracePipeline:
    """Owns params + config + tokenizer; runs single or batched video
    inference on ``device`` (default: the CUDA card, which must exist).

    ``attn_impl="plain"`` runs the plain PyTorch version of every attention
    kernel on the card instead of the kernel: it exists to compare the two,
    and no serving path sets it. At first use the combined input-embedding
    table is built, the decoder's own embedding is dropped and the ViT's
    q/k/v weights are fused. ``last_stats`` holds the phase times of the
    last request."""

    def __init__(self, params: dict, config: TraceConfig,
                 tokenizer: TextTokenizer, *, device=None,
                 attn_impl: str = "auto"):
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TracePipeline: no CUDA device; pass device='cpu' explicitly "
                "to run on the CPU")
        self.device = device
        self.params = params
        self.config = config
        self.tokenizer = tokenizer
        self.attn_impl = attn_impl
        self._combined = None
        self._encode_params = None
        self._decoder_params = None
        self.last_stats: Optional[dict] = None

    def _prepare_memory_layout(self):
        if self._combined is not None:
            return
        params = _to_device(self.params, self.device)
        self._combined = combined_embedding(params)
        decoder = dict(params["decoder"])
        decoder.pop("embed", None)
        self._decoder_params = decoder
        self._encode_params = {k: v for k, v in params.items() if k != "decoder"}
        self._encode_params["vision"] = fuse_vision_qkv(self._encode_params["vision"])
        self.params = {**params, "decoder": decoder,
                       "vision": self._encode_params["vision"]}

    def _prepare_sample_host(self, frames_u8, ts, instruction, template="llama_2"):
        """The events path's sample prep (rgb upload): the JAX package's
        host paths for yuv420 and for frames larger than the ViT input use
        cv2, which the port does not carry."""
        cfg = self.config
        if cfg.upload_format != "rgb":
            raise NotImplementedError(
                f"upload_format={cfg.upload_format!r}: the yuv420 upload needs "
                "the cv2 host path, which the port does not carry; use 'rgb'")
        S = cfg.vision.image_size
        H0, W0 = frames_u8.shape[1], frames_u8.shape[2]
        if H0 * W0 > int(1.3 * S * S):
            raise NotImplementedError(
                f"frames of {H0}x{W0}: frames larger than the ViT input are "
                "downscaled on the host with cv2, which the port does not carry")
        return self._sample(frames_u8, ts, instruction, template)

    def _sample(self, frames_u8, ts, instruction, template, append_sync=True):
        """Tokenize the prompt, build the time ids, and preprocess the frames
        on the device."""
        cfg = self.config
        prompt = conv.build_trace_prompt(instruction, template_name=template,
                                         append_sync=append_sync)
        spliced = splice_modal_tokens(prompt, self.tokenizer)
        T = frames_u8.shape[0]
        token_ids, video_pos = expand_prompt_ids(
            spliced, T * tokens_per_frame(cfg), cfg.decoder.vocab_size)
        frames = preprocess_frames(
            torch.as_tensor(np.asarray(frames_u8)).to(self.device),
            cfg.vision.image_size, aspect_ratio=cfg.image_aspect_ratio,
        ).to(cfg.dtype)
        return token_ids, video_pos, frames, frame_time_tokens(ts)

    def _encode_prepared(self, per_sample: list):
        """Stack prepared samples (prompts LEFT-padded to a common length)
        and run the encode: ViT + connector + splice."""
        L = max(len(s[0]) for s in per_sample)
        B = len(per_sample)
        token_ids = np.zeros((B, L), np.int64)
        video_pos = np.zeros((B,), np.int64)
        mask = np.zeros((B, L), bool)
        for b, (ids, vp, _, _) in enumerate(per_sample):
            pad = L - len(ids)
            token_ids[b, pad:] = ids
            video_pos[b] = vp + pad
            mask[b, pad:] = True
        dev = self.device
        frames = torch.stack([s[2] for s in per_sample])
        time_ids = torch.from_numpy(np.stack([s[3] for s in per_sample])).to(dev)
        prefix = encode_prefix_for_generation(
            self._encode_params, self.config,
            torch.from_numpy(token_ids).to(dev), torch.from_numpy(video_pos),
            frames, time_ids,
            table=self._combined, impl=self.attn_impl,
        )
        return prefix, torch.from_numpy(mask).to(dev)

    def encode_prefix(self, frames_u8_list, timestamps_list, instructions,
                      template: str = "llama_2"):
        """Batch of videos -> (prefix_embeds [B, L, D], mask [B, L])."""
        self._prepare_memory_layout()
        per_sample = [
            self._prepare_sample_host(f, ts, q, template)
            for f, ts, q in zip(frames_u8_list, timestamps_list, instructions)
        ]
        return self._encode_prepared(per_sample)

    def infer_events_from_frames(self, frames_u8, video_timestamps, instruction,
                                 **kw) -> EventPredictions:
        return self.infer_events_batch(
            [frames_u8], [video_timestamps], [instruction], **kw)[0]

    def infer_events_batch(
        self,
        frames_u8_list: Sequence[np.ndarray],
        timestamps_list: Sequence[Sequence],
        instructions: Sequence[str],
        *,
        max_new_tokens: int = 1024,
        temperature: float = 0.0,
        template: str = "llama_2",
        seed: int = 0,
    ) -> list[EventPredictions]:
        """Batched multi-video event inference: one prefill and one decode
        loop for the whole batch."""
        t0 = time.perf_counter()
        prefix, mask = self.encode_prefix(
            frames_u8_list, timestamps_list, instructions, template)
        _sync(self.device)
        encode_s = time.perf_counter() - t0
        out = gen.generate(
            self._decoder_params, self.config.decoder, prefix, mask,
            self._combined,
            max_new_tokens=max_new_tokens,
            initial_head=1,  # the prompt ends with <sync>
            temperature=temperature,
            eos_id=self.tokenizer.eos_token_id,
            seed=seed, impl=self.attn_impl,
        )
        self.last_stats = {
            "encode_s": encode_s, **out.phase_times,
            "decode_steps": out.decode_steps,
            "prefix_tokens": int(mask.sum(dim=1).max()),
            "tokens": out.tokens,
        }
        detok = lambda ids: self.tokenizer.decode(ids, skip_special_tokens=True)
        results = []
        for b in range(len(frames_u8_list)):
            ids = [int(t) for t in out.tokens[b] if t != gen.PAD_OUTPUT_ID]
            results.append(decode_event_stream(
                ids, detok, text_vocab_size=self.config.decoder.vocab_size))
        return results

    def infer_text(
        self,
        frames_u8: np.ndarray,
        video_timestamps: Sequence,
        instruct: str,
        *,
        max_new_tokens: int = 1024,
        temperature: float = 0.0,
        template: str = "llama_2",
        seed: int = 0,
    ) -> str:
        """Plain captioning / QA: no <sync> suffix, text head from the
        start, free-form text out; the template's stop string ends the turn."""
        self._prepare_memory_layout()
        cfg = self.config
        prefix, mask = self._encode_prepared([self._sample(
            frames_u8, video_timestamps, instruct, template, append_sync=False)])
        stop = conv.get_template(template).stop_str
        stop_seqs = None
        if stop and stop != getattr(self.tokenizer, "eos_token", None):
            ids = list(self.tokenizer.encode(stop))
            if ids and ids[0] == getattr(self.tokenizer, "bos_token_id", None):
                ids = ids[1:]
            stop_seqs = [ids]
        out = gen.generate(
            self._decoder_params, cfg.decoder, prefix, mask, self._combined,
            max_new_tokens=max_new_tokens, initial_head=0,
            temperature=temperature, eos_id=self.tokenizer.eos_token_id,
            seed=seed, stop_sequences=stop_seqs, impl=self.attn_impl,
        )
        text_ids = [int(t) for t in out.tokens[0] if 0 <= int(t) < cfg.decoder.vocab_size]
        text = self.tokenizer.decode(text_ids, skip_special_tokens=True).strip()
        if stop and stop != getattr(self.tokenizer, "eos_token", None):
            text = text.split(stop)[0].strip()
        return text


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
