"""End-to-end inference: frames -> event triplets (trace_tpu/runtime/
pipeline.py), in the bf16, the int8, the int4 or the int4p serving
configuration (``model/quantize.py int8_serving`` / ``int4_serving`` /
``int4p_serving``), with rgb or yuv420 frame upload.

  host: tokenize, downscale frames larger than the ViT input, I420 of the
  content band (video/preprocess.py, numpy) -> upload -> device: I420 to
  patches (or rgb preprocess) -> ViT + connector + splice -> prefill + FSM
  decode -> shared structured event decoder.

``model_init`` loads a TRACE checkpoint dir into a pipeline on the card;
``infer_events`` reads a video file (``video/io.py``) and runs one request.
``infer_events_batch`` runs one batch; ``infer_events_corpus`` runs a corpus
the way the bench serves it: producer threads prepare and upload the next
encode batches while the current one encodes, prefixes collect into
decode-batch stores, and each decode chunk prefills in sub-batches into one
reused KV arena and decodes (``runtime/generate.py generate_split``), after
the encode phase or, streamed, on a decode thread while later chunks encode.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from trace_tpu_torch import conversation as conv
from trace_tpu_torch.constants import MODAL_TOKEN_INDEX
from trace_tpu_torch.model.config import TraceConfig
from trace_tpu_torch.model.quantize import (
    MIXTRAL_NOT_QUANTIZED,
    fuse_decoder_serving,
    int4_serving,
    int4p_serving,
    int8_serving,
)
from trace_tpu_torch.model.towers import frame_time_tokens
from trace_tpu_torch.model.trace_model import (
    build_input_embeds,
    combined_embedding,
    encode_prefix_for_generation,
    encode_video,
    tokens_per_frame,
)
from trace_tpu_torch.model.vit import extract_patches, fuse_vision_qkv
from trace_tpu_torch.runtime import generate as gen
from trace_tpu_torch.tokenizers.event_codec import (
    EventPredictions,
    decode_event_stream,
)
from trace_tpu_torch.tokenizers.text import TextTokenizer, splice_modal_tokens
from trace_tpu_torch.video import preprocess as pre
from trace_tpu_torch.video.io import load_video_frames


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


def encode_prefix_sharded(
    params: dict,
    config: TraceConfig,
    token_ids,          # [B, L] combined-space ids
    video_pos,          # [B]
    frames,             # [B, T, S, S, 3] CLIP-normalized, or [B, T, N, 3*p*p] patches
    frame_time_ids,     # [B, T, 6]
    table,              # [CV, D] combined embedding
    mesh,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """Frame-parallel prefix encode over a mesh (``runtime/mesh.py``).

    Every rank passes the same global batch. Its rows go over 'data' and
    each video's frames over 'model' (``shard_batch``): a rank's ViT encodes
    its share of the frames, unchunked, with the vision weights whole on
    every rank; the features are gathered over 'model', the connector and
    the splice run on the whole prefix of the rank's rows, and the rows are
    gathered over 'data', so every rank returns the whole [B, L, D]."""
    from trace_tpu_torch.parallel.collectives import gather
    from trace_tpu_torch.runtime.mesh import shard_batch

    cfg = dataclasses.replace(config, vit_chunk_size=0)
    batch = shard_batch({"token_ids": token_ids, "video_pos": video_pos, "frames": frames,
                         "frame_time_ids": frame_time_ids}, mesh)
    feats = encode_video(params, cfg, batch["frames"], batch["frame_time_ids"], impl=impl,
                         frame_group=mesh.group("model"))
    prefix = build_input_embeds(params, cfg, batch["token_ids"], feats, batch["video_pos"],
                                table=table.to(mesh.device))
    return gather(prefix, 0, mesh.group("data"))


@dataclasses.dataclass
class PreparedSampleNP:
    """A sample prepared on the host alone: numpy and python leaves, no
    tensors. Made by ``TracePipeline.prepare_sample_host_np``; an
    ``infer_events_corpus`` ``load_item`` may return it, and the corpus
    uploads it when it consumes it. A corpus runner thus pays the host work
    (downscale, I420, tokenize) outside a timed window while the bytes
    uploaded and the device work stay those of an unprepared item."""

    token_ids: object
    video_pos: object
    frames_spec: object
    time_ids: object
    timestamps: object


def _frames_tag(f) -> Optional[str]:
    return f[0] if isinstance(f, tuple) and f and isinstance(f[0], str) else None


class TracePipeline:
    """Owns params + config + tokenizer; runs single or batched video
    inference on ``device`` (default: the CUDA card, which must exist).

    ``attn_impl="plain"`` runs the plain PyTorch version of every kernel
    (attention, quantized weight products) on the card instead of the kernel: it
    exists to compare the two, and no serving path sets it. At first use the
    combined input-embedding table is built, the decoder's own embedding is
    dropped, a dense ViT's q/k/v weights are fused, and an int8 or int4p
    decoder tree is put into the fused serving layout. ``last_stats`` holds the phase times of the
    last request, ``last_corpus_stats`` those of the last corpus."""

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
        self.last_corpus_stats: Optional[dict] = None

    def _prepare_memory_layout(self):
        if self._combined is not None:
            return
        params = _to_device(self.params, self.device)
        self._combined = combined_embedding(params)
        decoder = dict(params["decoder"])
        decoder.pop("embed", None)
        decoder = fuse_decoder_serving(decoder)  # as it is unless quantized and unfused
        self._decoder_params = decoder
        self._encode_params = {k: v for k, v in params.items() if k != "decoder"}
        self._encode_params["vision"] = fuse_vision_qkv(self._encode_params["vision"])
        self.params = {**params, "decoder": decoder,
                       "vision": self._encode_params["vision"]}

    def _tokenize(self, instruction: str, template: str, num_frames: int,
                  append_sync: bool = True):
        """The prompt's combined-space ids and the video span's start."""
        cfg = self.config
        prompt = conv.build_trace_prompt(instruction, template_name=template,
                                         append_sync=append_sync)
        spliced = splice_modal_tokens(prompt, self.tokenizer)
        return expand_prompt_ids(spliced, num_frames * tokens_per_frame(cfg),
                                 cfg.decoder.vocab_size)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the pipeline's device (on the card through pinned
        memory, ordered on the current stream)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _prepare_frames(self, frames_u8: np.ndarray, defer_preprocess=False,
                        as_numpy=False):
        """Host side of a sample's frames (no tokenizer: callable from
        producer threads). Frames larger than 1.3 S^2 are downscaled on the
        host first. With ``upload_format="yuv420"``, a pad-aspect config and
        S % 4 == 0, the I420 content band is uploaded (the band-only
        downscale where the frame is landscape) and turned into ViT patches
        on the device (``i420_band_to_patches``; pixels when the patch does
        not divide S); otherwise the rgb frames are preprocessed on the
        device.

        ``defer_preprocess`` keeps the uploaded uint8 payload as a tagged
        tuple that ``_encode_prepared`` resolves: "yuv_band_p" / "yuv_band"
        (band, top, left, fill colour, S[, patch]) or "yuv_full" (I420 of
        the whole S x S frame); a queued video then holds its uint8 band on
        the device, not its normalised frames. ``as_numpy`` (with
        ``defer_preprocess``) uploads nothing: the payload stays numpy, and
        the rgb route becomes ("raw_np", frames) for ``_upload_prepared``."""
        if as_numpy and not defer_preprocess:
            raise ValueError("as_numpy requires defer_preprocess=True")
        dev_a = (lambda x: x) if as_numpy else self._upload
        cfg = self.config
        S = cfg.vision.image_size
        H0, W0 = frames_u8.shape[1], frames_u8.shape[2]
        band_fast = None  # (band_u8, top, left) of the band-only downscale
        if H0 * W0 > int(1.3 * S * S):
            if (cfg.upload_format == "yuv420" and cfg.image_aspect_ratio == "pad"
                    and S % 4 == 0):
                band_fast = pre.host_downscale_band(frames_u8, S)
            if band_fast is None:
                frames_u8 = pre.host_downscale(frames_u8, S, cfg.image_aspect_ratio)
        if band_fast is None and not (
                cfg.upload_format == "yuv420" and frames_u8.shape[1] == S
                and frames_u8.shape[2] == S and S % 4 == 0):
            if as_numpy:
                return ("raw_np", np.ascontiguousarray(frames_u8))
            return pre.preprocess_frames(
                self._upload(np.asarray(frames_u8)), S,
                aspect_ratio=cfg.image_aspect_ratio).to(cfg.dtype)
        top, h, left, w = (pre.content_band(H0, W0, S) if cfg.image_aspect_ratio == "pad"
                           else (0, S, 0, S))
        # straight to patches (planar) whenever the ViT grid divides the canvas
        patch = cfg.vision.patch_size if S % cfg.vision.patch_size == 0 else None
        if band_fast is not None and (h, w) == (S, S):
            # near-square landscape: the "band" is the whole canvas
            frames_u8, band_fast = band_fast[0], None
        if (h, w) != (S, S):
            if band_fast is not None:
                band, top, left = band_fast
            else:  # only the rows/cols that are not the uniform pad
                band = frames_u8[:, top:top + h, left:left + w]
        else:
            band, top, left = frames_u8, 0, 0
        yuv = dev_a(pre.rgb_to_i420_np(np.ascontiguousarray(band)))
        fill = dev_a(pre.i420_fill_rgb01(pre.pad_fill_u8()))
        if patch:
            spec = ("yuv_band_p", yuv, top, left, fill, S, patch)
        elif (h, w) != (S, S):
            spec = ("yuv_band", yuv, top, left, fill, S)
        else:
            spec = ("yuv_full", yuv)
        return spec if defer_preprocess else self._resolve_frames(spec)

    def _resolve_frames(self, f):
        """A tagged yuv payload -> device frames (patches [T, N, 3*p*p] or
        pixels [T, S, S, 3]) in the config's dtype; anything else as it is."""
        dt = self.config.dtype
        tag = _frames_tag(f)
        if tag == "yuv_band_p":
            return pre.i420_band_to_patches(*f[1:], out_dtype=dt)
        if tag == "yuv_band":
            return pre.preprocess_yuv_band(*f[1:], out_dtype=dt)
        if tag == "yuv_full":
            return pre.preprocess_yuv(f[1], out_dtype=dt)
        return f

    def _prepare_sample_host(self, frames_u8, ts, instruction, template="llama_2",
                             defer_preprocess=False, as_numpy=False):
        """A sample for ``_encode_prepared``: (token ids, video span start,
        frames, time ids). Tokenizes (so it runs on the calling thread: the
        tokenizers are not thread-safe) and prepares the frames
        (``_prepare_frames``)."""
        token_ids, video_pos = self._tokenize(instruction, template, frames_u8.shape[0])
        frames = self._prepare_frames(frames_u8, defer_preprocess, as_numpy)
        return token_ids, video_pos, frames, frame_time_tokens(ts)

    def prepare_sample_host_np(self, frames_u8, ts, instruction,
                               template="llama_2") -> PreparedSampleNP:
        """Host-only sample prep (tokenize, downscale, RGB -> I420) with numpy
        outputs and no device work, for a corpus runner to do before its
        timed window; ``infer_events_corpus`` uploads it when it consumes it."""
        t, v, f, ti = self._prepare_sample_host(
            frames_u8, ts, instruction, template,
            defer_preprocess=True, as_numpy=True)
        return PreparedSampleNP(t, v, f, ti, list(ts))

    def _upload_prepared(self, ps: PreparedSampleNP):
        """PreparedSampleNP -> the sample tuple ``_encode_prepared`` takes:
        the frame payload uploaded (the rgb route also preprocessed). No
        tokenizer: callable from producer threads."""
        f = ps.frames_spec
        tag = _frames_tag(f)
        if tag in ("yuv_band_p", "yuv_band"):
            f = (tag, self._upload(f[1]), f[2], f[3], self._upload(f[4])) + f[5:]
        elif tag == "yuv_full":
            f = (tag, self._upload(f[1]))
        elif tag == "raw_np":
            cfg = self.config
            f = pre.preprocess_frames(self._upload(f[1]), cfg.vision.image_size,
                                      aspect_ratio=cfg.image_aspect_ratio).to(cfg.dtype)
        return (ps.token_ids, ps.video_pos, f, ps.time_ids)

    @staticmethod
    def _prompt_layout(per_sample: list):
        """The samples' prompts LEFT-padded to a common length: (token ids
        [B, L], video span starts [B], mask [B, L]) in numpy."""
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
        return token_ids, video_pos, mask

    def _encode_prepared(self, per_sample: list):
        """Stack prepared samples (``_prompt_layout``) and run the encode:
        ViT + connector + splice. Tagged payloads are resolved here; in a
        batch that mixes patches and pixels the pixel samples are cut into
        patches."""
        token_ids, video_pos, mask = self._prompt_layout(per_sample)
        cfg = self.config
        resolved = [self._resolve_frames(s[2]) for s in per_sample]
        if len({r.ndim for r in resolved}) > 1:
            resolved = [r if r.ndim == 3
                        else extract_patches(r, cfg.vision.patch_size).to(cfg.dtype)
                        for r in resolved]
        frames = torch.stack(resolved)
        del resolved
        prefix = encode_prefix_for_generation(
            self._encode_params, cfg, self._upload(token_ids), torch.from_numpy(video_pos),
            frames, self._upload(np.stack([s[3] for s in per_sample])),
            table=self._combined, impl=self.attn_impl,
        )
        return prefix, self._upload(mask)

    def encode_prefix(self, frames_u8_list, timestamps_list, instructions,
                      template: str = "llama_2"):
        """Batch of videos -> (prefix_embeds [B, L, D], mask [B, L])."""
        self._prepare_memory_layout()
        per_sample = [
            self._prepare_sample_host(f, ts, q, template)
            for f, ts, q in zip(frames_u8_list, timestamps_list, instructions)
        ]
        return self._encode_prepared(per_sample)

    def infer_events(self, video_path: str, instruction: str, *,
                     num_frames: Optional[int] = None, **kw) -> EventPredictions:
        """Single-video causal event inference from a video file
        (``video/io.py load_video_frames``, ``num_frames`` default the
        config's); ``kw`` as ``infer_events_batch``."""
        frames_u8, timestamps = load_video_frames(
            video_path, num_frames or self.config.num_frames)
        return self.infer_events_from_frames(frames_u8, timestamps, instruction, **kw)

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
        ids, vp = self._tokenize(instruct, template, frames_u8.shape[0], append_sync=False)
        frames = pre.preprocess_frames(
            self._upload(np.asarray(frames_u8)), cfg.vision.image_size,
            aspect_ratio=cfg.image_aspect_ratio).to(cfg.dtype)
        prefix, mask = self._encode_prepared(
            [(ids, vp, frames, frame_time_tokens(video_timestamps))])
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

    def infer_events_corpus(
        self,
        load_item,                      # idx -> (frames_u8, timestamps, instruction)
        num_items: int,                 #        or a PreparedSampleNP
        *,
        encode_batch: int = 2,
        decode_batch: int = 4,
        max_new_tokens: int = 512,
        temperature: float = 0.0,
        template: str = "llama_2",
        seed: int = 0,
        constrain_time: bool = False,
        offload_vision: Optional[bool] = None,
        prefill_batch: Optional[int] = None,
        producer_threads: int = 4,
        prefetch_batches: int = 6,
        token_budget: Optional[int] = None,
        prewarm_compiles: bool = True,
        streamed: bool = False,
    ) -> list[EventPredictions]:
        """Corpus inference: encode every video in batches of
        ``encode_batch`` (producer threads load, prepare and upload up to
        ``prefetch_batches`` batches ahead), then decode in chunks of
        ``decode_batch`` videos.

        ``prefill_batch`` < ``decode_batch`` runs the serving split: each
        encoded prefix row goes straight into its chunk's store
        [chunk, L_bucket, D] (left-padded to the bucket of the first encode
        batch), a chunk prefills in ``prefill_batch``-row sub-batches into
        one KV arena that every chunk reuses (allocated before the first
        encode) and decodes at the full batch (``generate_split``).
        ``prefill_batch=None`` picks 2 for ``decode_batch`` >= 32 and 4 above
        8; 0 forces the monolithic ``generate``. A later prompt longer than
        the bucket sends its chunk back to per-video rows. ``streamed`` (split
        mode only) prefills and decodes each completed chunk on one decode
        thread while later chunks encode; at most two chunks wait for it.
        ``token_budget`` sizes the arena for that many new tokens while each
        chunk stops at ``max_new_tokens``. ``constrain_time`` restricts time
        values to the frames' timestamps.

        On the card the producer threads queue their uploads on the
        caller's current stream, where the encode runs. The streamed decode
        thread runs on a stream of its own, so that its steps, each of which
        reads ``done`` back, do not wait behind queued encode work: it waits
        on an event recorded after its chunk's last store write, marks the
        store and the arena as used on its stream (``record_stream``), and
        the caller's stream waits for it before anything after the encode
        phase. The tokenizer runs on the calling thread only (raw items are
        tokenized when consumed, outputs detokenized at the end): the
        tokenizers are not thread-safe.

        ``offload_vision`` and ``prewarm_compiles`` are accepted so callers
        of the JAX package port unchanged, and do nothing here: the first
        parks the vision tower on the host between the phases, which a 16 GB
        TPU needed next to bf16 weights and an 80 GB card does not; the
        second compiles XLA programs during the encode phase, and eager
        PyTorch compiles nothing. ``last_corpus_stats`` holds the phase
        times, as the JAX package reports them."""
        del offload_vision, prewarm_compiles
        if prefill_batch is None and decode_batch > 8:
            prefill_batch = 2 if decode_batch >= 32 else 4
        elif prefill_batch == 0:
            prefill_batch = None
        self._prepare_memory_layout()
        cfg = self.config
        dev = self.device
        D = cfg.decoder.hidden_size
        split_mode = bool(prefill_batch and prefill_batch < decode_batch)
        streamed_mode = bool(streamed and split_mode)
        budget = max(max_new_tokens, token_budget or 0)
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        # the streamed decode thread's own stream
        dstream = torch.cuda.Stream(dev) if streamed_mode and stream is not None else None
        batches = [list(range(s, min(s + encode_batch, num_items)))
                   for s in range(0, num_items, encode_batch)]
        n_chunks = -(-num_items // decode_batch)

        def on_stream(fn, st):
            """fn run with stream ``st`` current (threads start on the
            default stream)."""
            if st is None:
                return fn

            def run(*a):
                with torch.cuda.stream(st):
                    return fn(*a)
            return run

        def used_on(st, tree) -> None:
            """Tensors of ``tree`` made on another stream, now used on
            ``st``: their memory is not reused before ``st`` is done."""
            for t in (tree.values() if isinstance(tree, dict) else tree):
                t.record_stream(st)

        def prepare_batch(idxs):
            """Producer thread: load and upload; raw items keep their
            instruction for the calling thread to tokenize."""
            out = []
            for i in idxs:
                item = load_item(i)
                if isinstance(item, PreparedSampleNP):
                    out.append((self._upload_prepared(item), item.timestamps, None))
                    continue
                f, ts, q = item
                frames = self._prepare_frames(f, defer_preprocess=True)
                out.append(((None, None, frames, frame_time_tokens(ts)), ts,
                            (q, f.shape[0])))
            return out

        lock = threading.Lock()  # the containers the decode thread shares
        prefixes: dict = {}   # video idx -> [L_i, D] row (non-split / overflow)
        masks: dict = {}      # video idx -> 1-D bool, len == its prefix row
        stores: dict = {}     # chunk -> [B_chunk, L_bucket, D]
        legacy_chunks: set = set()
        frame_ids: dict = {}
        tokens_by_idx: dict = {}
        decoded_chunks: set = set()
        acc = {"prefill_s": 0.0, "decode_loop_s": 0.0, "decode_wall": 0.0}
        arena_box = {"a": None}
        L_bucket = None

        def decode_chunk(c, written=None):
            """Prefill + decode one chunk: on the calling thread (two-phase)
            or the one decode thread (streamed; ``written``: the event after
            the chunk's store writes), never both at once."""
            t0 = time.perf_counter()
            chunk = list(range(c * decode_batch, min((c + 1) * decode_batch, num_items)))
            B = len(chunk)
            with lock:
                store = stores.pop(c, None)
                rows = None if store is not None else [prefixes.pop(i) for i in chunk]
                mrows = [masks[i] for i in chunk]
            if written is not None:
                cur = torch.cuda.current_stream(dev)
                cur.wait_event(written)
                used_on(cur, [store] if store is not None else [])
                if arena_box["a"] is not None and not arena_box.get("on_decode_stream"):
                    used_on(cur, arena_box["a"])
                    arena_box["on_decode_stream"] = True
            if store is not None:
                prefix = store
                mask = np.stack(mrows)
            else:
                # bucket to 128 so the generate wrappers add no pad of their own
                L = max(r.shape[0] for r in rows)
                L = max(128, -(-L // 128) * 128)
                mask = np.zeros((B, L), bool)
                prefix = torch.zeros((B, L, D), dtype=rows[0].dtype, device=dev)
                for b, (r, m) in enumerate(zip(rows, mrows)):
                    prefix[b, L - r.shape[0]:] = r
                    mask[b, L - len(m):] = m
                del rows
            del store
            fids = (self._upload(np.stack([frame_ids[i] for i in chunk]))
                    if constrain_time else None)
            kw = dict(max_new_tokens=max_new_tokens, initial_head=1,
                      temperature=temperature, eos_id=self.tokenizer.eos_token_id,
                      seed=seed, constrain_time=constrain_time, frame_time_ids=fids,
                      impl=self.attn_impl)
            prefix_ref = [prefix]  # generate frees the prefix once prefilled
            del prefix
            mask_t = self._upload(mask)
            if prefill_batch and prefill_batch < B:
                out = gen.generate_split(
                    self._decoder_params, cfg.decoder, prefix_ref, mask_t,
                    self._combined, prefill_batch=prefill_batch,
                    cache=arena_box["a"], time_phases=True,
                    token_budget=token_budget, **kw)
                arena_box["a"] = out.cache
                acc["prefill_s"] += out.phase_times["prefill_s"]
                acc["decode_loop_s"] += out.phase_times["decode_s"]
            else:
                out = gen.generate(self._decoder_params, cfg.decoder, prefix_ref,
                                   mask_t, self._combined, **kw)
            with lock:
                for b, i in enumerate(chunk):
                    tokens_by_idx[i] = out.tokens[b]
                decoded_chunks.add(c)
            acc["decode_wall"] += time.perf_counter() - t0

        decode_pool = ThreadPoolExecutor(max_workers=1) if streamed_mode else None
        pending: list = []
        next_stream_chunk = 0
        t_encode0 = time.perf_counter()
        done_encoding = None
        try:
            with ThreadPoolExecutor(max_workers=producer_threads) as pool:
                futures = [pool.submit(on_stream(prepare_batch, stream), b)
                           for b in batches[:prefetch_batches]]
                next_submit = len(futures)
                for bi, idxs in enumerate(batches):
                    while decode_pool is not None and len(pending) >= 2:
                        pending.pop(0).result()  # backpressure
                    prepared = futures[bi].result()
                    futures[bi] = None  # drop the future's hold on the uploads
                    per_sample = []
                    for sample, ts, ask in prepared:
                        if ask is not None:  # tokenize on the calling thread
                            ids, vp = self._tokenize(ask[0], template, ask[1])
                            sample = (ids, vp) + sample[2:]
                        per_sample.append(sample)
                    if split_mode and arena_box["a"] is None and L_bucket is None:
                        # the arena first, before prefix buffers spread over
                        # the card; sized from the first batch's prompts
                        L0 = max(len(s[0]) for s in per_sample)
                        L_bucket = max(128, -(-L0 // 128) * 128)
                        arena_box["a"] = gen.init_kv_cache(
                            cfg.decoder, decode_batch, L_bucket + budget,
                            dtype=cfg.dtype, device=dev)
                    if next_submit < len(batches):
                        futures.append(pool.submit(on_stream(prepare_batch, stream),
                                                   batches[next_submit]))
                        next_submit += 1
                    prefix, _ = self._encode_prepared(per_sample)
                    del prepared
                    mask_rows = self._prompt_layout(per_sample)[2]
                    L_enc = prefix.shape[1]
                    with lock:
                        if split_mode and L_enc > L_bucket:
                            # this batch overflows the bucket: its chunks fall
                            # back to per-video rows, taken out of their stores
                            for i in idxs:
                                c = i // decode_batch
                                if c in legacy_chunks:
                                    continue
                                legacy_chunks.add(c)
                                st = stores.pop(c, None)
                                if st is not None:
                                    for rr in range(st.shape[0]):
                                        j = c * decode_batch + rr
                                        if j < i:
                                            prefixes[j] = st[rr]
                        for b, i in enumerate(idxs):
                            c, r = divmod(i, decode_batch)
                            if not split_mode or c in legacy_chunks:
                                prefixes[i] = prefix[b]
                                masks[i] = mask_rows[b]
                                continue
                            if c not in stores:
                                Bc = min(decode_batch, num_items - c * decode_batch)
                                stores[c] = torch.zeros((Bc, L_bucket, D), dtype=cfg.dtype,
                                                        device=dev)
                            stores[c][r, L_bucket - L_enc:] = prefix[b]
                            masks[i] = np.pad(mask_rows[b], (L_bucket - L_enc, 0))
                        for b, i in enumerate(idxs):
                            frame_ids[i] = per_sample[b][3]
                    del prefix, per_sample
                    if stream is not None:
                        done_encoding = torch.cuda.Event()
                        done_encoding.record(stream)
                    if decode_pool is not None:
                        # chunks encode in index order: everything through
                        # this batch's last index is on the device
                        while ((next_stream_chunk + 1) * decode_batch - 1 <= idxs[-1]
                               and next_stream_chunk in stores
                               and next_stream_chunk not in legacy_chunks):
                            pending.append(decode_pool.submit(
                                on_stream(decode_chunk, dstream), next_stream_chunk,
                                done_encoding))
                            next_stream_chunk += 1
            # the encode phase ends when its last write is done
            if done_encoding is not None:
                done_encoding.synchronize()
            t_encode = time.perf_counter() - t_encode0
            for f in pending:
                f.result()
        finally:
            if decode_pool is not None:
                decode_pool.shutdown(wait=True)
            if dstream is not None:
                stream.wait_stream(dstream)
        if arena_box.get("on_decode_stream"):
            used_on(stream, arena_box["a"])  # the calling thread's chunks next

        t_decode0 = time.perf_counter()
        for c in range(n_chunks):
            if c not in decoded_chunks:
                decode_chunk(c)
        detok = lambda ids: self.tokenizer.decode(ids, skip_special_tokens=True)
        V = cfg.decoder.vocab_size
        results = [
            decode_event_stream([int(t) for t in tokens_by_idx[i] if t != gen.PAD_OUTPUT_ID],
                                detok, text_vocab_size=V)
            for i in range(num_items)
        ]
        self.last_corpus_stats = {
            "encode_s": round(t_encode, 3),
            "decode_s": round(acc["decode_wall"] if streamed_mode
                              else time.perf_counter() - t_decode0, 3),
            "streamed": streamed_mode,
            # split mode: the fenced prefill / decode loop times of the chunks
            "prefill_s": round(acc["prefill_s"], 3),
            "decode_loop_s": round(acc["decode_loop_s"], 3),
            "videos": num_items,
            # the longest real prefix (True mask positions, not the bucket)
            "prefix_tokens": max((int(np.asarray(m).sum()) for m in masks.values()),
                                 default=0),
        }
        return results


def model_init(model_path: str, *, vision_path: Optional[str] = None,
               dtype=torch.bfloat16, quant: str = "bf16", device=None,
               tokenizer: Optional[TextTokenizer] = None) -> TracePipeline:
    """A released TRACE checkpoint dir as a pipeline on ``device`` (default:
    the CUDA card, which must exist), as the JAX package's ``model_init``
    builds it (load_pretrained_model parity, reference model/builder.py:
    29-156): the merged layout through ``checkpoint.convert
    .convert_trace_checkpoint`` in ``dtype``, the CLIP tower bundled or from
    ``vision_path``.

    ``quant="int8"`` / ``"int4p"`` quantize the decoder alone, on the host
    before the upload (int8 per output channel; nibble-packed int4 with
    group-128 scales), fuse it into the serving layout, and set the int8 KV
    cache and ``act_quant``; the ViT stays in ``dtype`` (``int8_serving`` with
    ``vision=True`` is the bench's configuration, not this one). ``"int4"``
    is the JAX package's native-int4 configuration (``int4_serving``): the
    decoder per output channel to [-7, 7], nibble-packed per channel on the
    host, fused, the int8 KV cache, weight-only (no ``act_quant``). A Mixtral
    checkpoint serves in bf16 alone (the dense mixture): another ``quant``
    raises ``ValueError`` from its ``config.json``, before any weight is read
    (``model/quantize.py MIXTRAL_NOT_QUANTIZED``).

    ``tokenizer``: a tokenizer object to use in place of the checkpoint's own
    (which ``load_hf_tokenizer`` reads with ``transformers``). The tree is
    on the device when this returns."""
    from trace_tpu_torch.checkpoint.convert import (
        convert_trace_checkpoint,
        read_hf_config,
        trace_config_from_hf,
    )
    from trace_tpu_torch.model.config import MoEConfig
    from trace_tpu_torch.tokenizers.text import load_hf_tokenizer

    if quant not in ("bf16", "int8", "int4", "int4p"):
        raise ValueError(f"quant must be bf16, int8, int4 or int4p, got {quant!r}")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("model_init: no CUDA device; pass device='cpu' to run on the CPU")
    if quant != "bf16" and isinstance(trace_config_from_hf(read_hf_config(model_path)).decoder,
                                      MoEConfig):
        raise ValueError(MIXTRAL_NOT_QUANTIZED)
    if tokenizer is None:
        tokenizer = load_hf_tokenizer(model_path)
    params, config = convert_trace_checkpoint(model_path, dtype=dtype,
                                              vision_path=vision_path)
    if quant == "int4":
        params, config = int4_serving(params, config)
    elif quant != "bf16":
        serving = int8_serving if quant == "int8" else int4p_serving
        params, config = serving(params, config, vision=False)
    pipe = TracePipeline(params, config, tokenizer, device=device)
    del params
    pipe._prepare_memory_layout()
    return pipe


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):  # a connector's layers
        return [_to_device(v, device) for v in tree]
    return tree.to(device)
