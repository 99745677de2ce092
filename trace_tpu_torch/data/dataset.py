"""Training data pipeline: annotations -> fixed-shape multimodal batches.

Re-designs the reference's LazySupervisedDataset + preprocess_llama_2 +
DataCollator (train_mt.py:354-900) for static-shape training (a numpy-only
copy of trace_tpu/data/dataset.py on the port's conversation templates,
constants and tokenizers):

* the assistant's event response is built DIRECTLY in the combined 32,027-id
  space (time chars at TIME_OFFSET+local, score chars at SCORE_OFFSET+local,
  <sync> = 32000), instead of spraying ``<time>``/``<score>`` sentinel tags
  through the text and re-matching them later (trace_arch.py:398-447);
* label construction is segment-based (each prompt segment carries its own
  supervise-flag) rather than string-split round matching — the class of
  "tokenization mismatch" bugs the reference guards against at
  train_mt.py:542-548 cannot occur;
* GT event times snap to the nearest sampled frame timestamp
  (train_mt.py:842), which is what makes trace-retrieval-style decoding
  learnable;
* every sample pads to a fixed max_len with a fixed num_frames, so every
  step of an epoch has one shape.

Video and image records are read through the port's ``video/io.py``
(containers through the native decoder or OpenCV, ``.npy``, frame
directories, images, gifs); a record whose media no reader opens counts as a
media failure and is replaced by another, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
from typing import Optional, Sequence

import numpy as np

from trace_tpu_torch import conversation as conv_lib
from trace_tpu_torch.constants import (
    IGNORE_INDEX,
    SCORE_OFFSET,
    SYNC_TOKEN_ID,
    TIME_OFFSET,
)
from trace_tpu_torch.tokenizers.event_codec import SCORE_CODEC, TIME_CODEC
from trace_tpu_torch.tokenizers.text import TextTokenizer


@dataclasses.dataclass
class Segment:
    """A run of combined-space ids with uniform supervision semantics."""

    ids: list[int]
    supervised: bool = False
    kind: str = "text"  # 'text' | 'time' | 'score' | 'video'


def snap_times_to_frames(
    times: Sequence[Sequence[float]], frame_timestamps: Sequence[Sequence[float]]
) -> list[list[float]]:
    """Snap GT event times to the nearest sampled frame timestamp
    (reference: train_mt.py:842)."""
    frame_ts = [t[0] for t in frame_timestamps]
    return [
        [min(frame_ts, key=lambda x: abs(x - target)) for target in interval]
        for interval in times
    ]


def event_response_segments(
    events: Sequence[dict],
    tokenizer: TextTokenizer,
    *,
    text_vocab_size: int = 32000,
) -> list[Segment]:
    """GT events -> supervised segments: times <sync> scores <sync> caption <sync>.

    Combined-space layout follows §2.1 of SURVEY.md; local time/score ids are
    recoverable as (id - offset) for the auxiliary label streams.
    """
    time_off = text_vocab_size + 1
    score_off = time_off + 13
    segs: list[Segment] = []
    for ev in events:
        t_ids = [time_off + i for i in TIME_CODEC.encode(ev["timestamp"])]
        segs.append(Segment(t_ids, supervised=True, kind="time"))
        s_ids = [score_off + i for i in SCORE_CODEC.encode(ev["score"])]
        segs.append(Segment(s_ids, supervised=True, kind="score"))
        cap = tokenizer.encode(ev["caption"])
        if cap and cap[0] == tokenizer.bos_token_id:
            cap = cap[1:]
        segs.append(Segment(list(cap) + [text_vocab_size], supervised=True, kind="text"))
    return segs


def build_prompt_segments(
    instruction: str,
    tokenizer: TextTokenizer,
    num_video_tokens: int,
    *,
    template: str = "llama_2",
    text_vocab_size: int = 32000,
) -> tuple[list[Segment], int]:
    """Instruction prompt -> unsupervised segments with the video span.

    Returns (segments, video_pos_within_ids). The prompt mirrors the
    production assembly: ``[INST] <<SYS>>..<</SYS>> <video>\\nQ [/INST]<sync>``
    with the trailing <sync> starting the event stream (time head first).
    """
    tpl = conv_lib.get_template(template)
    prompt = tpl.prompt([
        tpl.user_turn(f"<video>\n{instruction}"),
        tpl.assistant_turn(None),
    ])
    pre, post = prompt.split("<video>")

    pre_ids = tokenizer.encode(pre) if pre else [tokenizer.bos_token_id]
    post_ids = tokenizer.encode(post)
    if post_ids and post_ids[0] == tokenizer.bos_token_id:
        post_ids = post_ids[1:]

    segs = [
        Segment(list(pre_ids), supervised=False),
        Segment([0] * num_video_tokens, supervised=False, kind="video"),
        Segment(list(post_ids) + [text_vocab_size], supervised=False),
    ]
    video_pos = len(pre_ids)
    return segs, video_pos


def _strip_bos(ids: list[int], tokenizer: TextTokenizer) -> list[int]:
    if ids and ids[0] == getattr(tokenizer, "bos_token_id", None):
        return ids[1:]
    return ids


_EVENT_TAGS = ("<time>", "<score>", "<sync>")


def _turn_captions(value: str) -> list[str]:
    """gpt-turn text -> caption lines (event sentinel tags stripped)."""
    for tag in _EVENT_TAGS:
        value = value.replace(tag, "")
    return [c.strip() for c in value.split("\n") if c.strip()]


def build_conversation_segments(
    conversations: Sequence[dict],
    tokenizer: TextTokenizer,
    num_video_tokens: int,
    *,
    template: str = "llama_2",
    text_vocab_size: int = 32000,
    events: Optional[Sequence[dict]] = None,
    modal_tag: Optional[str] = None,
) -> tuple[list[Segment], Optional[int]]:
    """Multi-round ``conversations`` -> segments + video span position.

    Covers the reference's full preprocess surface (train_mt.py:470-723
    label masking over multi-round conversations, preprocess_multimodal
    tag normalization at :354-376) on the segment architecture:

    * leading non-human turns are dropped (train_mt.py:389-391);
    * the modal tag (``<video>``/``<image>``) is moved to the start of its
      turn (preprocess_multimodal) and becomes the video span; at most one
      across the conversation (trace_arch.py:411); ``None`` video_pos means
      a text-only record (no span spliced);
    * assistant turns are supervised, everything else is not;
    * when ``events`` is given, each gpt turn consumes as many events as it
      has caption lines and is rebuilt as the serialized event stream
      (times <sync> scores <sync> caption <sync>) directly in combined-id
      space — the segment equivalent of the reference's per-token
      ``<time>``/``<score>`` sentinel splice (trace_arch.py:430-447);
    * plain gpt turns stay text (the trace-uni event-free QA mix,
      README.md:59-60).

    Returns (segments, video_pos_or_None).
    """
    tpl = conv_lib.get_template(template)
    turns = list(conversations)
    if turns and turns[0].get("from") != "human":
        turns = turns[1:]

    events = list(events or [])
    ev_cursor = 0

    # one placeholder per event gpt turn; substituted after chunk rendering
    messages: list[tuple[str, Optional[str]]] = []
    event_turns: dict[str, list[dict]] = {}
    for ti, turn in enumerate(turns):
        value = turn["value"]
        if turn["from"] == "human":
            if modal_tag and modal_tag in value:
                # preprocess_multimodal: tag leads the turn
                value = (modal_tag + "\n" + value.replace(modal_tag, "").strip()).strip()
            messages.append(tpl.user_turn(value))
        else:
            caps = _turn_captions(value)
            if events and ev_cursor < len(events) and caps:
                take = events[ev_cursor : ev_cursor + len(caps)]
                ev_cursor += len(take)
                if len(take) < len(caps):
                    # annotation/schema mismatch: more caption lines than
                    # events would silently drop the surplus from the
                    # serialized stream.  Schema errors raise (policy: only
                    # media errors substitute a fallback sample).
                    raise ValueError(
                        f"gpt turn {ti} has {len(caps)} caption lines but "
                        f"only {len(take)} events remain in the record"
                    )
                for ev, cap in zip(take, caps):
                    ev.setdefault("caption", cap)
                key = f"\x00EV{ti}\x00"
                event_turns[key] = take
                messages.append(tpl.assistant_turn(key))
            else:
                messages.append(tpl.assistant_turn(value))

    segs: list[Segment] = []
    video_pos: Optional[int] = None
    first = True

    def add_text(text: str, supervised: bool):
        nonlocal first, video_pos
        if not text and not first:
            return
        if modal_tag and modal_tag in text:
            pre, post = text.split(modal_tag, 1)
            assert modal_tag not in post, "only have one video inputs!"
            add_text(pre, supervised)
            if video_pos is not None:
                raise ValueError("only have one video inputs!")
            video_pos = sum(len(s.ids) for s in segs)
            segs.append(Segment([0] * num_video_tokens, supervised=False, kind="video"))
            add_text(post, supervised)
            return
        ids = list(tokenizer.encode(text)) if (text or first) else []
        if first:
            if not ids:
                ids = [tokenizer.bos_token_id]
            first = False
        else:
            ids = _strip_bos(ids, tokenizer)
        if ids:
            segs.append(Segment(ids, supervised=supervised))

    for text, supervised in tpl.prompt_chunks(messages):
        hit = next((k for k in event_turns if k in text), None)
        if hit is None:
            add_text(text, supervised)
            continue
        pre, post = text.split(hit, 1)
        add_text(pre, supervised)
        # the event stream opens with an unsupervised <sync> (the FSM entry
        # the inference prompt appends, inference.py:45,54)
        segs.append(Segment([text_vocab_size], supervised=False))
        segs.extend(
            event_response_segments(
                event_turns[hit], tokenizer, text_vocab_size=text_vocab_size
            )
        )
        add_text(post, supervised)

    return segs, video_pos


@dataclasses.dataclass
class TrainingSequence:
    token_ids: np.ndarray
    labels: np.ndarray
    time_labels: np.ndarray
    score_labels: np.ndarray
    attn_mask: np.ndarray
    video_pos: int


def assemble_sequence(
    segments: list[Segment],
    max_len: int,
    video_pos: int,
    *,
    text_vocab_size: int = 32000,
    eos_id: int = 2,
    supervise_eos: bool = True,
) -> TrainingSequence:
    """Segments -> fixed-length id + 3-stream label arrays.

    Label semantics (reference trace_arch.py:430-447):
      text stream: supervised text ids as-is, <sync> positions get
        text_vocab_size, time/score/video positions IGNORE;
      time stream: local ids only at supervised time positions;
      score stream: local ids only at supervised score positions.
    """
    time_off = text_vocab_size + 1
    score_off = time_off + 13

    ids: list[int] = []
    labels: list[int] = []
    tlabels: list[int] = []
    slabels: list[int] = []
    for seg in segments:
        for t in seg.ids:
            ids.append(t)
            if not seg.supervised:
                labels.append(IGNORE_INDEX)
                tlabels.append(IGNORE_INDEX)
                slabels.append(IGNORE_INDEX)
            elif seg.kind == "time":
                labels.append(IGNORE_INDEX)
                tlabels.append(t - time_off)
                slabels.append(IGNORE_INDEX)
            elif seg.kind == "score":
                labels.append(IGNORE_INDEX)
                tlabels.append(IGNORE_INDEX)
                slabels.append(t - score_off)
            else:
                labels.append(t)  # text ids and the <sync>=vocab_size label
                tlabels.append(IGNORE_INDEX)
                slabels.append(IGNORE_INDEX)

    if supervise_eos:
        ids.append(eos_id)
        labels.append(eos_id)
        tlabels.append(IGNORE_INDEX)
        slabels.append(IGNORE_INDEX)

    n = len(ids)
    if n > max_len:
        import warnings

        lost = sum(
            1 for x in (labels, tlabels, slabels) for v in x[max_len:]
            if v != IGNORE_INDEX
        )
        if lost:
            warnings.warn(
                f"sequence of {n} tokens truncated to {max_len}: "
                f"{lost} supervised labels dropped"
            )
        ids, labels, tlabels, slabels = (
            x[:max_len] for x in (ids, labels, tlabels, slabels)
        )
        n = max_len

    pad = max_len - n
    arr = lambda x, fill: np.asarray(x + [fill] * pad, np.int32)
    return TrainingSequence(
        token_ids=arr(ids, 0),
        labels=arr(labels, IGNORE_INDEX),
        time_labels=arr(tlabels, IGNORE_INDEX),
        score_labels=arr(slabels, IGNORE_INDEX),
        attn_mask=np.asarray([True] * n + [False] * pad),
        video_pos=video_pos,
    )


class DatasetError(RuntimeError):
    """Raised when the bounded corrupt-sample fallback is exhausted."""


class EventDataset:
    """JSON-annotation dataset producing fixed-shape training samples.

    Annotation format (reference dataset JSON, train_mt.py:777-784): each
    record has ``conversations`` ([{from, value}] multi-round) plus one of
    ``video`` / ``image`` / nothing (text-only QA), and optionally ``times``
    ([[s, e], ...]) / ``scores`` ([[x], ...]) event annotations.  This is
    the full trace-uni training mix (README.md:59-60).

    Failure semantics: ONLY media decode errors fall back to a random
    substitute sample (like the reference confines it, train_mt.py:793-811),
    with a bounded retry count and a logged warning per failure; schema or
    label-construction errors raise immediately.
    """

    MAX_SUBSTITUTE_RETRIES = 10

    def __init__(
        self,
        data_path: str,
        tokenizer: TextTokenizer,
        *,
        data_folder: str = "",
        num_frames: int = 128,
        num_video_tokens_per_frame: int = 14,
        max_len: int = 4096,
        sample_scheme: str = "uniform",
        image_size: int = 336,
        text_vocab_size: int = 32000,
        template: str = "llama_2",
        seed: int = 0,
    ):
        with open(data_path) as f:
            self.records = json.load(f)
        self.tokenizer = tokenizer
        self.data_folder = data_folder
        self.num_frames = num_frames
        self.tokens_per_frame = num_video_tokens_per_frame
        self.max_len = max_len
        self.sample_scheme = sample_scheme
        self.image_size = image_size
        self.text_vocab_size = text_vocab_size
        self.template = template
        self.rng = np.random.default_rng(seed)
        self._py_rng = random.Random(seed)
        self.media_failures = 0  # running counter, surfaced in train logs

    def __len__(self):
        return len(self.records)

    def modality_lengths(self) -> list[int]:
        """Signed word-count lengths for modality-grouped batching
        (reference: trace_trainer.py:62-87 uses sign to separate modalities)."""
        out = []
        for rec in self.records:
            n = sum(len(c["value"].split()) for c in rec["conversations"])
            out.append(n if "image" in rec else -n)
        return out

    def __getitem__(self, i: int) -> dict:
        idx = i
        for attempt in range(self.MAX_SUBSTITUTE_RETRIES + 1):
            rec = self.records[idx]
            try:
                frames_u8, frame_ts = self._load_media(rec)
            except Exception as e:
                self.media_failures += 1
                import warnings

                warnings.warn(
                    f"media decode failed for record {idx} "
                    f"({rec.get('video') or rec.get('image')}): {e} — "
                    f"substituting a random sample "
                    f"(attempt {attempt + 1}/{self.MAX_SUBSTITUTE_RETRIES})"
                )
                idx = self._py_rng.randrange(len(self.records))
                continue
            return self._build(rec, frames_u8, frame_ts)
        raise DatasetError(
            f"{self.MAX_SUBSTITUTE_RETRIES} consecutive media decode failures "
            f"starting from record {i}; check data_folder={self.data_folder!r}"
        )

    def _load_media(self, rec: dict):
        """Record -> (frames_u8 [T, S, S, 3], frame_timestamps).

        video: decoded + sampled; image: replicated across the frame axis
        with [[0]] timestamps (train_mt.py:785-805, trace_arch.py:221);
        text-only: zero frames (the reference substitutes a zero image,
        train_mt.py:846-849) — flagged has_video=False so the span splice
        is skipped.  Frames are standardized to image_size on host so
        mixed-resolution corpora collate into one static batch shape.
        """
        from trace_tpu_torch.video.io import load_image_as_video, load_video_frames

        if "video" in rec:
            path = os.path.join(self.data_folder, rec["video"])
            frames_u8, frame_ts = load_video_frames(
                path, self.num_frames, self.sample_scheme, rng=self.rng
            )
        elif "image" in rec:
            path = os.path.join(self.data_folder, rec["image"])
            frames_u8, frame_ts = load_image_as_video(path, self.num_frames)
        else:
            S = self.image_size
            return (
                np.zeros((self.num_frames, S, S, 3), np.uint8),
                [[0.0]] * self.num_frames,
            )

        S = self.image_size
        if frames_u8.shape[1] != S or frames_u8.shape[2] != S:
            from trace_tpu_torch.video.preprocess import host_downscale

            frames_u8 = host_downscale(np.ascontiguousarray(frames_u8), S)
        return frames_u8, frame_ts

    def _build(self, rec: dict, frames_u8: np.ndarray, frame_ts: list) -> dict:
        has_video = "video" in rec or "image" in rec
        modal_tag = None
        conv_text = " ".join(t.get("value", "") for t in rec["conversations"])
        if "<video>" in conv_text:
            modal_tag = "<video>"
        elif "<image>" in conv_text:
            modal_tag = "<image>"

        events = None
        if rec.get("times"):
            times = snap_times_to_frames(rec["times"], frame_ts)
            scores = rec.get("scores", [[0.0]] * len(times))
            events = [{"timestamp": t, "score": s} for t, s in zip(times, scores)]

        n_video = self.num_frames * self.tokens_per_frame
        segs, video_pos = build_conversation_segments(
            rec["conversations"], self.tokenizer, n_video,
            template=self.template, text_vocab_size=self.text_vocab_size,
            events=events, modal_tag=modal_tag,
        )
        # each assistant round already ends with the template terminator
        # (llama_2 '</s>' == the tokenizer eos), so no extra eos is appended
        seq = assemble_sequence(
            segs, self.max_len, video_pos if video_pos is not None else 0,
            text_vocab_size=self.text_vocab_size,
            eos_id=self.tokenizer.eos_token_id,
            supervise_eos=False,
        )

        time_ids = np.stack(
            [TIME_CODEC.encode_value(t[0]) for t in frame_ts]
        ).astype(np.int32)
        return {
            "frames_u8": frames_u8,
            "frame_time_ids": time_ids,
            "token_ids": seq.token_ids,
            "labels": seq.labels,
            "time_labels": seq.time_labels,
            "score_labels": seq.score_labels,
            "attn_mask": seq.attn_mask,
            "video_pos": np.int32(seq.video_pos),
            "has_video": np.bool_(has_video and video_pos is not None),
        }


def collate_batch(samples: list[dict], image_size: int = 336) -> dict:
    """Stack per-sample dicts into the batch layout forward_train expects.

    Frames stay uint8 on host; preprocessing happens on device inside the
    train step so the host->device transfer is 4 bytes/pixel smaller.
    """
    return {
        "frames_u8": np.stack([s["frames_u8"] for s in samples]),
        "frame_time_ids": np.stack([s["frame_time_ids"] for s in samples]),
        "token_ids": np.stack([s["token_ids"] for s in samples]),
        "labels": np.stack([s["labels"] for s in samples]),
        "time_labels": np.stack([s["time_labels"] for s in samples]),
        "score_labels": np.stack([s["score_labels"] for s in samples]),
        "attn_mask": np.stack([s["attn_mask"] for s in samples]),
        "video_pos": np.asarray([s["video_pos"] for s in samples], np.int32),
        "has_video": np.asarray(
            [bool(s.get("has_video", True)) for s in samples], bool
        ),
    }
