"""Fixed-width time/score codecs and the shared structured event codec.

TRACE models a video as a sequence of events, each decoded as the interleaved
triplet ``timestamps <sync> scores <sync> caption <sync>`` through three output
heads over one combined 32,027-id space.  The reference implementation
duplicates the id-stream decoder in four places with hard-coded magic numbers
(scripts/inference/inference.py:92-127, trace/eval/evaluate.py:360-410,
trace/eval/mvbench/evaluate.py:400-449, trace/eval/videomme/evaluate.py); this
module is the single shared implementation for the rebuild.

Serialization format (reference: trace/model/multimodal_encoder/
time_encoder.py:52-68 and score_encoder.py:52-70): floats are rendered to
fixed-width strings (``format(t, '0>6.1f')`` for timestamps,
``format(s, '0>3.1f')`` for scores), values joined with ``<sep>`` and the
field terminated with the field's ``<sync>``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Sequence

from trace_tpu_torch.constants import (
    COMBINED_VOCAB_SIZE,
    SCORE_FORMAT,
    SCORE_OFFSET,
    SCORE_VOCAB_SIZE,
    SYNC_TOKEN_ID,
    TEXT_VOCAB_SIZE,
    TIME_FORMAT,
    TIME_OFFSET,
    TIME_VOCAB_SIZE,
)

# ---------------------------------------------------------------------------
# Character-level field codec (local 13-token vocab)
# ---------------------------------------------------------------------------

# Local vocab layout shared by the time and score fields
# (reference: time_encoder.py:82-88, score_encoder.py:85-94):
#   0: <sync>   1: <sep>   2-11: digits '0'-'9'   12: '.'
LOCAL_SYNC = 0
LOCAL_SEP = 1
LOCAL_DOT = 12

_CHAR_TO_LOCAL = {str(d): d + 2 for d in range(10)}
_CHAR_TO_LOCAL["."] = LOCAL_DOT
_LOCAL_TO_CHAR = {v: k for k, v in _CHAR_TO_LOCAL.items()}
_LOCAL_TO_CHAR[LOCAL_SYNC] = "<sync>"
_LOCAL_TO_CHAR[LOCAL_SEP] = "<sep>"


class FieldCodec:
    """Fixed-width float <-> local-token-id codec for one field (time/score).

    ``fmt`` is a Python format spec producing a fixed-width string so that all
    values of the field occupy the same number of tokens (the property the
    reference relies on when splicing per-frame time tokens).
    """

    def __init__(self, fmt: str, width: int):
        self.fmt = fmt
        self.width = width
        self.vocab_size = 13

    def encode_value(self, value: float) -> list[int]:
        """One float -> local char ids (no terminator)."""
        s = format(float(value), self.fmt)
        if len(s) != self.width:
            raise ValueError(
                f"value {value!r} renders to {s!r} ({len(s)} chars), "
                f"expected fixed width {self.width}"
            )
        return [_CHAR_TO_LOCAL[c] for c in s]

    def encode(self, values: Sequence[float]) -> list[int]:
        """Float list -> local ids: v1 <sep> v2 <sep> ... <sync>.

        Matches TimeTower.encode / ScoreTower.encode (reference:
        time_encoder.py:52-68): an empty list encodes to just ``[<sync>]``.
        """
        out: list[int] = []
        for i, v in enumerate(values):
            if i:
                out.append(LOCAL_SEP)
            out.extend(self.encode_value(v))
        out.append(LOCAL_SYNC)
        return out

    def decode(self, ids: Iterable[int]) -> list[float]:
        """Local ids -> float list. Tolerates a trailing <sync>."""
        values: list[float] = []
        cur: list[str] = []

        def flush() -> None:
            if cur:
                values.append(float("".join(cur)))
                cur.clear()

        for i in ids:
            i = int(i)
            if i in (LOCAL_SYNC, LOCAL_SEP):
                flush()
            else:
                cur.append(_LOCAL_TO_CHAR[i])
        flush()
        return values

    def token_str(self, local_id: int) -> str:
        return _LOCAL_TO_CHAR[int(local_id)]


TIME_CODEC = FieldCodec(TIME_FORMAT, width=6)
SCORE_CODEC = FieldCodec(SCORE_FORMAT, width=3)


# ---------------------------------------------------------------------------
# Combined-space helpers
# ---------------------------------------------------------------------------

def time_local_to_combined(local_id: int) -> int:
    return TIME_OFFSET + int(local_id)


def score_local_to_combined(local_id: int) -> int:
    return SCORE_OFFSET + int(local_id)


def classify_combined(idx: int) -> str:
    """Which block a combined id belongs to: 'text' | 'sync' | 'time' | 'score'."""
    idx = int(idx)
    if idx < 0 or idx >= COMBINED_VOCAB_SIZE:
        raise ValueError(f"combined id {idx} out of range")
    if idx < TEXT_VOCAB_SIZE:
        return "text"
    if idx == SYNC_TOKEN_ID:
        return "sync"
    if idx < SCORE_OFFSET:
        return "time"
    return "score"


# ---------------------------------------------------------------------------
# Structured event codec
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EventPredictions:
    """Decoded event triplets: parallel lists, one entry per event field seen.

    Mirrors the dict shape produced by the reference's inline decoders
    (scripts/inference/inference.py:82-128): ``timestamps`` is a list of float
    lists (usually ``[start, end]``), ``scores`` a list of float lists
    (usually one saliency value), ``captions`` a list of strings.
    """

    timestamps: list[list[float]]
    scores: list[list[float]]
    captions: list[str]

    def to_dict(self) -> dict:
        return {
            "timestamps": self.timestamps,
            "scores": self.scores,
            "captions": self.captions,
        }

    def events(self) -> list[dict]:
        """Zip the parallel streams into per-event dicts (truncates to shortest)."""
        n = min(len(self.timestamps), len(self.scores), len(self.captions))
        return [
            {
                "timestamp": self.timestamps[i],
                "score": self.scores[i],
                "caption": self.captions[i],
            }
            for i in range(n)
        ]


def decode_event_stream(
    ids: Iterable[int],
    detokenize: Callable[[Sequence[int]], str],
    *,
    text_vocab_size: int = TEXT_VOCAB_SIZE,
) -> EventPredictions:
    """Invert a combined-id stream into event triplets.

    Single shared replacement for the four duplicated decoders in the
    reference (see module docstring).  ``detokenize`` maps raw text token ids
    to a string (e.g. the Mistral tokenizer's decode with special tokens
    skipped).

    Semantics follow scripts/inference/inference.py:92-127:
      * text ids accumulate into the current caption; 32000 flushes it;
      * time ids accumulate digit chars; <sep> flushes one float, time-<sync>
        flushes the pending float and closes the timestamps list;
      * score ids behave identically in their block.
    """
    sync_id = text_vocab_size
    time_off = text_vocab_size + 1
    score_off = time_off + TIME_VOCAB_SIZE
    combined = score_off + SCORE_VOCAB_SIZE

    timestamps: list[list[float]] = []
    scores: list[list[float]] = []
    captions: list[str] = []

    cur_times: list[float] = []
    cur_time_chars: list[str] = []
    cur_scores: list[float] = []
    cur_score_chars: list[str] = []
    cur_caption: list[int] = []

    # A value whose chars do not form a number (a second '.', say) is
    # dropped; the JAX package's codec raises ValueError on it, which ends
    # the whole batch of a serving request.
    def flush_value(chars: list[str], values: list[float]) -> None:
        if chars:
            try:
                values.append(float("".join(chars)))
            except ValueError:
                pass
            chars.clear()

    def flush_time_value() -> None:
        flush_value(cur_time_chars, cur_times)

    def flush_score_value() -> None:
        flush_value(cur_score_chars, cur_scores)

    for raw in ids:
        idx = int(raw)
        if idx < 0:
            continue  # padding / sentinel ids are skipped
        if idx <= sync_id:
            if idx == sync_id:
                captions.append(detokenize(cur_caption))
                cur_caption = []
            else:
                cur_caption.append(idx)
        elif idx < score_off:
            local = idx - time_off
            if local == LOCAL_SYNC:
                flush_time_value()
                timestamps.append(cur_times)
                cur_times = []
            elif local == LOCAL_SEP:
                flush_time_value()
            else:
                cur_time_chars.append(_LOCAL_TO_CHAR[local])
        elif idx < combined:
            local = idx - score_off
            if local == LOCAL_SYNC:
                flush_score_value()
                scores.append(cur_scores)
                cur_scores = []
            elif local == LOCAL_SEP:
                flush_score_value()
            else:
                cur_score_chars.append(_LOCAL_TO_CHAR[local])
        # ids >= COMBINED_VOCAB_SIZE cannot be produced by the model; ignore.

    if cur_caption:
        captions.append(detokenize(cur_caption))

    return EventPredictions(timestamps=timestamps, scores=scores, captions=captions)


def encode_event_stream(
    events: Sequence[dict],
    tokenize_caption: Callable[[str], Sequence[int]],
) -> list[int]:
    """Events -> combined-id stream ``times <sync> scores <sync> caption <sync>``.

    Inverse of :func:`decode_event_stream`; used by tests and synthetic data.
    Each event dict has keys ``timestamp`` (float list), ``score`` (float
    list), ``caption`` (str).
    """
    out: list[int] = []
    for ev in events:
        out.extend(time_local_to_combined(i) for i in TIME_CODEC.encode(ev["timestamp"]))
        out.extend(score_local_to_combined(i) for i in SCORE_CODEC.encode(ev["score"]))
        out.extend(int(t) for t in tokenize_caption(ev["caption"]))
        out.append(SYNC_TOKEN_ID)
    return out
