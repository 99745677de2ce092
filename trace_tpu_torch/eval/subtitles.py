"""WebVTT subtitle parsing for Video-MME's with-subtitles setting.

The port's copy of ``trace_tpu/eval/subtitles.py``.

Reference: read_vtt_and_concatenate in videomme/evaluate.py — subtitles are
concatenated (deduplicated across overlapping cues) and truncated to a token
budget before being appended to the question context.
"""

from __future__ import annotations

import re
from typing import Optional

_TIMESTAMP = re.compile(
    r"(\d{2}:)?\d{2}:\d{2}[.,]\d{3}\s*-->\s*(\d{2}:)?\d{2}:\d{2}[.,]\d{3}"
)
_TAG = re.compile(r"<[^>]+>")


def parse_vtt(text: str) -> list[str]:
    """VTT/SRT content -> list of cue texts (tags stripped, order kept)."""
    cues: list[str] = []
    block: list[str] = []
    in_cue = False
    for raw in text.splitlines():
        line = raw.strip()
        if _TIMESTAMP.search(line):
            in_cue = True
            block = []
            continue
        if not line:
            if in_cue and block:
                cues.append(" ".join(block))
            in_cue = False
            block = []
            continue
        if in_cue:
            cleaned = _TAG.sub("", line).strip()
            if cleaned and cleaned.upper() != "WEBVTT":
                block.append(cleaned)
    if in_cue and block:
        cues.append(" ".join(block))
    return cues


def read_vtt_and_concatenate(
    path: str,
    tokenizer=None,
    max_len: int = 4096,
) -> str:
    """Concatenate deduplicated cue texts, truncated to ~max_len tokens.

    Consecutive cues often repeat lines (rolling captions); repeated fragments
    are dropped like the reference does.
    """
    with open(path, encoding="utf-8", errors="replace") as f:
        cues = parse_vtt(f.read())

    seen: list[str] = []
    for cue in cues:
        if seen and cue == seen[-1]:
            continue
        # rolling-caption overlap: drop the repeated prefix
        if seen and cue.startswith(seen[-1]):
            cue = cue[len(seen[-1]) :].strip()
            if not cue:
                continue
        seen.append(cue)
    text = " ".join(seen)

    if tokenizer is not None:
        ids = tokenizer.encode(text)
        if len(ids) > max_len:
            text = tokenizer.decode(ids[:max_len], skip_special_tokens=True)
    elif len(text.split()) > max_len:
        text = " ".join(text.split()[:max_len])
    return text
