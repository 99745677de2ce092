"""Task-specific reformatters: event triplets -> metric input JSON.

The port's copy of ``trace_tpu/eval/reformat.py``.

Function ports of trace/eval/reformat_{dvc,tvg,vhd}.py (argparse scripts in
the reference; shared library functions here).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np


def reformat_dvc(pred_data: Sequence[dict]) -> dict:
    """Dense captioning: keep len-2 timestamps, key by video basename
    (reformat_dvc.py:14-26)."""
    out = {}
    for item in pred_data:
        events = []
        for time, caption in zip(item["timestamps"], item["captions"]):
            if len(time) != 2:
                continue
            events.append({"caption": caption, "timestamp": time})
        out[item["video"].split("/")[-1]] = events
    return out


def reformat_tvg(pred_data: Sequence[dict]) -> dict:
    """Moment retrieval: first len-2 event only, keyed by query id
    (reformat_tvg.py:14-25)."""
    out = {}
    for item in pred_data:
        entry = {}
        for time, caption in zip(item["timestamps"], item["captions"]):
            if len(time) != 2:
                continue
            entry = {
                "query": caption,
                "timestamp": time,
                "vid": item["video"].split("/")[-1],
            }
            break
        out[item["id"]] = entry
    return out


def clip_saliency_scores(
    timestamps: Sequence[Sequence[float]],
    scores: Sequence[Sequence[float]],
    duration: float,
    clip_length: float = 2.0,
) -> list[float]:
    """Map (timestamp, score) events to per-2s-clip saliency
    (reformat_vhd.py format_vhd_output)."""
    num_clips = int(duration / clip_length)
    total = np.zeros(num_clips)
    count = np.zeros(num_clips)
    for time, score in zip(timestamps, scores):
        if len(time) == 0 or len(score) == 0:
            continue
        t, s = time[0], score[0]
        if t > duration:
            continue
        clip_id = max(0, int(t / clip_length) - 1)
        total[clip_id] += s
        count[clip_id] += 1
    return [
        float(total[c] / count[c]) if count[c] else 0.0 for c in range(num_clips)
    ]


def reformat_vhd(pred_data: Sequence[dict], gt_by_vid: Mapping[str, dict]) -> list[dict]:
    """Highlight detection: event stream -> per-clip saliency submission
    (reformat_vhd.py main loop)."""
    out = []
    for item in pred_data:
        vid = item["video"].split("/")[-1]
        entry = {
            "query": item["captions"][0] if item["captions"] else "",
            "vid": vid,
            "qid": item["id"],
        }
        timestamps = item["timestamps"] or []
        scores = item["scores"] or []
        if len(scores) < len(timestamps):
            scores = list(scores) + [[0.0]] * (len(timestamps) - len(scores))
        else:
            scores = scores[: len(timestamps)]
        entry["pred_saliency_scores"] = clip_saliency_scores(
            timestamps, scores, gt_by_vid[vid]["duration"]
        )
        out.append(entry)
    return out
