"""Temporal video grounding (moment retrieval) metric: R@IoU + mIoU.

The port's copy of ``trace_tpu/metrics/tvg.py``.

Protocol of trace/metrics/tvg/eval_tvg.py:44-84: per query, IoU between the
single predicted window and GT; report recall at {0.3, 0.5, 0.7} and mean IoU,
normalized by the number of predictions scored (missing preds count 0).
"""

from __future__ import annotations

from typing import Mapping, Sequence

from trace_tpu_torch.metrics.temporal import window_iou


def evaluate_tvg(
    predictions: Mapping,          # qid -> {'timestamp': [s, e], ...}
    ground_truth: Mapping,         # qid -> [s, e]
    thresholds: Sequence[float] = (0.3, 0.5, 0.7),
) -> dict:
    # Reference accounting (eval_tvg.py:56-84): predictions lacking a
    # timestamp score as [0, 0] (IoU ~0) but do NOT count in the denominator,
    # which is the number of real predictions.
    pred_windows = {}
    num = 0
    for qid, pred in predictions.items():
        if "timestamp" not in pred or len(pred["timestamp"]) < 2:
            pred_windows[qid] = [0.0, 0.0]
            continue
        num += 1
        pred_windows[qid] = pred["timestamp"]

    hit = {t: 0 for t in thresholds}
    miou = 0.0
    for qid, gt in ground_truth.items():
        if qid not in pred_windows:
            continue
        v = window_iou(gt, pred_windows[qid])
        for t in thresholds:
            if v >= t:
                hit[t] += 1
        miou += v

    num = max(num, 1)
    out = {f"R@{t}": 100.0 * hit[t] / num for t in thresholds}
    out["mIoU"] = 100.0 * miou / num
    out["num_queries"] = num
    return out


def load_tvg_ground_truth(gt_file: str) -> dict:
    """GT in the caption_coco_format used by the reference (eval_tvg.py:47-52)."""
    import json

    with open(gt_file) as f:
        anns = json.load(f)["annotations"]
    return {j["id"]: j["timestamp"] for j in anns}
