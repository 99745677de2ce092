"""Temporal-localization primitives shared by the TVG / VHD / DVC metrics
(a copy of trace_tpu/metrics/temporal.py, with a precision-recall curve of
its own in place of scikit-learn's).

Protocol-faithful re-implementations of the reference's metric math
(trace/metrics/vhd/utils.py, trace/metrics/tvg/eval_tvg.py:14-20): window IoU
conventions, VOC-style interpolated AP, and greedy detection matching are
kept bit-compatible so published numbers are comparable.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def window_iou(a: Sequence[float], b: Sequence[float]) -> float:
    """TVG IoU convention (eval_tvg.py:14-20): intersection over the SPAN
    (min..max hull), not the set union — matches the reference exactly."""
    inter = min(a[1], b[1]) - max(a[0], b[0])
    hull = max(a[1], b[1]) - min(a[0], b[0])
    return max(inter, 0) / hull if hull > 0 else 0.0


def temporal_iou_paired(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Row-wise IoU of (N,2) vs (N,2) windows (vhd/utils.py:18-35 semantics:
    'union' is the hull, zeros where the hull is empty)."""
    inter = np.maximum(
        0, np.minimum(pred[:, 1], gt[:, 1]) - np.maximum(pred[:, 0], gt[:, 0])
    )
    hull = np.maximum(pred[:, 1], gt[:, 1]) - np.minimum(pred[:, 0], gt[:, 0])
    return np.divide(inter, hull, out=np.zeros_like(inter, dtype=float), where=hull != 0)


def temporal_iou_cross(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,2) x (M,2) -> (N,M) IoU with true set union (vhd/utils.py:37-66)."""
    areas_a = a[:, 1] - a[:, 0]
    areas_b = b[:, 1] - b[:, 0]
    left = np.maximum(a[:, None, 0], b[None, :, 0])
    right = np.minimum(a[:, None, 1], b[None, :, 1])
    inter = np.clip(right - left, 0, None)
    union = areas_a[:, None] + areas_b[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / union, 0.0)
    return iou


def voc_interpolated_ap(precision: np.ndarray, recall: np.ndarray) -> float:
    """VOC-2011 interpolated AP (vhd/utils.py:69-85)."""
    mprec = np.hstack([[0], precision, [0]])
    mrec = np.hstack([[0], recall, [1]])
    for i in range(len(mprec) - 2, -1, -1):
        mprec[i] = max(mprec[i], mprec[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mprec[idx]))


def detection_ap(
    ground_truth: list[dict],
    prediction: list[dict],
    tiou_thresholds: np.ndarray = np.linspace(0.5, 0.95, 10),
) -> np.ndarray:
    """Detection-task AP with per-threshold greedy GT locking
    (vhd/utils.py:88-169 / ActivityNet protocol).

    dicts carry 'video-id', 't-start', 't-end' (+ 'score' for predictions).
    Returns ap per threshold.
    """
    num_thds = len(tiou_thresholds)
    num_gts = len(ground_truth)
    ap = np.zeros(num_thds)
    if not prediction:
        return ap

    lock_gt = -np.ones((num_thds, num_gts), dtype=int)
    prediction = sorted(prediction, key=lambda x: -x["score"])
    tp = np.zeros((num_thds, len(prediction)))
    fp = np.zeros((num_thds, len(prediction)))

    gt_by_vid: dict = {}
    for i, item in enumerate(ground_truth):
        entry = dict(item)
        entry["index"] = i
        gt_by_vid.setdefault(item["video-id"], []).append(entry)

    for p_idx, pred in enumerate(prediction):
        gts = gt_by_vid.get(pred["video-id"])
        if not gts:
            fp[:, p_idx] = 1
            continue
        pw = np.array([[pred["t-start"], pred["t-end"]]], dtype=float)
        gw = np.array([[g["t-start"], g["t-end"]] for g in gts], dtype=float)
        tious = temporal_iou_cross(pw, gw).reshape(-1)
        order = tious.argsort()[::-1]
        for t_idx, thd in enumerate(tiou_thresholds):
            for j in order:
                if tious[j] < thd:
                    fp[t_idx, p_idx] = 1
                    break
                if lock_gt[t_idx, gts[j]["index"]] >= 0:
                    continue
                tp[t_idx, p_idx] = 1
                lock_gt[t_idx, gts[j]["index"]] = p_idx
                break
            if fp[t_idx, p_idx] == 0 and tp[t_idx, p_idx] == 0:
                fp[t_idx, p_idx] = 1

    tp_cum = np.cumsum(tp, axis=1)
    fp_cum = np.cumsum(fp, axis=1)
    recall = tp_cum / max(float(num_gts), 1e-9)
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
    for t in range(num_thds):
        ap[t] = voc_interpolated_ap(precision[t], recall[t])
    return ap


def precision_recall_curve(y_true, y_score) -> tuple[np.ndarray, np.ndarray]:
    """(precision, recall) of binary labels (positive class 1) at each
    distinct score as a threshold, highest first, with the end point
    (precision 1, recall 0) appended: the curve of scikit-learn's
    ``precision_recall_curve`` without sample weights or dropped points.
    Tied scores form one threshold; with no positive label every recall is 1.
    Labels must be {0, 1} or {-1, 1}, as there."""
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score)
    classes = set(np.unique(y_true).tolist())
    if not (classes <= {0, 1} or classes <= {-1, 1}):
        raise ValueError(f"binary labels must be 0/1 or -1/1, got {sorted(classes)}")
    order = np.argsort(y_score, kind="stable")[::-1]
    score = y_score[order]
    pos = (y_true[order] == 1).astype(np.float64)
    # the last index of each run of equal scores, and the end of the array
    idx = np.r_[np.nonzero(np.diff(score))[0], pos.size - 1]
    tps = np.cumsum(pos, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    precision = tps / (tps + fps)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    return np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0]


def binary_ap(y_true: np.ndarray, y_score: np.ndarray, interpolate: bool = True) -> float:
    """Interpolated AP over binary labels (vhd/utils.py get_ap semantics,
    over ``precision_recall_curve`` above)."""
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score)
    uniq = set(np.unique(y_true).tolist())
    if uniq == {0.0} or uniq == {0}:
        return 0.0
    if uniq == {1.0} or uniq == {1}:
        return 1.0

    precision, recall = precision_recall_curve(y_true, y_score)
    recall = recall.astype(np.float32)
    if interpolate:
        for i in range(1, len(precision)):
            precision[i] = max(precision[i - 1], precision[i])
    indices = np.where(np.diff(recall))
    return float(np.mean(precision[indices]))
