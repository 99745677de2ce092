"""Video highlight detection metric — QVHighlights protocol.

The port's copy of ``trace_tpu/metrics/vhd.py``.

Re-implements trace/metrics/vhd/eval_vhd.py: moment-retrieval mAP over IoU
0.5:0.05:0.95 and R@1, plus highlight detection Hit@1 / mAP over the 3
annotators at GT binarization thresholds {2, 3, 4}.  Multiprocessing fan-out
replaced with a plain loop (numpy is the hot path here, not process spawn).
"""

from __future__ import annotations

import copy
from collections import OrderedDict, defaultdict
from typing import Optional, Sequence

import numpy as np

from trace_tpu_torch.metrics.temporal import (
    binary_ap,
    detection_ap,
    temporal_iou_cross,
    temporal_iou_paired,
)

IOU_THDS = np.linspace(0.5, 0.95, 10)


def compute_mr_ap(
    submission: list[dict],
    ground_truth: list[dict],
    iou_thds: np.ndarray = IOU_THDS,
    max_pred_windows: Optional[int] = 10,
) -> dict:
    """Moment-retrieval mAP (eval_vhd.py:20-70)."""
    iou_thds = [float(f"{e:.2f}") for e in iou_thds]
    pred_by_qid = defaultdict(list)
    for d in submission:
        windows = d["pred_relevant_windows"]
        if max_pred_windows is not None:
            windows = windows[:max_pred_windows]
        for w in windows:
            pred_by_qid[d["qid"]].append(
                {"video-id": d["qid"], "t-start": w[0], "t-end": w[1], "score": w[2]}
            )
    gt_by_qid = defaultdict(list)
    for d in ground_truth:
        for w in d["relevant_windows"]:
            gt_by_qid[d["qid"]].append(
                {"video-id": d["qid"], "t-start": w[0], "t-end": w[1]}
            )

    ap_rows = [
        detection_ap(gt_by_qid[qid], pred_by_qid[qid], np.asarray(iou_thds))
        for qid in pred_by_qid
    ]
    ap_thds = np.array(ap_rows).mean(0) if ap_rows else np.zeros(len(iou_thds))
    out = dict(zip([str(e) for e in iou_thds], ap_thds))
    out["average"] = float(np.mean(ap_thds))
    return {k: float(f"{100 * v:.2f}") for k, v in out.items()}


def compute_mr_r1(
    submission: list[dict],
    ground_truth: list[dict],
    iou_thds: np.ndarray = IOU_THDS,
) -> dict:
    """R@1: best-IoU GT window per query vs the top prediction (eval_vhd.py:73-97)."""
    iou_thds = [float(f"{e:.2f}") for e in iou_thds]
    pred_win = {d["qid"]: d["pred_relevant_windows"][0][:2] for d in submission}
    gt_win = {}
    for d in ground_truth:
        windows = d["relevant_windows"]
        best = 0
        if len(windows) > 0 and d["qid"] in pred_win:
            ious = temporal_iou_cross(
                np.array([pred_win[d["qid"]]], dtype=float),
                np.array(windows, dtype=float),
            )[0]
            best = int(np.argmax(ious))
        gt_win[d["qid"]] = windows[best]

    qids = list(pred_win.keys())
    p = np.array([pred_win[q] for q in qids], dtype=float)
    g = np.array([gt_win[q] for q in qids], dtype=float)
    iou = temporal_iou_paired(p, g)
    return {str(t): float(f"{np.mean(iou >= t) * 100:.2f}") for t in iou_thds}


def mk_gt_scores(gt_data: dict, clip_length: int = 2) -> np.ndarray:
    """Expand sparse relevant-clip saliency to the full video (eval_vhd.py:228-236)."""
    num_clips = int(gt_data["duration"] / clip_length)
    full = np.zeros((num_clips, 3))
    ids = np.asarray(gt_data["relevant_clip_ids"])
    full[ids] = np.asarray(gt_data["saliency_scores"])
    return full


def compute_hl_hit1(qid2preds: dict, qid2gt_binary: dict) -> float:
    hits = np.zeros((len(qid2preds), 3))
    for idx, (qid, pred) in enumerate(qid2preds.items()):
        clip_idx = int(np.argmax(pred["pred_saliency_scores"]))
        gtb = qid2gt_binary[qid]
        if clip_idx < len(gtb):
            hits[idx] = gtb[clip_idx]
    return float(f"{100 * np.mean(np.max(hits, 1)):.2f}")


def compute_hl_ap(qid2preds: dict, qid2gt_binary: dict) -> float:
    scores = np.zeros((len(qid2preds), 3))
    for idx, (qid, pred) in enumerate(qid2preds.items()):
        y_pred = np.asarray(pred["pred_saliency_scores"], dtype=float)
        for w in range(3):
            y_true = qid2gt_binary[qid][:, w]
            yp = y_pred
            if len(y_true) < len(yp):
                yp = yp[: len(y_true)]
            elif len(y_true) > len(yp):
                tmp = np.zeros(len(y_true))
                tmp[: len(yp)] = yp
                yp = tmp
            scores[idx, w] = binary_ap(y_true, yp)
    return float(f"{100 * np.mean(scores):.2f}")


def eval_highlight(submission: list[dict], ground_truth: list[dict]) -> dict:
    """Hit@1 / mAP at binarization thresholds 2/3/4 (eval_vhd.py:239-253)."""
    qid2preds = {d["qid"]: d for d in submission}
    qid2gt_full = {d["qid"]: mk_gt_scores(d) for d in ground_truth}
    out = {}
    for min_score, name in zip((2, 3, 4), ("Fair", "Good", "VeryGood")):
        binary = {k: (v >= min_score).astype(float) for k, v in qid2gt_full.items()}
        out[f"HL-min-{name}"] = {
            "HL-mAP": compute_hl_ap(qid2preds, binary),
            "HL-Hit1": compute_hl_hit1(qid2preds, binary),
        }
    return out


def _by_length_range(submission, ground_truth, len_range):
    min_l, max_l = len_range
    if min_l == 0 and max_l == 150:
        return submission, ground_truth
    gt_in, qids = [], set()
    for d in ground_truth:
        ws = [w for w in d["relevant_windows"] if min_l < (w[1] - w[0]) <= max_l]
        if ws:
            d = copy.deepcopy(d)
            d["relevant_windows"] = ws
            gt_in.append(d)
            qids.add(d["qid"])
    sub_in = [copy.deepcopy(d) for d in submission if d["qid"] in qids]
    return sub_in, gt_in


def eval_moment_retrieval(submission, ground_truth) -> dict:
    ranges = {"short": (0, 10), "middle": (10, 30), "long": (30, 150), "full": (0, 150)}
    out = {}
    for name, rng in ranges.items():
        sub, gt = _by_length_range(submission, ground_truth, rng)
        if not sub:
            out[name] = {"MR-mAP": {"average": 0.0}, "MR-R1": {}}
            continue
        out[name] = {
            "MR-mAP": compute_mr_ap(sub, gt),
            "MR-R1": compute_mr_r1(sub, gt),
        }
    return out


def eval_submission(
    submission: list[dict],
    ground_truth: list[dict],
    match_number: bool = False,
) -> dict:
    """Full QVHighlights evaluation (eval_vhd.py:256-327)."""
    pred_qids = {e["qid"] for e in submission}
    gt_qids = {e["qid"] for e in ground_truth}
    if match_number:
        assert pred_qids == gt_qids
    else:
        shared = pred_qids & gt_qids
        submission = [e for e in submission if e["qid"] in shared]
        ground_truth = [e for e in ground_truth if e["qid"] in shared]

    metrics: dict = {}
    brief: "OrderedDict[str, float]" = OrderedDict()
    if submission and "pred_relevant_windows" in submission[0]:
        mr = eval_moment_retrieval(submission, ground_truth)
        metrics.update(mr)
        # same brief key set (and sorted order) as eval_vhd.py:302-313
        brief.update(sorted({
            "MR-full-mAP": mr["full"]["MR-mAP"]["average"],
            "MR-full-mAP@0.5": mr["full"]["MR-mAP"].get("0.5", 0.0),
            "MR-full-mAP@0.75": mr["full"]["MR-mAP"].get("0.75", 0.0),
            "MR-short-mAP": mr["short"]["MR-mAP"]["average"],
            "MR-middle-mAP": mr["middle"]["MR-mAP"]["average"],
            "MR-long-mAP": mr["long"]["MR-mAP"]["average"],
            "MR-full-R1@0.5": mr["full"]["MR-R1"].get("0.5", 0.0),
            "MR-full-R1@0.7": mr["full"]["MR-R1"].get("0.7", 0.0),
        }.items()))
    if submission and "pred_saliency_scores" in submission[0]:
        hl = eval_highlight(submission, ground_truth)
        metrics.update(hl)
        for k, v in hl.items():
            for sub_k, val in v.items():
                brief[f"{k}-{sub_k.split('-')[1]}"] = val

    final = OrderedDict()
    final["brief"] = brief
    final.update(sorted(metrics.items()))
    return final
