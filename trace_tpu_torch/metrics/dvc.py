"""Dense video captioning evaluation (densevid_eval-compatible protocol).

The port's copy of ``trace_tpu/metrics/dvc.py``.

Re-implements trace/metrics/dvc/eval_dvc.py: per-video detection P/R/F1 over
IoU {0.3, 0.5, 0.7, 0.9}, IoU-matched caption scoring (CIDEr/METEOR) with
random-string negatives for unmatched predictions, and SODA_c via dynamic-
programming assignment over the IoU x METEOR score matrix
(https://github.com/fujiso/SODA).

``seed`` pins the random negatives so runs are reproducible (the reference's
CIDEr numbers are stochastic across runs — SURVEY.md §7 hard-part 5).
"""

from __future__ import annotations

import collections
import random
import re
import string
from typing import Optional, Sequence

import numpy as np

from trace_tpu_torch.metrics.captioning import Cider, PTBTokenizer, make_meteor

IOU_THRESHOLDS = (0.3, 0.5, 0.7, 0.9)


def segment_iou(a: Sequence[float], b: Sequence[float]) -> float:
    """densevid_eval IoU (eval_dvc.py:100-119): inputs may be unordered."""
    s1, e1 = float(min(a)), float(max(a))
    s2, e2 = float(min(b)), float(max(b))
    inter = max(0.0, min(e1, e2) - max(s1, s2))
    union = min(max(e1, e2) - min(s1, s2), (e1 - s1) + (e2 - s2))
    return inter / (union + 1e-8)


def dp_assignment(scores: np.ndarray) -> tuple[float, list[tuple[int, int]]]:
    """SODA's order-preserving DP matching (eval_dvc.py:58-97): maximize the
    summed score of a monotone assignment between GT rows and pred columns."""
    m, n = scores.shape
    dp = np.full((m, n), -np.inf)
    path = np.zeros((m, n), dtype=int)
    for i in range(m):
        for j in range(n):
            candidates = [
                dp[i - 1, j] if i > 0 else -1.0,
                dp[i, j - 1] if j > 0 else -1.0,
                (dp[i - 1, j - 1] if (i > 0 and j > 0) else 0.0) + scores[i, j],
            ]
            best = int(np.argmax(candidates))
            dp[i, j] = candidates[best]
            path[i, j] = best

    def pairs(i: int, j: int) -> list[tuple[int, int]]:
        p = np.where(path[i][: j + 1] == 2)[0]
        if i != 0 and len(p) == 0:
            return pairs(i - 1, j)
        if i == 0 or p[-1] == 0:
            return [(i, int(p[-1]))]
        return pairs(i - 1, int(p[-1]) - 1) + [(i, int(p[-1]))]

    return float(dp[m - 1, n - 1]), pairs(m - 1, n - 1)


def evaluate_detections(
    pred_segments: np.ndarray,
    gt_segments: np.ndarray,
    splits: np.ndarray,
    iou_thresholds: Sequence[float] = IOU_THRESHOLDS,
):
    """Per-threshold coverage P/R with the best-over-splits rule
    (eval_dvc.py:122-197). Returns (precision[], recall[], split->iou_matrix)."""
    best_p: list[float] = []
    best_r: list[float] = []
    iou_matrices: dict[int, np.ndarray] = {}
    n_pred = pred_segments.shape[0]

    for split in sorted(set(int(s) for s in splits)):
        idx = np.where(np.asarray(splits) == split)[0]
        sgt = np.asarray([gt_segments[i] for i in idx])
        covered = {t: (set(), set()) for t in iou_thresholds}
        iou_matrix = np.zeros((len(sgt), max(n_pred, 1)))
        for g, gt_seg in enumerate(sgt):
            for p, pr_seg in enumerate(pred_segments):
                v = segment_iou(pr_seg, gt_seg)
                iou_matrix[g, p] = v
                for t in iou_thresholds:
                    if v > t:
                        covered[t][0].add(p)
                        covered[t][1].add(g)
        precision = [len(covered[t][0]) / max(float(n_pred), 1.0) for t in iou_thresholds]
        recall = [len(covered[t][1]) / float(len(sgt)) for t in iou_thresholds]
        if best_p:
            best_p = [max(a, b) for a, b in zip(precision, best_p)]
            best_r = [max(a, b) for a, b in zip(recall, best_r)]
        else:
            best_p, best_r = precision, recall
        iou_matrices[split] = iou_matrix
    return best_p, best_r, iou_matrices


def _random_string(rng: random.Random, length: int) -> str:
    return "".join(rng.choice(string.ascii_lowercase) for _ in range(length))


def match_captions(
    pred_segments,
    gt_segments,
    pred_captions,
    gt_captions,
    iou_thresholds: Sequence[float] = IOU_THRESHOLDS,
    rng: Optional[random.Random] = None,
):
    """IoU-threshold caption pairing with random-string negatives for
    unmatched predictions (eval_dvc.py:200-271)."""
    rng = rng or random.Random()
    gts = {str(t): {} for t in iou_thresholds}
    preds = {str(t): {} for t in iou_thresholds}
    isxes = {str(t): [] for t in iou_thresholds}
    isx = 0
    for p, pred_seg in enumerate(pred_segments):
        added = {str(t): False for t in iou_thresholds}
        for g, gt_seg in enumerate(gt_segments):
            v = segment_iou(pred_seg, gt_seg)
            for t in iou_thresholds:
                if v >= t:
                    key = str(isx)
                    isxes[str(t)].append(isx)
                    isx += 1
                    gts[str(t)][key] = [{"caption": gt_captions[g]}]
                    preds[str(t)][key] = [{"caption": pred_captions[p]}]
                    added[str(t)] = True
        for t in iou_thresholds:
            if not added[str(t)]:
                key = str(isx)
                isxes[str(t)].append(isx)
                isx += 1
                gts[str(t)][key] = [
                    {"caption": _random_string(rng, rng.randint(10, 20))}
                ]
                preds[str(t)][key] = [{"caption": pred_captions[p]}]
    return gts, preds, isxes


def sodac(
    iou_matrices: dict,
    scorer,
    pred_captions: Sequence[str],
    gt_captions: Sequence[str],
    splits: np.ndarray,
    iou_thresholds: Sequence[float] = (0.0,),
) -> dict:
    """SODA_c story-matching F-score (eval_dvc.py:317-347)."""
    if len(pred_captions) == 0:
        return {int(s): 0 for s in splits}
    res = {str(i): [p] for i, p in enumerate(pred_captions)}
    out = {}
    for split in sorted(set(int(s) for s in splits)):
        idx = np.where(np.asarray(splits) == split)[0]
        split_gt = [gt_captions[i] for i in idx]
        gts_per_row = [{k: [g] for k in res} for g in split_gt]
        # NOTE reference arg order (eval_dvc.py:337): compute_score(res, gt)
        # — predictions are the scorer's REFS side (they set the CIDEr IDF
        # corpus), the GT caption is the hypothesis.  Asymmetric scorers make
        # the order numerically significant; cross-validated in
        # tests/test_metrics_vs_reference.py.
        score_matrix = np.array(
            [np.nan_to_num(scorer.compute_score(res, gt)[1]) for gt in gts_per_row]
        )
        iou_matrix = iou_matrices[split]
        fs = []
        for t in iou_thresholds:
            cur = np.copy(iou_matrix)
            cur[cur < t] = 0.0
            max_score, _ = dp_assignment(cur * score_matrix)
            n_g, n_p = cur.shape
            p = max_score / n_p
            r = max_score / n_g
            fs.append(2 * p * r / (p + r) if p + r > 0 else 0)
        out[split] = float(np.mean(fs))
    return out


def evaluate_dense_captions(
    pred_segments: list,
    gt_segments: list,
    pred_captions: list,
    gt_captions: list,
    splits: list,
    keys: list,
    iou_thresholds: Sequence[float] = IOU_THRESHOLDS,
    soda: bool = True,
    seed: int = 42,
) -> dict:
    """Corpus evaluation: one result-list entry per video (eval_dvc.py:350-512)."""
    assert len(pred_segments) == len(gt_segments) == len(pred_captions) \
        == len(gt_captions) == len(splits) == len(keys)
    rng = random.Random(seed)
    tokenizer = PTBTokenizer()
    cider = Cider()
    meteor = make_meteor()

    # match + flatten for one-shot tokenization
    gts_all = {str(t): {} for t in iou_thresholds}
    preds_all = {str(t): {} for t in iou_thresholds}
    vid2isx = {str(t): {} for t in iou_thresholds}
    for ps, gs, pc, gc, key in zip(pred_segments, gt_segments, pred_captions, gt_captions, keys):
        g, p, isxes = match_captions(ps, gs, pc, gc, iou_thresholds, rng)
        for t in iou_thresholds:
            for k, v in g[str(t)].items():
                gts_all[str(t)][f"{key}_{k}"] = v
            for k, v in p[str(t)].items():
                preds_all[str(t)][f"{key}_{k}"] = v
            vid2isx[str(t)][key] = isxes[str(t)]
    for t in iou_thresholds:
        gts_all[str(t)] = tokenizer.tokenize(gts_all[str(t)])
        preds_all[str(t)] = tokenizer.tokenize(preds_all[str(t)])

    # tokenized raw caption lists for SODA
    pred_tok = [
        [tokenizer.tokenize_sentence(c) for c in caps] for caps in pred_captions
    ]
    gt_tok = [
        [tokenizer.tokenize_sentence(c) for c in caps] for caps in gt_captions
    ]

    metrics = collections.defaultdict(list)
    for i, key in enumerate(keys):
        precision, recall, iou_matrices = evaluate_detections(
            np.asarray(pred_segments[i]), np.asarray(gt_segments[i]),
            np.asarray(splits[i]), iou_thresholds,
        )
        scorers = {"CIDER": cider, "METEOR": meteor}
        for name, scorer in scorers.items():
            vals = []
            for t in iou_thresholds:
                sub_g = {
                    str(k): gts_all[str(t)][f"{key}_{k}"]
                    for k in vid2isx[str(t)][key]
                }
                sub_p = {
                    str(k): preds_all[str(t)][f"{key}_{k}"]
                    for k in vid2isx[str(t)][key]
                }
                if not sub_g or not sub_p:
                    vals.append(0.0)
                else:
                    vals.append(float(np.nan_to_num(scorer.compute_score(sub_g, sub_p)[0])))
            metrics[name].append(float(np.mean(vals)))
        if soda:
            fs = sodac(iou_matrices, meteor, pred_tok[i], gt_tok[i], np.asarray(splits[i]))
            for split, v in fs.items():
                metrics[f"SODA_c_{split}"].append(v)

        mp = float(np.mean(precision))
        mr = float(np.mean(recall))
        for j, t in enumerate(iou_thresholds):
            metrics[f"Precision@{t}"].append(float(precision[j]))
            metrics[f"Recall@{t}"].append(float(recall[j]))
        metrics["Precision_Mean"].append(mp)
        metrics["Recall_Mean"].append(mr)
        metrics["F1_Score"].append(2 * mp * mr / (mp + mr) if mp + mr > 0 else 0.0)
        metrics["n_preds"].append(len(pred_captions[i]))
        metrics["key"].append(key)

    meteor.close()
    if getattr(meteor, "approximate", False):
        metrics["meteor_is_approximate"] = [True]
    return dict(metrics)


def parse_sent(sent: str) -> list[str]:
    return re.sub("[^a-zA-Z]", " ", sent).strip().lower().split()


def evaluate_para(pred_paragraphs: list[str], gt_paragraphs: list[list[str]]) -> dict:
    """Paragraph-level corpus CIDEr/METEOR (eval_dvc.py:601-635)."""
    cider = Cider()
    meteor = make_meteor()
    gts, preds = {}, {}
    for i, (p, gs) in enumerate(zip(pred_paragraphs, gt_paragraphs)):
        preds[str(i)] = [" ".join(parse_sent(p))]
        gts[str(i)] = [" ".join(parse_sent(g)) for g in gs]
    out = {
        "Para_CIDER": float(np.nan_to_num(cider.compute_score(gts, preds)[0])),
        "Para_METEOR": float(np.nan_to_num(meteor.compute_score(gts, preds)[0])),
    }
    meteor.close()
    return out


def eval_with_files(pred_file: str, gt_file: str, seed: int = 42) -> dict:
    """File entry point matching the reference CLI (eval_dvc.py:638-753)."""
    import json

    smap = {"train": 1, "val": 2, "test": 3}
    with open(pred_file) as f:
        pred_data = json.load(f)
    with open(gt_file) as f:
        gt_data = json.load(f)["annotations"]
    split = smap.get(gt_file.split("/")[-1].split(".")[0], 2)

    keys, gt_segments, gt_captions, gt_paras, splits = [], [], [], [], []
    for j in gt_data:
        key = j["image_id"].split("/")[-1]
        if "pure_cap" in j:  # youcook2
            caps = j["pure_cap"].split(". ")
        else:  # activitynet
            caps = [c.strip(" ") for c in j["caption"].split(".") if len(c) > 5]
        caps = [c + "." for c in caps]
        if len(j["segments"]) != len(caps):
            continue
        keys.append(key)
        gt_segments.append(np.asarray(j["segments"]))
        gt_captions.append(caps)
        splits.append(np.asarray([split] * len(caps)))
        gt_paras.append([" ".join(caps)])

    p_keys, p_segments, p_captions, p_paras = [], [], [], []
    n_gt_segments, n_gt_captions, n_splits, n_paras = [], [], [], []
    for i, vid in enumerate(keys):
        if vid not in pred_data:
            continue
        events = pred_data[vid]
        p_keys.append(vid)
        n_gt_segments.append(gt_segments[i])
        n_gt_captions.append(gt_captions[i])
        n_splits.append(splits[i])
        n_paras.append(gt_paras[i])
        p_captions.append([e["caption"] for e in events])
        p_segments.append(np.asarray([e["timestamp"] for e in events]).reshape(-1, 2))
        p_paras.append(". ".join(e["caption"] for e in events))

    results = {}
    results.update(evaluate_para(p_paras, n_paras))
    dense = evaluate_dense_captions(
        p_segments, n_gt_segments, p_captions, n_gt_captions, n_splits, p_keys,
        seed=seed,
    )
    for k, v in dense.items():
        if k in ("key",):
            continue
        if k == "n_preds":
            results[k] = float(np.mean(v))
        elif isinstance(v, list) and v and isinstance(v[0], (int, float)):
            results[k] = float(np.mean(v)) * 100
        else:
            results[k] = v
    return results
