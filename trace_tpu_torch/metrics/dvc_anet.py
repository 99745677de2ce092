"""ActivityNet-style dense captioning evaluator (densevid_eval protocol).

The port's copy of ``trace_tpu/metrics/dvc_anet.py``.

Reference: trace/metrics/dvc/eval_dvc_anet.py — per-IoU-threshold caption
scoring with the full scorer suite (Bleu1-4 / Rouge-L / Meteor / CIDEr) plus
recall/precision of the proposals, averaged over thresholds, and SODA via the
shared DP assignment.  Differs from eval_dvc.py mainly in the scorer set and
the multi-reference GT handling.
"""

from __future__ import annotations

import collections
from typing import Optional, Sequence

import numpy as np

from trace_tpu_torch.metrics.bleu_rouge import Bleu, RougeL
from trace_tpu_torch.metrics.captioning import Cider, PTBTokenizer, make_meteor
from trace_tpu_torch.metrics.dvc import segment_iou

IOU_THRESHOLDS = (0.3, 0.5, 0.7, 0.9)


def evaluate_anet_dvc(
    predictions: dict,       # vid -> [{'timestamp': [s,e], 'caption': str}]
    ground_truth: dict,      # vid -> {'timestamps': [[s,e]], 'sentences': [str]}
    iou_thresholds: Sequence[float] = IOU_THRESHOLDS,
    verbose: bool = False,
) -> dict:
    """densevid_eval scoring: for each threshold, match predictions to GT by
    IoU and score matched caption pairs with the full scorer suite; report
    the mean over thresholds plus proposal precision/recall."""
    tokenizer = PTBTokenizer()
    meteor = make_meteor()
    scorers = {
        "Bleu": Bleu(4),
        "ROUGE_L": RougeL(),
        "CIDEr": Cider(),
        "METEOR": meteor,
    }

    shared = sorted(set(predictions) & set(ground_truth))
    out = collections.defaultdict(list)

    for t in iou_thresholds:
        gts, res = {}, {}
        n_pred = 0
        n_gt = 0
        matched_pred = 0
        covered_gt = 0
        for vid in shared:
            preds = predictions[vid]
            gt = ground_truth[vid]
            n_pred += len(preds)
            n_gt += len(gt["timestamps"])
            gt_hit = set()
            for pi, p in enumerate(preds):
                refs = [
                    gt["sentences"][gi]
                    for gi, seg in enumerate(gt["timestamps"])
                    if segment_iou(p["timestamp"], seg) >= t
                ]
                hits = [
                    gi for gi, seg in enumerate(gt["timestamps"])
                    if segment_iou(p["timestamp"], seg) >= t
                ]
                if refs:
                    key = f"{vid}_{pi}"
                    gts[key] = [{"caption": r} for r in refs]
                    res[key] = [{"caption": p["caption"]}]
                    matched_pred += 1
                    gt_hit.update(hits)
            covered_gt += len(gt_hit)

        precision = matched_pred / max(n_pred, 1)
        recall = covered_gt / max(n_gt, 1)
        out["Precision"].append(precision)
        out["Recall"].append(recall)

        if not gts:
            for name in ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4",
                         "ROUGE_L", "CIDEr", "METEOR"):
                out[name].append(0.0)
            continue

        gts_tok = tokenizer.tokenize(gts)
        res_tok = tokenizer.tokenize(res)
        for name, scorer in scorers.items():
            score = scorer.compute_score(gts_tok, res_tok)[0]
            if name == "Bleu":
                for i, s in enumerate(score, 1):
                    out[f"Bleu_{i}"].append(float(np.nan_to_num(s)))
            else:
                out[name].append(float(np.nan_to_num(score)))

    meteor.close()
    result = {k: float(np.mean(v)) for k, v in out.items()}
    p, r = result.get("Precision", 0), result.get("Recall", 0)
    result["F1"] = 2 * p * r / (p + r) if p + r > 0 else 0.0
    if getattr(meteor, "approximate", False):
        result["meteor_is_approximate"] = True
    return result
