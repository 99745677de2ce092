"""BLEU and ROUGE-L caption scorers (pure python).

The port's copy of ``trace_tpu/metrics/bleu_rouge.py``.

The reference's ActivityNet DVC variant scores with pycocoevalcap's
Bleu/Rouge/Meteor/CIDEr (metrics/dvc/eval_dvc_anet.py:69-76); that package is
not available here, so these implement the same published algorithms:

* BLEU: smoothed corpus BLEU with the closest-reference brevity penalty
  (the pycocoevalcap/NLTK formulation).
* ROUGE-L: LCS-based F-measure with beta = 1.2 (Lin 2004; pycocoevalcap's
  Rouge()).
"""

from __future__ import annotations

import collections
import math
from typing import Mapping, Sequence

import numpy as np


def _ngrams(tokens: Sequence[str], n: int) -> collections.Counter:
    return collections.Counter(
        tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)
    )


class Bleu:
    """Corpus BLEU-1..N over {key: [sent]} dicts; returns per-n corpus scores
    and per-key sentence scores like the pycocoevalcap protocol."""

    def __init__(self, n: int = 4):
        self.n = n

    def compute_score(self, gts: Mapping, res: Mapping):
        assert sorted(gts.keys()) == sorted(res.keys())
        keys = sorted(gts.keys())

        match = np.zeros(self.n)
        total = np.zeros(self.n)
        hyp_len = 0
        ref_len = 0
        per_key = [[] for _ in range(self.n)]

        for k in keys:
            hyp = _text(res[k][0]).split()
            refs = [_text(r).split() for r in gts[k]]
            hyp_len += len(hyp)
            ref_len += min((abs(len(r) - len(hyp)), len(r)) for r in refs)[1]
            sent_scores = []
            for i in range(1, self.n + 1):
                h = _ngrams(hyp, i)
                best = collections.Counter()
                for r in refs:
                    rn = _ngrams(r, i)
                    for ng in h:
                        best[ng] = max(best[ng], min(h[ng], rn.get(ng, 0)))
                m = sum(best.values())
                t = max(sum(h.values()), 0)
                match[i - 1] += m
                total[i - 1] += t
                sent_scores.append((m + 1e-9) / (t + 1e-9))
            bp_s = (
                1.0 if len(hyp) >= min(len(r) for r in refs)
                else math.exp(1 - min(len(r) for r in refs) / max(len(hyp), 1))
            )
            acc = 1.0
            for i in range(self.n):
                acc *= sent_scores[i]
                per_key[i].append(bp_s * acc ** (1.0 / (i + 1)))

        bp = 1.0 if hyp_len >= ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
        scores = []
        acc = 1.0
        for i in range(self.n):
            p = (match[i] + 1e-9) / (total[i] + 1e-9)
            acc *= p
            scores.append(bp * acc ** (1.0 / (i + 1)))
        return scores, [np.asarray(s) for s in per_key]


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


class RougeL:
    """ROUGE-L F-measure, beta=1.2, max over references."""

    beta = 1.2

    def compute_score(self, gts: Mapping, res: Mapping):
        assert sorted(gts.keys()) == sorted(res.keys())
        keys = sorted(gts.keys())
        scores = []
        for k in keys:
            hyp = _text(res[k][0]).split()
            best = 0.0
            for r in gts[k]:
                ref = _text(r).split()
                lcs = _lcs_len(hyp, ref)
                if lcs == 0:
                    continue
                prec = lcs / len(hyp) if hyp else 0.0
                rec = lcs / len(ref) if ref else 0.0
                if prec and rec:
                    f = ((1 + self.beta ** 2) * prec * rec) / (
                        rec + self.beta ** 2 * prec
                    )
                    best = max(best, f)
            scores.append(best)
        arr = np.asarray(scores)
        return float(np.mean(arr)) if len(arr) else 0.0, arr


def _text(x):
    if isinstance(x, dict):
        return x["caption"]
    return x
