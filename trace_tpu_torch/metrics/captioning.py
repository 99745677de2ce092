"""Caption scoring: CIDEr, METEOR, and PTB-style tokenization.

The port's copy of ``trace_tpu/metrics/captioning.py``.

* CIDEr: pure-python implementation of the consensus TF-IDF metric (same math
  as the densevid_eval scorer vendored by the reference,
  trace/metrics/dvc/metrics/cider_scorer.py — n<=4 grams, idf from the ref
  corpus, per-n cosine with clipping, length gaussian, x10).
* METEOR: the reference shells out to meteor-1.5.jar over a stdin/stdout line
  protocol (metrics/meteor.py:39-65); the jar is a missing large blob even in
  the reference checkout (.MISSING_LARGE_BLOBS:3).  We keep the same
  subprocess wrapper when a jar + JRE are available and otherwise fall back
  to a native METEOR (real stage-wise alignment + fragmentation penalty,
  metrics/meteor_align.py) so the pipeline runs everywhere; fallback scores
  stay labeled `approximate` (no synonym/paraphrase data modules here).
* PTB tokenizer: pure-python approximation of the Stanford corenlp
  PTBTokenizer subprocess (metrics/ptbtokenizer.py) — lowercase, split
  punctuation, drop the same punctuation list.  Deterministic and testable;
  no Java.
"""

from __future__ import annotations

import collections
import math
import os
import re
import shutil
import subprocess
import threading
from typing import Mapping, Sequence

import numpy as np

# Punctuation dropped by the reference's PTBTokenizer (ptbtokenizer.py:18-19).
PUNCTUATIONS = {
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
}

_TOKEN_RE = re.compile(r"[a-z0-9]+(?:'[a-z0-9]+)?|[^\sa-z0-9]")


class PTBTokenizer:
    """Deterministic PTB-style tokenizer (corenlp approximation)."""

    def tokenize(self, captions: Mapping[str, list]) -> dict[str, list[str]]:
        """{key: [{'caption': str}, ...]} -> {key: [tokenized_str, ...]}
        (the reference's dict protocol, ptbtokenizer.py:43-92)."""
        out: dict[str, list[str]] = {}
        for key, entries in captions.items():
            out[key] = [self.tokenize_sentence(e["caption"]) for e in entries]
        return out

    @staticmethod
    def tokenize_sentence(text: str) -> str:
        tokens = _TOKEN_RE.findall(text.lower())
        return " ".join(t for t in tokens if t not in PUNCTUATIONS)


def _ngram_counts(sentence: str, n: int = 4) -> collections.Counter:
    words = sentence.split()
    counts: collections.Counter = collections.Counter()
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i : i + k])] += 1
    return counts


class Cider:
    """Corpus-consensus CIDEr over {key: [sent...]} dicts.

    compute_score(gts, res) -> (corpus_mean, per_key_scores), matching the
    vendored scorer's protocol (metrics/cider.py:17-62).
    """

    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma

    def compute_score(self, gts: Mapping, res: Mapping):
        assert sorted(gts.keys()) == sorted(res.keys())
        keys = sorted(gts.keys())
        crefs = [[_ngram_counts(_text(r), self.n) for r in gts[k]] for k in keys]
        ctests = [_ngram_counts(_text(res[k][0]), self.n) for k in keys]

        doc_freq: collections.Counter = collections.Counter()
        for refs in crefs:
            for ngram in set(ng for ref in refs for ng in ref):
                doc_freq[ngram] += 1
        ref_len = np.log(float(len(crefs)))

        def to_vec(cnts):
            vec = [collections.defaultdict(float) for _ in range(self.n)]
            norm = [0.0] * self.n
            length = 0
            for ngram, tf in cnts.items():
                df = np.log(max(1.0, doc_freq[ngram]))
                idx = len(ngram) - 1
                vec[idx][ngram] = float(tf) * (ref_len - df)
                norm[idx] += vec[idx][ngram] ** 2
                if idx == 1:
                    length += tf
            return vec, [math.sqrt(x) for x in norm], length

        scores = []
        for test, refs in zip(ctests, crefs):
            v_t, n_t, l_t = to_vec(test)
            total = np.zeros(self.n)
            for ref in refs:
                v_r, n_r, l_r = to_vec(ref)
                delta = float(l_t - l_r)
                val = np.zeros(self.n)
                for i in range(self.n):
                    for ngram in v_t[i]:
                        val[i] += min(v_t[i][ngram], v_r[i][ngram]) * v_r[i][ngram]
                    if n_t[i] != 0 and n_r[i] != 0:
                        val[i] /= n_t[i] * n_r[i]
                    val[i] *= math.e ** (-(delta ** 2) / (2 * self.sigma ** 2))
                total += val
            score = np.mean(total) / max(len(refs), 1) * 10.0
            scores.append(score)
        scores = np.asarray(scores)
        return float(np.mean(scores)) if len(scores) else 0.0, scores


def _text(x) -> str:
    if isinstance(x, dict):
        return x["caption"]
    return x


class MeteorUnavailable(RuntimeError):
    pass


class Meteor:
    """meteor-1.5.jar line-protocol wrapper (reference metrics/meteor.py)."""

    def __init__(self, jar_path: str | None = None, java_bin: str | None = None):
        jar = jar_path or os.environ.get("METEOR_JAR", "")
        java = java_bin or os.environ.get("JRE_BIN_JAVA", "java")
        if not jar or not os.path.exists(jar) or shutil.which(java) is None:
            raise MeteorUnavailable(
                "meteor jar or java runtime not found; set METEOR_JAR"
            )
        cmd = [java, "-jar", "-Xmx2G", jar, "-", "-", "-stdio", "-l", "en", "-norm"]
        self._p = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        self._lock = threading.Lock()

    def compute_score(self, gts: Mapping, res: Mapping):
        with self._lock:
            assert sorted(gts.keys()) == sorted(res.keys())
            keys = sorted(gts.keys())
            stats = []
            for k in keys:
                hypo = _text(res[k][0]).replace("|||", "").replace("  ", " ")
                refs = " ||| ".join(_text(r) for r in gts[k])
                line = f"SCORE ||| {refs} ||| {hypo}"
                self._p.stdin.write((line + "\n").encode())
                self._p.stdin.flush()
                stats.append(self._p.stdout.readline().decode().strip())
            self._p.stdin.write(("EVAL ||| " + " ||| ".join(stats) + "\n").encode())
            self._p.stdin.flush()
            scores = [float(self._p.stdout.readline()) for _ in keys]
            final = float(self._p.stdout.readline())
        return final, np.asarray(scores)

    def close(self):
        try:
            self._p.stdin.close()
            self._p.stdout.close()
            self._p.kill()
            self._p.wait()
        except Exception:
            pass


class MeteorFallback:
    """Native METEOR (metrics/meteor_align.py): stage-wise exact+stem
    alignment, fragmentation penalty, original-METEOR parameters
    (Lavie & Agarwal 2007), and jar-style corpus aggregation over summed
    sufficient statistics.  Cross-validated to 1e-9 against nltk's METEOR
    (tests/test_metrics_vs_reference.py) — the real metric, not a
    unigram-F stand-in.

    Still flagged ``approximate`` relative to the jar because (a) the
    synonym/paraphrase modules need WordNet / paraphrase-table data files
    absent here (fewer match modules => scores lower-bound the jar's) and
    (b) the jar applies the meteor-1.5 'en' parameter family whose penalty
    normalization cannot be verified without the jar (see
    meteor_align.M15_EN_PARAMS)."""

    approximate = True

    def __init__(self, params=None):
        from trace_tpu_torch.metrics.meteor_align import (
            NLTK_PARAMS,
            score_from_stats,
            sentence_meteor,
        )
        from trace_tpu_torch.metrics.meteor_align import _porter

        self._params = params or NLTK_PARAMS
        self._sentence = sentence_meteor
        self._from_stats = score_from_stats
        self._stemmer = _porter()

    def compute_score(self, gts: Mapping, res: Mapping):
        from trace_tpu_torch.metrics.meteor_align import SegmentStats

        assert sorted(gts.keys()) == sorted(res.keys())
        keys = sorted(gts.keys())
        scores = []
        agg = np.zeros(6)
        for k in keys:
            hypo = _text(res[k][0]).split()
            refs = [_text(r).split() for r in gts[k]]
            refs = [r for r in refs if r]
            if not hypo or not refs:
                scores.append(0.0)
                continue
            sc, stats = self._sentence(
                hypo, refs, self._params, stemmer=self._stemmer
            )
            scores.append(sc)
            if stats is not None:
                agg += np.asarray(list(stats), np.float64)
        arr = np.asarray(scores) if scores else np.zeros(0)
        # corpus score from summed statistics (the jar's EVAL semantics),
        # not the mean of segment scores
        final = (
            self._from_stats(SegmentStats(*agg), self._params) if len(arr) else 0.0
        )
        return final, arr

    def close(self):
        pass


def make_meteor():
    """Prefer the jar; degrade to the labeled approximation (loudly)."""
    import sys

    try:
        return Meteor()
    except MeteorUnavailable:
        print(
            "WARNING: meteor-1.5.jar not available (set METEOR_JAR + a JRE) — "
            "using the native exact+stem alignment METEOR. Values in "
            "this run are NOT comparable to published numbers "
            "(outputs carry meteor_is_approximate=True).",
            file=sys.stderr,
            flush=True,
        )
        return MeteorFallback()
