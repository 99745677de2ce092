"""The port's metrics (trace_tpu_torch.metrics) against the JAX package's
(trace_tpu.metrics) on the same inputs, made from seeds with numpy.

Tolerance: equal. Both packages run the same Python and numpy arithmetic on
the same inputs, so every number, list and dict must be the same, NaN where
the other has NaN. The one exception is ``binary_ap``: the port computes its
precision-recall curve itself where the JAX package calls scikit-learn's, so
it is held within 1e-12 absolute (the same float64 sums in the same order;
measured equal on these inputs).
"""

import importlib
import json
import os
import random
import stat
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
BINARY_AP_TOL = 1e-12


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.metrics.{name}")


def assert_same(got, want, path="result"):
    """Equal structure and values; NaN equals NaN."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), f"{path}: keys"
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), f"{path}: length"
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, f"{path}: dtype"
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, float) and np.isnan(want):
        assert isinstance(got, float) and np.isnan(got), f"{path}: {got} vs nan"
    else:
        assert type(got) is type(want) and got == want, f"{path}: {got!r} vs {want!r}"


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

VOCAB = ("cook stir the pan add oil onion chop season salt pepper heat serve plate "
         "garnish slowly slicing sliced cooks stirred adding chopped heated serving "
         "garnished quickly then and a with until golden brown").split()


def _sentence(rng, lo=3, hi=12, punct=True):
    words = [VOCAB[int(rng.integers(len(VOCAB)))] for _ in range(int(rng.integers(lo, hi)))]
    s = " ".join(words)
    return (s.capitalize() + rng.choice([".", "!", ", then.", "?"])) if punct else s


def _caption_dicts(seed, n=12, refs=3):
    rng = np.random.default_rng(seed)
    gts = {str(i): [_sentence(rng, punct=False) for _ in range(int(rng.integers(1, refs + 1)))]
           for i in range(n)}
    res = {str(i): [_sentence(rng, punct=False)] for i in range(n)}
    return gts, res


def _windows(rng, k, tmax=100.0):
    out = []
    for _ in range(k):
        s = float(rng.uniform(0, tmax * 0.8))
        out.append([round(s, 2), round(s + float(rng.uniform(0.5, tmax * 0.4)), 2)])
    return out


def _tvg_data(seed=0, n=40):
    rng = np.random.default_rng(seed)
    gt, preds = {}, {}
    for i in range(n):
        s = float(rng.uniform(0, 80))
        e = s + float(rng.uniform(1, 40))
        gt[i] = [round(s, 2), round(e, 2)]
        if i % 9 == 5:
            preds[i] = {}  # a prediction without a timestamp
            continue
        ps = max(0.0, s + float(rng.normal(0, 8)))
        pe = ps + max(0.5, (e - s) + float(rng.normal(0, 8)))
        preds[i] = {"timestamp": [round(ps, 2), round(pe, 2)]}
    return preds, gt


def _vhd_data(seed=1, n=18):
    rng = np.random.default_rng(seed)
    lengths = [4.0, 20.0, 50.0]  # short, middle and long windows
    sub, gt = [], []
    for q in range(n):
        duration = 150
        num_clips = duration // 2
        windows = []
        for w in range(1 + q % 2):
            ln = lengths[(q + w) % 3] + 2 * int(rng.integers(0, 3))
            s = 2 * int(rng.integers(0, (duration - ln) // 2))
            windows.append([float(s), float(s + ln)])
        rel_ids = sorted(rng.choice(num_clips, size=5, replace=False).tolist())
        gt.append({"qid": q, "query": f"q{q}", "vid": f"v{q}", "duration": duration,
                   "relevant_windows": windows, "relevant_clip_ids": rel_ids,
                   "saliency_scores": rng.integers(0, 5, size=(5, 3)).tolist()})
        pw = []
        for w in range(4):
            ln = lengths[(q + w) % 3] + float(rng.normal(0, 4))
            s = float(rng.uniform(0, max(1.0, duration - max(ln, 1))))
            pw.append([round(s, 2), round(s + max(ln, 1.0), 2), round(float(rng.uniform(0, 1)), 4)])
        sub.append({"qid": q, "query": f"q{q}", "vid": f"v{q}", "pred_relevant_windows": pw,
                    # rounded to one decimal: ties among the clips' scores
                    "pred_saliency_scores": rng.uniform(0, 1, size=num_clips).round(
                        1 if q % 3 == 0 else 4).tolist()})
    return sub, gt


def _dvc_corpus(seed=3, videos=6):
    """Per video: predicted and GT segments and captions, split ids, keys."""
    rng = np.random.default_rng(seed)
    ps, gs, pc, gc, sp, keys = [], [], [], [], [], []
    for v in range(videos):
        n_gt, n_pred = int(rng.integers(1, 5)), int(rng.integers(0 if v == 2 else 1, 6))
        gs.append(np.asarray(_windows(rng, n_gt)))
        ps.append(np.asarray(_windows(rng, n_pred)).reshape(-1, 2))
        gc.append([_sentence(rng) for _ in range(n_gt)])
        pc.append([_sentence(rng) for _ in range(n_pred)])
        sp.append(np.asarray([2] * n_gt))
        keys.append(f"vid{v}")
    return ps, gs, pc, gc, sp, keys


def _dvc_files(tmp, seed=4, videos=6):
    """A {split}.caption_coco_format.json (youcook2 ``pure_cap`` and
    activitynet ``caption`` records, one whose caption count does not match
    its segments) and a reformatted prediction file."""
    rng = np.random.default_rng(seed)
    anno, pred = [], {}
    for v in range(videos):
        n = int(rng.integers(1, 4))
        caps = [_sentence(rng, 4, 10, punct=False) for _ in range(n)]
        rec = {"image_id": f"dir/vid{v}.mp4", "id": v, "segments": _windows(rng, n),
               "duration": 120.0}
        if v % 2:
            rec["caption"] = ". ".join(caps) + "."
        else:
            rec["pure_cap"] = ". ".join(caps)
            rec["caption"] = rec["pure_cap"]
        if v == 3:
            rec["segments"] = rec["segments"] + [[1.0, 2.0]]  # dropped: counts differ
        anno.append(rec)
        if v != 5:  # vid5 has no prediction
            pred[f"vid{v}.mp4"] = [{"caption": _sentence(rng), "timestamp": w}
                                   for w in _windows(rng, int(rng.integers(1, 5)))]
    gt_file, pred_file = tmp / "val.caption_coco_format.json", tmp / "pred.json"
    gt_file.write_text(json.dumps({"annotations": anno}))
    pred_file.write_text(json.dumps(pred))
    return str(pred_file), str(gt_file)


def _anet_data(seed=5, videos=5):
    rng = np.random.default_rng(seed)
    preds, gt = {}, {}
    for v in range(videos):
        n = int(rng.integers(1, 4))
        gt[f"v{v}"] = {"timestamps": _windows(rng, n),
                       "sentences": [_sentence(rng) for _ in range(n)]}
        preds[f"v{v}"] = [{"timestamp": w, "caption": _sentence(rng)}
                          for w in _windows(rng, int(rng.integers(0 if v == 1 else 1, 5)))]
    preds["unknown"] = [{"timestamp": [0.0, 1.0], "caption": "not in the ground truth"}]
    return preds, gt


def _detections(seed=6):
    rng = np.random.default_rng(seed)
    gt, pred = [], []
    for v in range(5):
        for w in _windows(rng, int(rng.integers(1, 4))):
            gt.append({"video-id": f"v{v}", "t-start": w[0], "t-end": w[1]})
        for w in _windows(rng, int(rng.integers(0, 5))):
            pred.append({"video-id": f"v{v}", "t-start": w[0], "t-end": w[1],
                         "score": round(float(rng.uniform()), 2)})
    pred.append({"video-id": "v9", "t-start": 1.0, "t-end": 3.0, "score": 0.5})  # no GT
    return gt, pred


# ---------------------------------------------------------------------------
# the cases: name -> f(pkg) giving a result of plain values and arrays
# ---------------------------------------------------------------------------

def _window_iou(pkg):
    rng = np.random.default_rng(10)
    f = mod(pkg, "temporal").window_iou
    pairs = [(_windows(rng, 1)[0], _windows(rng, 1)[0]) for _ in range(50)]
    pairs += [([1.0, 1.0], [1.0, 1.0]), ([0.0, 2.0], [3.0, 4.0])]
    return [f(a, b) for a, b in pairs]


def _temporal_iou(pkg):
    rng = np.random.default_rng(11)
    t = mod(pkg, "temporal")
    a, b = np.asarray(_windows(rng, 30)), np.asarray(_windows(rng, 30))
    a[3] = b[3] = [5.0, 5.0]  # an empty hull
    return [t.temporal_iou_paired(a, b), t.temporal_iou_cross(a, b[:7])]


def _voc_ap(pkg):
    rng = np.random.default_rng(12)
    f = mod(pkg, "temporal").voc_interpolated_ap
    out = []
    for n in (1, 5, 40):
        recall = np.sort(rng.uniform(size=n))
        out.append(f(rng.uniform(size=n), recall))
    return out


def _detection_ap(pkg):
    gt, pred = _detections()
    f = mod(pkg, "temporal").detection_ap
    return [f(gt, pred), f(gt, []), f(gt, pred, np.asarray([0.1, 0.3]))]


def _tvg(pkg):
    preds, gt = _tvg_data()
    return mod(pkg, "tvg").evaluate_tvg(preds, gt)


def _tvg_file(pkg, tmp):
    preds, gt = _tvg_data(seed=1)
    path = tmp / "tvg_gt.json"
    path.write_text(json.dumps({"annotations": [{"id": k, "timestamp": v} for k, v in gt.items()]}))
    return mod(pkg, "tvg").load_tvg_ground_truth(str(path))


def _vhd(pkg):
    sub, gt = _vhd_data()
    return json.loads(json.dumps(mod(pkg, "vhd").eval_submission(sub, gt)))


def _vhd_highlights_only(pkg):
    sub, gt = _vhd_data(seed=2, n=7)
    sub = [{k: v for k, v in s.items() if k != "pred_relevant_windows"} for s in sub]
    return json.loads(json.dumps(mod(pkg, "vhd").eval_submission(sub, gt)))


def _bleu(pkg):
    gts, res = _caption_dicts(20)
    return list(mod(pkg, "bleu_rouge").Bleu(4).compute_score(gts, res))


def _rouge(pkg):
    gts, res = _caption_dicts(21)
    return list(mod(pkg, "bleu_rouge").RougeL().compute_score(gts, res))


def _ptb(pkg):
    rng = np.random.default_rng(22)
    caps = {str(i): [{"caption": _sentence(rng) + " It's -- a (test) ... ok; ``x''"}]
            for i in range(6)}
    return mod(pkg, "captioning").PTBTokenizer().tokenize(caps)


def _cider(pkg):
    gts, res = _caption_dicts(23)
    return list(mod(pkg, "captioning").Cider().compute_score(gts, res))


def _sentence_meteor(pkg):
    rng = np.random.default_rng(24)
    ma = mod(pkg, "meteor_align")
    out = []
    for _ in range(20):
        hyp = _sentence(rng, punct=False).split()
        refs = [_sentence(rng, punct=False).split() for _ in range(2)] + [list(hyp[1:])]
        for params in (ma.NLTK_PARAMS, ma.M15_EN_PARAMS):
            score, stats = ma.sentence_meteor(hyp, refs, params)
            out.append((score, None if stats is None else tuple(stats)))
    return out


def _meteor_fallback(pkg):
    gts, res = _caption_dicts(25)
    gts["empty"], res["empty"] = ["a reference"], [""]
    return list(mod(pkg, "captioning").MeteorFallback().compute_score(gts, res))


def _dp_assignment(pkg):
    rng = np.random.default_rng(26)
    f = mod(pkg, "dvc").dp_assignment
    return [f(rng.uniform(size=shape)) for shape in ((1, 1), (3, 5), (6, 2), (7, 7))]


def _evaluate_detections(pkg):
    ps, gs, _, _, _, _ = _dvc_corpus()
    f = mod(pkg, "dvc").evaluate_detections
    splits = np.asarray([1, 2, 2, 1])
    return [f(ps[0], gs[3][:1].repeat(4, 0) + np.arange(4)[:, None], splits),
            f(ps[1], gs[1], np.asarray([2] * len(gs[1])))]


def _sodac(pkg):
    ps, gs, pc, gc, sp, _ = _dvc_corpus(seed=7)
    dvc, cap = mod(pkg, "dvc"), mod(pkg, "captioning")
    out = []
    for i in range(len(ps)):
        _, _, ious = dvc.evaluate_detections(ps[i], gs[i], sp[i])
        for scorer in (cap.Cider(), cap.MeteorFallback()):
            out.append(dvc.sodac(ious, scorer, pc[i], gc[i], sp[i]))
    return out


def _match_captions(pkg):
    ps, gs, pc, gc, _, _ = _dvc_corpus(seed=8)
    rng = random.Random(42)
    return [mod(pkg, "dvc").match_captions(ps[i], gs[i], pc[i], gc[i], rng=rng)
            for i in range(len(ps))]


def _dense_captions(pkg):
    return mod(pkg, "dvc").evaluate_dense_captions(*_dvc_corpus(seed=9))


def _para(pkg):
    rng = np.random.default_rng(27)
    preds = [". ".join(_sentence(rng) for _ in range(3)) for _ in range(4)]
    gts = [[" ".join(_sentence(rng) for _ in range(2))] for _ in range(4)]
    return mod(pkg, "dvc").evaluate_para(preds, gts)


def _with_files(pkg, tmp):
    return mod(pkg, "dvc").eval_with_files(*_dvc_files(tmp))


def _anet(pkg):
    preds, gt = _anet_data()
    return mod(pkg, "dvc_anet").evaluate_anet_dvc(preds, gt)


CASES = {
    "window_iou": _window_iou,
    "temporal_iou_paired_and_cross": _temporal_iou,
    "voc_interpolated_ap": _voc_ap,
    "detection_ap": _detection_ap,
    "evaluate_tvg": _tvg,
    "load_tvg_ground_truth": _tvg_file,
    "eval_submission": _vhd,
    "eval_submission_highlights_only": _vhd_highlights_only,
    "Bleu": _bleu,
    "RougeL": _rouge,
    "PTBTokenizer": _ptb,
    "Cider": _cider,
    "dp_assignment": _dp_assignment,
    "evaluate_detections": _evaluate_detections,
    "match_captions": _match_captions,
    "evaluate_para": _para,
}
# the cases that score METEOR, each run with nltk's stemmer and with none
METEOR_CASES = {
    "sentence_meteor": _sentence_meteor,
    "MeteorFallback": _meteor_fallback,
    "sodac": _sodac,
    "evaluate_dense_captions": _dense_captions,
    "eval_with_files": _with_files,
    "evaluate_anet_dvc": _anet,
}


def _run(case, pkg, tmp):
    fn = {**CASES, **METEOR_CASES}[case]
    d = tmp / pkg
    d.mkdir(exist_ok=True)
    return fn(pkg, d) if fn.__code__.co_argcount == 2 else fn(pkg)


@pytest.fixture
def no_meteor_jar(monkeypatch):
    monkeypatch.delenv("METEOR_JAR", raising=False)


@pytest.mark.parametrize("case", sorted(CASES))
def test_metric_matches_jax(case, tmp_path, no_meteor_jar):
    assert_same(_run(case, "trace_tpu_torch", tmp_path), _run(case, "trace_tpu", tmp_path))


@pytest.mark.parametrize("stemmer", ["nltk", "identity"])
@pytest.mark.parametrize("case", sorted(METEOR_CASES))
def test_meteor_metric_matches_jax(case, stemmer, tmp_path, monkeypatch, no_meteor_jar):
    """The METEOR fallback stems with nltk's Porter stemmer where nltk is
    installed and not at all where it is not; both packages choose alike,
    and give the same numbers either way."""
    if stemmer == "nltk":
        pytest.importorskip("nltk")
    else:
        for pkg in ("trace_tpu", "trace_tpu_torch"):
            ma = mod(pkg, "meteor_align")
            monkeypatch.setattr(ma, "_porter", ma._IdentityStemmer)
    for pkg in ("trace_tpu", "trace_tpu_torch"):
        kind = type(mod(pkg, "meteor_align")._porter()).__name__
        assert kind == ("PorterStemmer" if stemmer == "nltk" else "_IdentityStemmer")
    got = _run(case, "trace_tpu_torch", tmp_path)
    assert_same(got, _run(case, "trace_tpu", tmp_path))
    # the flag as each scorer reports it (eval_with_files averages its list)
    flag = {"evaluate_dense_captions": [True], "eval_with_files": 100.0,
            "evaluate_anet_dvc": True}
    if case in flag:
        assert got["meteor_is_approximate"] == flag[case]


def test_make_meteor_warns_and_falls_back_as_jax(capsys, no_meteor_jar):
    made = {}
    for pkg in ("trace_tpu", "trace_tpu_torch"):
        m = mod(pkg, "captioning").make_meteor()
        made[pkg] = (type(m).__name__, m.approximate, capsys.readouterr().err)
    assert made["trace_tpu_torch"] == made["trace_tpu"]
    assert made["trace_tpu"][0] == "MeteorFallback" and "meteor-1.5.jar" in made["trace_tpu"][2]


FAKE_JAVA = r'''#!{python}
"""Answers meteor-1.5.jar's -stdio protocol: a SCORE line gets its word
counts, an EVAL line a score per segment and a corpus score."""
import sys
for line in sys.stdin:
    parts = [p.strip() for p in line.rstrip("\n").split("|||")]
    if parts[0] == "SCORE":
        print(f"{{len(parts[-1].split())}} {{sum(len(r.split()) for r in parts[1:-1])}}", flush=True)
    elif parts[0] == "EVAL":
        stats = [list(map(float, p.split())) for p in parts[1:]]
        for h, r in stats:
            print(h / (h + r), flush=True)
        print(sum(h for h, _ in stats) / sum(h + r for h, r in stats), flush=True)
'''


def test_meteor_jar_wrapper_matches_jax(tmp_path, monkeypatch):
    """The jar wrapper's line protocol, against a stand-in for the JRE that
    answers it: the same lines in, the same scores out, in both packages;
    and MeteorUnavailable in both without a jar."""
    java = tmp_path / "java"
    java.write_text(FAKE_JAVA.format(python=sys.executable))
    java.chmod(java.stat().st_mode | stat.S_IEXEC)
    jar = tmp_path / "meteor-1.5.jar"
    jar.write_bytes(b"")
    gts, res = _caption_dicts(28, n=5)
    gts["0"] = ["with ||| bars", "and  double  spaces"]
    out = {}
    for pkg in ("trace_tpu", "trace_tpu_torch"):
        cap = mod(pkg, "captioning")
        monkeypatch.delenv("METEOR_JAR", raising=False)
        with pytest.raises(cap.MeteorUnavailable):
            cap.Meteor()
        monkeypatch.setenv("METEOR_JAR", str(jar))
        monkeypatch.setenv("JRE_BIN_JAVA", str(java))
        m = cap.make_meteor()
        assert type(m).__name__ == "Meteor"
        out[pkg] = list(m.compute_score(gts, res))
        m.close()
    assert_same(out["trace_tpu_torch"], out["trace_tpu"])
    assert 0 < out["trace_tpu"][0] < 1


def _binary_inputs(kind):
    rng = np.random.default_rng({"random": 30, "tied": 31, "zeros": 32, "ones": 33,
                                 "float_labels": 34, "signed": 35, "short": 36}[kind])
    cases = []
    for n in (2, 3, 7, 40, 300):
        y = rng.integers(0, 2, n)
        s = rng.uniform(size=n)
        if kind == "tied":
            s = rng.integers(0, 4, n).astype(float) / 4
        elif kind == "zeros":
            y = np.zeros(n, int)
        elif kind == "ones":
            y = np.ones(n, int)
        elif kind == "float_labels":
            y = y.astype(float)
        elif kind == "signed":
            y = 2 * y - 1
        elif kind == "short":
            s = s.round(1)
        cases.append((y, s))
    return cases


@pytest.mark.parametrize("kind", ["random", "tied", "zeros", "ones", "float_labels",
                                  "signed", "short"])
def test_binary_ap_matches_jax(kind):
    """The port's own precision-recall curve against scikit-learn's, through
    ``binary_ap`` (interpolated and not), within BINARY_AP_TOL."""
    import warnings

    jt, tt = mod("trace_tpu", "temporal"), mod("trace_tpu_torch", "temporal")
    for y, s in _binary_inputs(kind):
        for interpolate in (True, False):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # sklearn: no positive label
                want = jt.binary_ap(y, s, interpolate)
            got = tt.binary_ap(y, s, interpolate)
            assert abs(got - want) <= BINARY_AP_TOL, (kind, y, s, got, want)


def test_precision_recall_curve_matches_sklearn():
    from sklearn.metrics import precision_recall_curve

    curve = mod("trace_tpu_torch", "temporal").precision_recall_curve
    for kind in ("random", "tied", "short"):
        for y, s in _binary_inputs(kind):
            p, r = curve(y, s)
            sp, sr, _ = precision_recall_curve(y, s)
            np.testing.assert_array_equal(p, sp)
            np.testing.assert_array_equal(r, sr)
    with pytest.raises(ValueError):
        curve(np.asarray([0, 2, 2]), np.asarray([0.1, 0.2, 0.3]))


def test_port_metrics_import_without_sklearn():
    """Every port metric module imports, and binary_ap computes, where
    scikit-learn cannot be imported (the card's machine has none)."""
    code = (
        "import sys\n"
        "sys.modules['sklearn'] = None\n"
        "import importlib, numpy as np\n"
        "for m in ('temporal', 'tvg', 'vhd', 'bleu_rouge', 'meteor_align', 'captioning',\n"
        "          'dvc', 'dvc_anet'):\n"
        "    importlib.import_module('trace_tpu_torch.metrics.' + m)\n"
        "from trace_tpu_torch.metrics.temporal import binary_ap\n"
        "print(binary_ap(np.array([0, 1, 1, 0]), np.array([0.1, 0.8, 0.4, 0.4])))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, env={**os.environ})
    assert float(out.stdout) == pytest.approx(0.8333333333333333, abs=BINARY_AP_TOL)
