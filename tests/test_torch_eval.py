"""The port's evaluation layer (trace_tpu_torch.eval, task_prompts and
runtime.inference) against the JAX package's (trace_tpu.eval,
trace_tpu.task_prompts, scripts/inference/inference.py) on the tiny config:
the same weights (``from_jax_params``), ``ByteTokenizer`` on both sides, the
JAX side on the CPU. Records, scores and written files must be equal, the
greedy tokens exact; the fixtures follow tests/test_eval_real_formats.py's
schemas. Items in ``.mp4`` files run where the port's native decoder builds
and are skipped with the reason where it does not."""

import importlib.util
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trace_tpu.model.config import TraceConfig as JTraceConfig
from trace_tpu.model.trace_model import init_trace_params as jax_init
from trace_tpu.runtime.pipeline import TracePipeline as JaxPipeline
from trace_tpu.tokenizers.text import ByteTokenizer as JaxByteTokenizer
from trace_tpu_torch.model.config import TraceConfig
from trace_tpu_torch.params import from_jax_params
from trace_tpu_torch.runtime.pipeline import TracePipeline
from trace_tpu_torch.tokenizers.text import ByteTokenizer

ROOT = Path(__file__).resolve().parents[1]
JCFG = JTraceConfig.tiny()
CFG = TraceConfig.tiny()
T = CFG.num_frames
NEW = 16


def _native_decoder():
    """None where the port's native decoder builds, else why it does not."""
    from trace_tpu_torch.native import videodec

    try:
        videodec.load()
    except videodec.NativeDecoderUnavailable as e:
        return str(e).splitlines()[0]
    return None


NO_NATIVE = _native_decoder()
needs_native = pytest.mark.skipif(
    NO_NATIVE is not None,
    reason=f"the port reads .mp4 only through its native decoder: {NO_NATIVE}")


@pytest.fixture(scope="module")
def pipes():
    jp = jax_init(JCFG, jax.random.PRNGKey(0))
    # larger output heads: the greedy stream then crosses all three heads
    rng = np.random.default_rng(9)
    dec = dict(jp["decoder"])
    for name in ("lm_head", "sync_head", "time_head", "score_head"):
        dec[name] = jnp.asarray(rng.standard_normal(dec[name].shape).astype(np.float32))
    jp = {**jp, "decoder": dec}
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    return (JaxPipeline(params=jp, config=JCFG, tokenizer=JaxByteTokenizer()),
            TracePipeline(tp, CFG, ByteTokenizer(), device="cpu"))


@pytest.fixture
def streams(monkeypatch):
    """The greedy token ids each package hands its event parser, in order."""
    import trace_tpu.runtime.pipeline as jpl
    import trace_tpu_torch.runtime.pipeline as tpl

    seen = {"jax": [], "port": []}
    for side, m in (("jax", jpl), ("port", tpl)):
        def recording(ids, *a, _s=side, _f=m.decode_event_stream, **k):
            seen[_s].append([int(i) for i in ids])
            return _f(ids, *a, **k)
        monkeypatch.setattr(m, "decode_event_stream", recording)
    return seen


def _same_streams(streams, n=None):
    """Both packages parsed the same streams (n of them), none empty."""
    assert streams["port"] == streams["jax"] and streams["port"]
    assert n is None or len(streams["port"]) == n
    assert all(streams["port"])


def _both(name):
    """(JAX module, port module) of a dotted name under each package."""
    return (importlib.import_module(f"trace_tpu.{name}"),
            importlib.import_module(f"trace_tpu_torch.{name}"))


def _frames(seed, n=8, h=56, w=56):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def _write_mp4(path, n_frames=30, fps=10.0, w=64, h=48, seed=0):
    import cv2

    os.makedirs(os.path.dirname(str(path)), exist_ok=True)
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    assert vw.isOpened()
    rng = np.random.default_rng(seed)
    for _ in range(n_frames):
        vw.write(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
    vw.release()


def _write_frame_dir(path, n_frames=24, seed=0):
    from PIL import Image

    os.makedirs(str(path), exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(1, n_frames + 1):  # 1-indexed %05d.jpg, 3 fps dumps
        Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)).save(
            os.path.join(str(path), f"{i:05d}.jpg"))


VTT = """WEBVTT

00:00.000 --> 00:02.000
<c>Hello there</c>

00:02.000 --> 00:04.000
Hello there general

00:04.000 --> 00:06.000
Hello there general

1
00:00:06,000 --> 00:00:08,500
<i>Kenobi</i> you are a bold one indeed, a very bold one
"""


# ---------------------------------------------------------------------------
# task prompts, reformatters, subtitles, MCQA helpers
# ---------------------------------------------------------------------------

def test_task_prompts_match_jax():
    j, t = _both("task_prompts")
    assert t.TASK_PROMPTS == j.TASK_PROMPTS and t.TASK_TO_PROMPT == j.TASK_TO_PROMPT
    for task in j.TASK_TO_PROMPT:
        assert t.get_task_prompt(task) == j.get_task_prompt(task)
    j, t = _both("eval.evaluate")
    assert t.TASK_PROMPTS == j.TASK_PROMPTS


def _pred_records(seed=20, n=6):
    """fmt-style records: some events without a 2-value timestamp, some
    without scores, one video with none."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = 0 if i == 2 else int(rng.integers(1, 5))
        ts = [sorted(rng.uniform(0, 30, 2).round(1).tolist()) if j % 3 else
              [round(float(rng.uniform(0, 30)), 1)] for j in range(k)]
        out.append({"video": f"dir/v{i}.mp4", "id": i, "timestamps": ts,
                    "scores": [[float(rng.integers(1, 6))] for _ in range(k - i % 2)],
                    "captions": [f"event {i} {j}" for j in range(k)]})
    return out


@pytest.mark.parametrize("fn", ["reformat_dvc", "reformat_tvg", "reformat_vhd",
                                "clip_saliency_scores"])
def test_reformat_matches_jax(fn):
    j, t = _both("eval.reformat")
    recs = _pred_records()
    if fn == "reformat_vhd":
        gt = {f"v{i}.mp4": {"duration": 20.0 + i} for i in range(6)}
        args = (recs, gt)
    elif fn == "clip_saliency_scores":
        r = recs[3]
        args = (r["timestamps"] + [[], [40.0]], r["scores"] + [[1.0], [2.0]], 31.0)
    else:
        args = (recs,)
    assert getattr(t, fn)(*args) == getattr(j, fn)(*args)


@pytest.mark.parametrize("how", ["parse_vtt", "tokenizer", "words", "no_truncation"])
def test_subtitles_match_jax(how, tmp_path):
    j, t = _both("eval.subtitles")
    if how == "parse_vtt":
        assert t.parse_vtt(VTT) == j.parse_vtt(VTT)
        return
    path = tmp_path / "s.vtt"
    path.write_text(VTT)
    if how == "tokenizer":  # truncation through each package's tokenizer
        want = j.read_vtt_and_concatenate(str(path), JaxByteTokenizer(), max_len=20)
        got = t.read_vtt_and_concatenate(str(path), ByteTokenizer(), max_len=20)
    else:
        n = 5 if how == "words" else 4096
        want = j.read_vtt_and_concatenate(str(path), None, max_len=n)
        got = t.read_vtt_and_concatenate(str(path), None, max_len=n)
    assert got == want and got


MCQA_RECORD = {"question": "What happened after the person took the box?",
               "candidates": ["Closed the door.", "Sat on the sofa.", "Opened the window."],
               "answer": "Sat on the sofa."}
VIDEOMME_RECORD = {"question": "How many people appear?",
                   "options": ["A. one", "B. two", "C. three", "D. four"], "answer": "B"}
RESPONSES = ["(B) Sat on the sofa.", "b. two", "The answer is (c)", "nothing", "( a )",
             "Option D) four", "(A) (b)"]


@pytest.mark.parametrize("helper", ["constants", "segment_midpoint_indices", "qa",
                                    "extract_option", "check_ans"])
def test_mcqa_helpers_match_jax(helper):
    j, t = _both("eval.mcqa")
    if helper == "constants":
        for name in ("MVBENCH_SYSTEM", "MVBENCH_QUESTION_SUFFIX", "VIDEOMME_SYSTEM",
                     "VIDEOMME_QUESTION_SUFFIX", "MVBENCH_TASKS"):
            assert getattr(t, name) == getattr(j, name), name
    elif helper == "segment_midpoint_indices":
        for args, kw in [((8, 3.0, 23), {}), ((16, 30.0, 299), {"bound": (1.5, 7.2)}),
                         ((4, 3.0, 23), {"bound": (1.0, 7.0), "first_idx": 1}),
                         ((5, 25.0, 9), {"bound": (0.0, 100.0)})]:
            (gi, gts), (wi, wts) = t.segment_midpoint_indices(*args, **kw), \
                j.segment_midpoint_indices(*args, **kw)
            np.testing.assert_array_equal(gi, wi)
            assert gts == wts
    elif helper == "qa":
        assert t.mvbench_qa(MCQA_RECORD) == j.mvbench_qa(MCQA_RECORD)
        assert t.videomme_qa(VIDEOMME_RECORD) == j.videomme_qa(VIDEOMME_RECORD)
    elif helper == "extract_option":
        assert [t.extract_option(r) for r in RESPONSES] == [j.extract_option(r) for r in RESPONSES]
    else:
        gts = ["(B) Sat on the sofa.", "(A) one", "(C) three"]
        assert ([t.check_ans(r, g) for r in RESPONSES for g in gts]
                == [j.check_ans(r, g) for r in RESPONSES for g in gts])


@pytest.mark.parametrize("data_type", ["frame", pytest.param("video", marks=needs_native)])
def test_load_bounded_video_matches_jax(data_type, tmp_path):
    j, t = _both("eval.mcqa")
    if data_type == "frame":
        path = tmp_path / "frames"
        _write_frame_dir(path, seed=5)
    else:
        path = tmp_path / "clip.mp4"
        _write_mp4(path, seed=6)
    for bound in (None, (1.0, 2.5)):
        gf, gts = t._load_bounded_video(str(path), 6, bound, data_type)
        wf, wts = j._load_bounded_video(str(path), 6, bound, data_type)
        np.testing.assert_array_equal(gf, wf)
        assert gts == wts


# ---------------------------------------------------------------------------
# run_vtg_eval and score_results
# ---------------------------------------------------------------------------

def _vtg_dir(root, n=4):
    """n readable .npy videos, an annotation of a missing file, a junk .mp4
    (its header fails the pre-filter) and a junk .npy (it fails in the loader,
    after the pre-filter)."""
    vids = root / "videos"
    vids.mkdir(parents=True)
    anno = []
    for i in range(n):
        np.save(vids / f"v{i}.npy", _frames(i, n=8 + i, h=56 if i % 2 else 48))
        anno.append({"image_id": f"youcook/v{i}.npy", "caption": f"query number {i}", "id": i,
                     "timestamp": [0.0, 1.0]})
    (vids / "header_bad.mp4").write_bytes(b"junk")
    (vids / "stream_bad.npy").write_bytes(b"not a numpy file")
    for k, name in enumerate(("missing.npy", "header_bad.mp4", "stream_bad.npy")):
        anno.insert(1 + 2 * k, {"image_id": name, "caption": "q", "id": 100 + k,
                                "timestamp": [0, 1]})
    return anno, str(vids)


VTG_MODES = {  # run_vtg_eval's keywords per mode
    "two_phase": dict(batch_size=2),
    # above 8 rows a chunk the corpus splits prefill and decode: streamed
    "streamed": dict(batch_size=9, streamed=True),
    "batch": dict(batch_size=2, corpus_mode=False),
    "constrain_time": dict(batch_size=2, constrain_time=True),
}


@pytest.mark.parametrize("mode", sorted(VTG_MODES))
def test_run_vtg_eval_matches_jax(pipes, tmp_path, mode, capsys, streams):
    jpipe, tpipe = pipes
    j, t = _both("eval.evaluate")
    n = 10 if mode == "streamed" else 4
    anno, vids = _vtg_dir(tmp_path, n=n)
    task = "dvc" if mode == "constrain_time" else "tvg"
    kw = dict(num_frames=T, max_new_tokens=NEW, **VTG_MODES[mode])
    want = j.run_vtg_eval(jpipe, task, anno, vids, **kw)
    got = t.run_vtg_eval(tpipe, task, anno, vids, **kw)
    assert got == want
    assert [r["id"] for r in got] == list(range(n))
    # the corpus decodes the junk .npy's black stand-in too, then drops it
    _same_streams(streams, n + (mode != "batch"))
    out = capsys.readouterr().out
    assert f"[{task}] {n}" in out and "header_bad.mp4" in out and "stream_bad.npy" in out
    if mode == "streamed":
        assert tpipe.last_corpus_stats["streamed"] is True
    elif mode != "batch":
        assert tpipe.last_corpus_stats["streamed"] is False


def test_corpus_skip_paths_decode_once(pipes, tmp_path, monkeypatch):
    """As tests/test_eval_driver.py holds the JAX run_vtg_eval: header-bad files
    are pre-filtered and never decoded, stream-bad ones are recorded and
    dropped, good ones decode exactly once."""
    from trace_tpu_torch.eval.evaluate import run_vtg_eval
    from trace_tpu_torch.video import io as vio

    _, tpipe = pipes
    anno, vids = _vtg_dir(tmp_path, n=2)
    calls = {}
    real = vio.load_video_frames

    def counting(path, num_frames, *a, **k):
        calls[path] = calls.get(path, 0) + 1
        return real(path, num_frames, *a, **k)

    monkeypatch.setattr(vio, "load_video_frames", counting)
    results = run_vtg_eval(tpipe, "tvg", anno, vids, num_frames=T, batch_size=2,
                           max_new_tokens=8, progress=False)
    assert [r["id"] for r in results] == [0, 1]
    assert calls == {os.path.join(vids, f): 1 for f in ("v0.npy", "v1.npy", "stream_bad.npy")}


def _gt_and_results(task, tmp_path, seed=30):
    """A {split}.caption_coco_format.json of the task's schema and fmt
    records over its videos."""
    rng = np.random.default_rng(seed)
    anno, results = [], []
    for i in range(6):
        n = int(rng.integers(1, 4))
        segs = [sorted(rng.uniform(0, 60, 2).round(1).tolist()) for _ in range(n)]
        caps = [f"a person does thing number {i} {k} slowly" for k in range(n)]
        rec = {"image_id": f"dir/v{i}.mp4", "id": i, "duration": 60.0 + 2 * i}
        if task == "tvg":
            rec.update(caption=f"query {i}", timestamp=segs[0])
        elif task == "vhd":
            clips = sorted(rng.choice(30, 4, replace=False).tolist())
            rec.update(caption=f"query {i}", segments=segs, relevant_clip_ids=clips,
                       saliency_scores=rng.integers(0, 5, (4, 3)).tolist())
        else:
            rec.update(segments=segs, caption=". ".join(caps) + ".")
            if task == "dvc" and i % 2:
                rec["pure_cap"] = ". ".join(caps)
        anno.append(rec)
        k = int(rng.integers(0 if i == 4 else 1, 5))
        results.append({
            "video": f"v{i}.mp4", "id": i,
            "timestamps": [sorted(rng.uniform(0, 60, 2).round(1).tolist()) if e % 4 != 3
                           else [round(float(rng.uniform(0, 60)), 1)] for e in range(k)],
            "scores": [[float(rng.integers(1, 6))] for _ in range(k)],
            "captions": [f"a person does thing {e} quickly" for e in range(k)]})
    gt_file = tmp_path / "val.caption_coco_format.json"
    gt_file.write_text(json.dumps({"annotations": anno}))
    return results, str(gt_file)


@pytest.mark.parametrize("task", ["tvg", "vhd", "dvc", "dvc-anet"])
def test_score_results_matches_jax(task, tmp_path, monkeypatch):
    monkeypatch.delenv("METEOR_JAR", raising=False)
    j, t = _both("eval.evaluate")
    results, gt_file = _gt_and_results(task, tmp_path)
    want = j.score_results(task, results, gt_file)
    got = t.score_results(task, results, gt_file)
    assert json.dumps(got) == json.dumps(want)
    assert got


# ---------------------------------------------------------------------------
# the entry points: evaluate.main, run_mvbench, run_videomme, mcqa.main,
# runtime.inference.main
# ---------------------------------------------------------------------------

@pytest.fixture
def models(pipes, monkeypatch):
    """Each package's ``model_init`` returns its pipeline of ``pipes``; the
    flags each was called with are recorded."""
    import trace_tpu
    import trace_tpu.runtime.pipeline as jpl
    import trace_tpu_torch
    import trace_tpu_torch.runtime.pipeline as tpl

    calls = {"jax": [], "port": []}
    for side, pipe, mods in (("jax", pipes[0], (trace_tpu, jpl)),
                             ("port", pipes[1], (trace_tpu_torch, tpl))):
        for m in mods:
            monkeypatch.setattr(m, "model_init", lambda *a, _s=side, _p=pipe, **k: (
                calls[_s].append((a, k)), _p)[1])
    monkeypatch.delenv("METEOR_JAR", raising=False)
    return calls


@pytest.mark.parametrize("shards", [[], ["--num-shards", "2", "--shard", "0"]])
def test_evaluate_main_matches_jax(models, tmp_path, monkeypatch, shards, capsys, streams):
    """The fmt_*.json file byte for byte, its name and the shard split as
    the JAX script's; the scores printed and returned."""
    j, t = _both("eval.evaluate")
    anno, vids = _vtg_dir(tmp_path, n=4)
    (tmp_path / "test.caption_coco_format.json").write_text(json.dumps({"annotations": anno}))
    flags = ["--model-path", "ckpt", "--task", "tvg", "--anno-path", str(tmp_path),
             "--video-path", vids, "--num-frames", str(T), "--batch-size", "2",
             "--max-new-tokens", str(NEW), "--quant", "int8"] + shards
    monkeypatch.setattr(sys, "argv", ["evaluate.py", "--output-dir", str(tmp_path / "j")] + flags)
    j.main()
    want_out = capsys.readouterr().out
    got = t.main(["--output-dir", str(tmp_path / "t")] + flags)
    got_out = capsys.readouterr().out
    name = f"fmt_tvg_test_f{T}" + ("_shard0of2" if shards else "") + ".json"
    assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    _same_streams(streams, 4 if shards else 5)
    assert models["port"] == models["jax"] == [(("ckpt",), {"vision_path": None,
                                                            "quant": "int8"})]
    tail = lambda out: out[out.index("wrote"):].split("\n", 1)[1]  # after the progress
    assert tail(got_out) == tail(want_out)
    if shards:
        assert got is None and f"shard 0/2: {len(anno[0::2])} samples" in got_out
    else:
        assert got == json.loads(tail(want_out)) and set(got) >= {"R@0.5", "mIoU"}


@pytest.fixture(scope="module")
def mvbench_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("mvbench")
    anno, data = root / "json", root / "video"
    _write_frame_dir(data / "tvqa/frames_fps3_hq/s01e02_clip_07", seed=5)
    _write_frame_dir(data / "tvqa/frames_fps3_hq/s01e03_clip_01", n_frames=40, seed=6)
    episodic = [
        {"video": "s01e02_clip_07", "question": "Where was Sheldon when he spoke?",
         "candidates": ["In the kitchen.", "At the office.", "On the stairs.", "In the car."],
         "answer": "In the kitchen.", "start": 1.0, "end": 7.0},
        {"video": "s01e03_clip_01", "question": "Who opened the door?",
         "candidates": ["Penny.", "Leonard.", "Howard."], "answer": "Howard."},
        {"video": "s01e03_clip_01", "question": "What did he hold?",
         "candidates": ["A cup.", "A book."], "answer": "A cup.", "start": 2.0, "end": 12.5},
        {"video": "missing_clip", "question": "Is this read?", "candidates": ["yes", "no"],
         "answer": "no"},
    ]
    os.makedirs(anno)
    (anno / "episodic_reasoning.json").write_text(json.dumps(episodic))
    if NO_NATIVE is None:  # a "video" subtask with start/end bounds
        _write_mp4(data / "star/Charades_v1_480/ABC12.mp4", seed=1)
        (anno / "action_sequence.json").write_text(json.dumps([
            {"video": "ABC12.mp4", **MCQA_RECORD, "start": 0.4, "end": 2.4}]))
    return str(anno), str(data)


def test_run_mvbench_matches_jax(pipes, mvbench_tree, tmp_path, streams):
    """The frame-directory subtask (and, where the native decoder builds, a
    bounded mp4 one): accuracies, failures and both output files."""
    jpipe, tpipe = pipes
    j, t = _both("eval.mcqa")
    anno, data = mvbench_tree
    kw = dict(num_frames=T, batch_size=2, max_new_tokens=NEW)
    want = j.run_mvbench(jpipe, anno, data, output_dir=str(tmp_path / "j"), **kw)
    got = t.run_mvbench(tpipe, anno, data, output_dir=str(tmp_path / "t"), **kw)
    assert got == want
    _same_streams(streams, 4 if NO_NATIVE is None else 3)
    assert got["num_failures"] == 1 and 0 <= got["Avg"] <= 100
    assert ("Action Sequence" in got) == (NO_NATIVE is None)
    for f in ("test.json", "upload_leaderboard.json"):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes()


@pytest.fixture(scope="module")
def videomme_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("videomme")
    data = root / "media"
    _write_mp4(data / "data/fFjv93ACGo8.mp4", seed=7)
    _write_mp4(data / "data/zz9xJrPPpW0.mp4", seed=8)
    os.makedirs(data / "subtitle")
    (data / "subtitle/fFjv93ACGo8.vtt").write_text(VTT)  # the other has none
    records = [
        {"video_id": "001", "duration": "short", "url": "https://www.youtube.com/watch?v=fFjv93ACGo8",
         "videoID": "fFjv93ACGo8", "question_id": "001-1", **VIDEOMME_RECORD},
        {"video_id": "002", "duration": "medium", "videoID": "zz9xJrPPpW0",
         "question_id": "002-1", "question": "What does the chef do first?",
         "options": ["A. chop", "B. stir", "C. pour", "D. taste"], "answer": "A"},
        {"video_id": "003", "duration": "long", "videoID": "nofile", "question_id": "003-1",
         **VIDEOMME_RECORD},
    ]
    anno = root / "videomme.json"
    anno.write_text(json.dumps(records))
    return str(anno), str(data)


class _Spy:
    """The questions a pipeline is asked."""

    def __init__(self, pipe):
        self._pipe, self.questions = pipe, []

    def __getattr__(self, k):
        return getattr(self._pipe, k)

    def infer_events_batch(self, frames, ts, questions, **kw):
        self.questions.extend(questions)
        return self._pipe.infer_events_batch(frames, ts, questions, **kw)


@needs_native
@pytest.mark.parametrize("subtitles", [False, True])
def test_run_videomme_matches_jax(pipes, videomme_tree, tmp_path, subtitles, streams):
    jpipe, tpipe = pipes
    j, t = _both("eval.mcqa")
    anno, data = videomme_tree
    jspy, tspy = _Spy(jpipe), _Spy(tpipe)
    kw = dict(num_frames=T, batch_size=2, max_new_tokens=NEW, use_subtitles=subtitles,
              max_subtitle_len=24)
    want = j.run_videomme(jspy, anno, data, output_dir=str(tmp_path / "j"),
                          tokenizer=jpipe.tokenizer, **kw)
    got = t.run_videomme(tspy, anno, data, output_dir=str(tmp_path / "t"),
                         tokenizer=tpipe.tokenizer, **kw)
    assert got == want and got["num_failures"] == 1
    _same_streams(streams, 2)
    assert tspy.questions == jspy.questions
    assert sum("subtitles are listed below" in q for q in tspy.questions) == int(subtitles)
    board = "upload_leaderboard.json"
    assert (tmp_path / "t" / board).read_bytes() == (tmp_path / "j" / board).read_bytes()
    # the missing file's error is each package's reader's own words
    dumps = [json.loads((tmp_path / side / "test.json").read_text()) for side in "tj"]
    for d in dumps:
        d["failures"] = [f["path"] for f in d["failures"]]
    assert dumps[0] == dumps[1]


def test_mcqa_main_matches_jax(models, mvbench_tree, tmp_path, monkeypatch, capsys, streams):
    j, t = _both("eval.mcqa")
    anno, data = mvbench_tree
    flags = ["--benchmark", "mvbench", "--model-path", "ckpt", "--anno-path", anno,
             "--video-path", data, "--num-frames", str(T), "--batch-size", "2", "--limit", "2"]
    monkeypatch.setattr(sys, "argv", ["mcqa.py", "--output-dir", str(tmp_path / "j")] + flags)
    j.main()
    want_out = capsys.readouterr().out
    got = t.main(["--output-dir", str(tmp_path / "t")] + flags)
    assert capsys.readouterr().out == want_out and got == json.loads(want_out)
    _same_streams(streams)
    assert models["port"] == models["jax"] == [(("ckpt",), {"vision_path": None})]
    for f in ("test.json", "upload_leaderboard.json"):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes()


def _jax_inference_script():
    spec = importlib.util.spec_from_file_location(
        "jax_inference", ROOT / "scripts" / "inference" / "inference.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


@pytest.mark.parametrize("instruction", [None, "Find the events."])
def test_inference_main_matches_jax(models, tmp_path, monkeypatch, capsys, instruction, streams):
    """``python -m trace_tpu_torch.runtime.inference VIDEO [INSTRUCTION]``
    prints the JAX script's JSON, with MODEL_PATH, FRAMES and MAX_NEW_TOKENS
    read from the environment."""
    jmod = _jax_inference_script()
    from trace_tpu_torch.runtime import inference

    # the JAX script points JAX's compilation cache at ./.jax_cache for the
    # rest of the process; keep that out of the tests that follow
    real_update = jax.config.update
    monkeypatch.setattr(jax.config, "update", lambda name, value: None if name ==
                        "jax_compilation_cache_dir" else real_update(name, value))
    video = tmp_path / "v.npy"
    np.save(video, _frames(14, n=11, h=60, w=44))
    argv = ["inference.py", str(video)] + ([instruction] if instruction else [])
    monkeypatch.setenv("MODEL_PATH", "ckpt")
    monkeypatch.setenv("FRAMES", str(T))
    monkeypatch.setenv("MAX_NEW_TOKENS", "24")
    monkeypatch.setattr(sys, "argv", argv)
    jmod.main()
    want = capsys.readouterr().out
    got = inference.main(argv)
    assert capsys.readouterr().out == want and got == json.loads(want)
    _same_streams(streams, 1)
    assert models["port"] == models["jax"] == [(("ckpt",), {})]


def test_inference_main_refusals(monkeypatch, capsys):
    from trace_tpu_torch.runtime import inference

    with pytest.raises(SystemExit) as e:
        inference.main(["inference.py"])
    assert e.value.code == 1 and "MODEL_PATH" in capsys.readouterr().out
    monkeypatch.delenv("MODEL_PATH", raising=False)
    with pytest.raises(SystemExit, match="MODEL_PATH"):
        inference.main(["inference.py", "v.npy"])


@pytest.mark.parametrize("events", ["none", "some"])
@pytest.mark.parametrize("task", ["tvg", "dvc", "dvc-anet", "vhd"])
def test_smoke_score_keys_are_jax_keys(task, events, tmp_path, monkeypatch):
    """chip_smoke.py's phase 8 holds each score_results to EVAL_SCORE_KEYS
    on eval_ground_truth's annotations, where no JAX runs: those are the
    JAX package's keys, with and without predicted events."""
    import chip_smoke

    monkeypatch.delenv("METEOR_JAR", raising=False)
    j, t = _both("eval.evaluate")
    names = [f"video{v}.npy" for v in range(chip_smoke.EVAL_VIDEOS)]
    gt = chip_smoke.eval_ground_truth(names)[{"dvc-anet": "dvc"}.get(task, task)]
    gt_file = tmp_path / "test.caption_coco_format.json"
    gt_file.write_text(json.dumps({"annotations": gt}))
    rng = np.random.default_rng(40)
    results = []
    for j_ in gt:
        k = 0 if events == "none" else int(rng.integers(1, 4))
        results.append({
            "video": j_["image_id"].split("/")[-1], "id": j_["id"],
            "timestamps": [sorted(rng.uniform(0, chip_smoke.EVAL_DURATION, 2).tolist())
                           for _ in range(k)],
            "scores": [[float(rng.integers(1, 6))] for _ in range(k)],
            "captions": [f"a person picks up object {e}" for e in range(k)]})
    want = j.score_results(task, results, str(gt_file))
    assert list(want) == list(chip_smoke.EVAL_SCORE_KEYS[task])
    assert json.dumps(t.score_results(task, results, str(gt_file))) == json.dumps(want)
