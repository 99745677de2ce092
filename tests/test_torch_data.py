"""The port's data pipeline (dataset, sampler, loader: numpy only) against
the JAX package's on the same records: every array equal, element for
element."""

import json
import warnings

import numpy as np
import pytest

from trace_tpu.data import dataset as jds
from trace_tpu.data import sampler as jsampler
from trace_tpu.tokenizers.text import ByteTokenizer as JByteTokenizer
from trace_tpu_torch.data import dataset as tds
from trace_tpu_torch.data import sampler as tsampler
from trace_tpu_torch.data.loader import PrefetchLoader
from trace_tpu_torch.tokenizers.text import ByteTokenizer, SpmLikeTokenizer

V = 384
T, S = 4, 56

RECORDS = [
    {"video": "a.npy",
     "conversations": [{"from": "human", "value": "<video>\nFind the events."},
                       {"from": "gpt", "value": "<time><score>a cat jumps\n<time><score>it lands"}],
     "times": [[0.4, 1.6], [2.2, 3.0]], "scores": [[4.5], [2.0]]},
    {"video": "b.npy",
     "conversations": [{"from": "human", "value": "what happens? <video>"},
                       {"from": "gpt", "value": "a dog runs"},
                       {"from": "human", "value": "then what?"},
                       {"from": "gpt", "value": "it sleeps"}]},
    {"conversations": [{"from": "human", "value": "What is two plus two?"},
                       {"from": "gpt", "value": "Four."}]},
    {"image": "c.png",
     "conversations": [{"from": "human", "value": "<image>\nDescribe it."},
                       {"from": "gpt", "value": "a red square"}]},
]


def _synthetic_media(cls):
    """The dataset class with media decoding replaced by frames from a seed
    (the port decodes no files; the JAX package would need them on disk)."""

    class Synthetic(cls):
        def _load_media(self, rec):
            name = rec.get("video") or rec.get("image")
            if name is None:
                return np.zeros((T, S, S, 3), np.uint8), [[0.0]] * T
            rng = np.random.default_rng(sum(name.encode()))
            stamps = [[0.0]] * T if "image" in rec else [[float(i)] for i in range(T)]
            return rng.integers(0, 256, (T, S, S, 3), dtype=np.uint8), stamps

    return Synthetic


@pytest.fixture
def anno(tmp_path):
    path = tmp_path / "anno.json"
    path.write_text(json.dumps(RECORDS))
    return str(path)


def _datasets(anno, max_len=700):
    kw = dict(num_frames=T, num_video_tokens_per_frame=10, max_len=max_len, image_size=S,
              text_vocab_size=V, seed=3)
    return (_synthetic_media(jds.EventDataset)(anno, JByteTokenizer(), **kw),
            _synthetic_media(tds.EventDataset)(anno, ByteTokenizer(), **kw))


@pytest.mark.parametrize("index", range(len(RECORDS)))
def test_dataset_samples_equal(anno, index):
    jd, td = _datasets(anno)
    want, got = jd[index], td[index]
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype, key
    assert td.modality_lengths() == jd.modality_lengths()


def test_collate_batch_equal_and_right_padded(anno):
    jd, td = _datasets(anno)
    want = jds.collate_batch([jd[i] for i in range(len(RECORDS))])
    got = tds.collate_batch([td[i] for i in range(len(RECORDS))])
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    mask = got["attn_mask"]
    assert (np.diff(mask.astype(int), axis=1) <= 0).all()  # True..True False..False
    assert list(got["has_video"]) == [True, True, False, True]
    # padding carries no label in any stream
    for key in ("labels", "time_labels", "score_labels"):
        assert (got[key][~mask] == -100).all()


def test_truncation_warns_alike(anno):
    jd, td = _datasets(anno, max_len=560)
    with pytest.warns(UserWarning, match="supervised labels dropped"):
        want = jd[0]
    with pytest.warns(UserWarning, match="supervised labels dropped"):
        got = td[0]
    np.testing.assert_array_equal(got["labels"], want["labels"])


def test_segment_functions_equal():
    jt, tt = JByteTokenizer(), ByteTokenizer()
    events = [{"timestamp": [0.0, 1.5], "score": [4.0], "caption": "hi there"}]
    js = jds.event_response_segments([dict(e) for e in events], jt, text_vocab_size=V)
    ts = tds.event_response_segments([dict(e) for e in events], tt, text_vocab_size=V)
    assert [(s.ids, s.supervised, s.kind) for s in ts] == \
        [(s.ids, s.supervised, s.kind) for s in js]
    jp, jpos = jds.build_prompt_segments("Find events.", jt, 8, text_vocab_size=V)
    tp, tpos = tds.build_prompt_segments("Find events.", tt, 8, text_vocab_size=V)
    assert tpos == jpos and [s.ids for s in tp] == [s.ids for s in jp]
    want = jds.assemble_sequence(jp + js, 640, jpos, text_vocab_size=V)
    got = tds.assemble_sequence(tp + ts, 640, tpos, text_vocab_size=V)
    for field in ("token_ids", "labels", "time_labels", "score_labels", "attn_mask"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert tds.snap_times_to_frames([[0.7, 3.2]], [[0.0], [2.0], [4.0]]) == \
        jds.snap_times_to_frames([[0.7, 3.2]], [[0.0], [2.0], [4.0]]) == [[0.0, 4.0]]


@pytest.mark.parametrize("seed", [0, 3])
def test_sampler_orders_equal(seed):
    rng = np.random.default_rng(seed)
    lengths = [int(x) for x in rng.integers(-40, 40, 37) if x != 0]
    assert tsampler.modality_grouped_indices(lengths, 4, seed=seed) == \
        jsampler.modality_grouped_indices(lengths, 4, seed=seed)
    assert tsampler.length_grouped_indices(
        [abs(x) for x in lengths], 4, rng=np.random.default_rng(seed)) == \
        jsampler.length_grouped_indices(
            [abs(x) for x in lengths], 4, rng=np.random.default_rng(seed))
    idx = list(range(8))
    ls = [5, 1, 4, 2, 3, 3, 2, 4]
    assert tsampler.split_to_even_chunks(idx, ls, 2) == jsampler.split_to_even_chunks(idx, ls, 2)


def test_media_files_are_not_decoded(anno):
    """A record whose media file is missing is not decoded: both datasets
    warn, substitute a record drawn from the same seeded generator, and
    return the same sample; the text-only branch needs no file."""
    kw = dict(num_frames=T, image_size=S, num_video_tokens_per_frame=10, max_len=700,
              text_vocab_size=V, seed=3)
    jd = jds.EventDataset(anno, JByteTokenizer(), **kw)
    td = tds.EventDataset(anno, ByteTokenizer(), **kw)
    with pytest.warns(UserWarning, match="media decode failed"):
        want = jd[0]
    with pytest.warns(UserWarning, match="media decode failed"):
        got = td[0]
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert td.media_failures == jd.media_failures > 0
    sample = td[2]
    assert not sample["has_video"] and not sample["frames_u8"].any()


@pytest.mark.parametrize("scheme", ["uniform", "rand"])
def test_video_and_image_records_match_jax(tmp_path, scheme):
    """Video and image records read through each package's video/io.py from
    files on disk (``.npy`` videos larger than the ViT input, downscaled on
    the host; a png): every array of every sample equal."""
    from PIL import Image

    rng = np.random.default_rng(6)
    np.save(tmp_path / "a.npy", rng.integers(0, 256, (30, 72, 96, 3), dtype=np.uint8))
    np.save(tmp_path / "b.npy", rng.integers(0, 256, (9, S, S, 3), dtype=np.uint8))
    Image.fromarray(rng.integers(0, 256, (40, 64, 3), dtype=np.uint8)).save(tmp_path / "c.png")
    (tmp_path / "anno.json").write_text(json.dumps(RECORDS))
    kw = dict(data_folder=str(tmp_path), num_frames=T, image_size=S,
              num_video_tokens_per_frame=10, max_len=700, text_vocab_size=V, seed=3,
              sample_scheme=scheme)
    jd = jds.EventDataset(str(tmp_path / "anno.json"), JByteTokenizer(), **kw)
    td = tds.EventDataset(str(tmp_path / "anno.json"), ByteTokenizer(), **kw)
    for index in range(len(RECORDS)):
        want, got = jd[index], td[index]
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{index} {key}")
    assert td.media_failures == jd.media_failures == 0
    assert td[0]["frames_u8"].shape == (T, S, S, 3) and td[3]["has_video"]


@pytest.mark.parametrize("route", ["this machine's", "opencv"])
def test_container_records_match_jax(tmp_path, monkeypatch, route):
    """Video records in ``.mp4`` files, read through each package's
    ``video/io.py`` on the route this machine gives (the native decoder
    where it builds) and through OpenCV on both sides: every array of every
    sample equal; a junk ``.mp4`` is a media failure on both sides, replaced
    by the same record drawn from the same seeded generator."""
    import cv2

    from test_torch_video_io import force_opencv

    if route == "opencv":
        force_opencv(monkeypatch, tmp_path)
    rng = np.random.default_rng(8)
    # rows of whole 16-byte vectors: the JAX package's native decoder writes
    # past its buffer on other widths (the port's does not:
    # test_torch_video_io.py::test_native_decoder_writes_only_its_frames)
    for name, (n, h, w) in (("a.mp4", (30, 64, 96)), ("b.mp4", (12, 48, 48))):
        vw = cv2.VideoWriter(str(tmp_path / name), cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                             (w, h))
        assert vw.isOpened()
        for _ in range(n):
            vw.write(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        vw.release()
    (tmp_path / "junk.mp4").write_bytes(b"not a video container" * 4)
    records = [{**RECORDS[0], "video": "a.mp4"}, {**RECORDS[1], "video": "b.mp4"},
               {**RECORDS[1], "video": "junk.mp4"}]
    (tmp_path / "anno.json").write_text(json.dumps(records))
    kw = dict(data_folder=str(tmp_path), num_frames=T, image_size=S,
              num_video_tokens_per_frame=10, max_len=700, text_vocab_size=V, seed=3)
    jd = jds.EventDataset(str(tmp_path / "anno.json"), JByteTokenizer(), **kw)
    td = tds.EventDataset(str(tmp_path / "anno.json"), ByteTokenizer(), **kw)
    for index in range(len(records)):
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            want = jd[index]
        with warnings.catch_warnings(record=True) as tw:
            warnings.simplefilter("always")
            got = td[index]
        assert len(tw) == len(jw) == (1 if index == 2 else 0)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{index} {key}")
    assert td.media_failures == jd.media_failures == 1
    assert td[0]["has_video"] and td[0]["frames_u8"].any()


def test_prefetch_loader_batches_in_order_and_stops_early(anno):
    _, td = _datasets(anno)
    loader = PrefetchLoader(td, 2, order=[3, 2, 1, 0, 2], num_workers=2, prefetch_batches=1)
    assert len(loader) == 2  # the ragged last batch is dropped
    batches = list(loader)
    assert len(batches) == 2
    np.testing.assert_array_equal(batches[0]["token_ids"][0], td[3]["token_ids"])
    np.testing.assert_array_equal(batches[1]["token_ids"][1], td[0]["token_ids"])
    # a consumer that leaves early does not strand the producer on a full queue
    import threading

    before = threading.active_count()
    for _ in PrefetchLoader(td, 1, order=[0, 1, 2, 3] * 4, num_workers=2, prefetch_batches=1):
        break
    import time

    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_prefetch_loader_hands_a_sample_error_to_the_consumer(tmp_path):
    """A record the dataset cannot load raises where the loop reads batches,
    it does not leave the loop waiting on an empty queue: here every record's
    video is missing, so the dataset gives up after its substitutes."""
    path = tmp_path / "anno.json"
    path.write_text(json.dumps([RECORDS[0], RECORDS[1]]))
    ds = tds.EventDataset(str(path), ByteTokenizer(), num_frames=T, image_size=S,
                          num_video_tokens_per_frame=10, max_len=700, text_vocab_size=V)
    with pytest.warns(UserWarning, match="media decode failed"), \
            pytest.raises(tds.DatasetError, match="consecutive media decode failures"):
        list(PrefetchLoader(ds, 2, order=[1, 1, 1, 0], num_workers=2, prefetch_batches=1))


def test_spm_like_tokenizer_builds_training_sequences():
    """The tokenizer the card's smoke run trains with: sequences assemble and
    the three label streams stay disjoint."""
    tok = SpmLikeTokenizer()
    segs, pos = tds.build_prompt_segments("Find events.", tok, 20, text_vocab_size=32000)
    resp = tds.event_response_segments(
        [{"timestamp": [1.0, 2.0], "score": [3.5], "caption": "a person waves"}], tok)
    seq = tds.assemble_sequence(segs + resp, 512, pos)
    sup = [seq.labels != -100, seq.time_labels != -100, seq.score_labels != -100]
    assert sup[1].sum() == 14 and sup[2].sum() == 4
    assert not (sup[0] & sup[1]).any() and not (sup[0] & sup[2]).any()
    assert seq.attn_mask[:pos].all() and not seq.attn_mask[-1]
