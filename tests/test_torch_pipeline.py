"""The port's TracePipeline against the JAX package's on the tiny config
(ByteTokenizer, weights through ``from_jax_params``), and the port's import
guard."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trace_tpu.model.config import TraceConfig as JTraceConfig
from trace_tpu.model.trace_model import init_trace_params as jax_init
from trace_tpu.runtime import generate as jgen
from trace_tpu.runtime.pipeline import TracePipeline as JaxPipeline
from trace_tpu.tokenizers.text import ByteTokenizer as JaxByteTokenizer
from trace_tpu.video.io import load_video_frames as jax_load_video
from trace_tpu_torch.constants import MODAL_TOKEN_INDEX
from trace_tpu_torch.model.config import TraceConfig
from trace_tpu_torch.params import from_jax_params
from trace_tpu_torch.runtime.pipeline import TracePipeline, expand_prompt_ids
from trace_tpu_torch.tokenizers.text import ByteTokenizer, SpmLikeTokenizer

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = Path(__file__).resolve().parents[1]
JCFG = JTraceConfig.tiny()
CFG = TraceConfig.tiny()


def _jax_params():
    jp = jax_init(JCFG, jax.random.PRNGKey(0))
    # larger output heads: the greedy stream then crosses all three heads
    rng = np.random.default_rng(9)
    dec = dict(jp["decoder"])
    for name in ("lm_head", "sync_head", "time_head", "score_head"):
        dec[name] = jnp.asarray(rng.standard_normal(dec[name].shape).astype(np.float32))
    return {**jp, "decoder": dec}


@pytest.fixture(scope="module")
def pipes():
    jp = _jax_params()
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    return (JaxPipeline(params=jp, config=JCFG, tokenizer=JaxByteTokenizer()),
            TracePipeline(tp, CFG, ByteTokenizer(), device="cpu"))


def _videos():
    rng = np.random.default_rng(0)
    T = CFG.num_frames
    a = rng.integers(0, 256, (T, 64, 48, 3), dtype=np.uint8)  # padded + resized
    b = rng.integers(0, 256, (T, 56, 56, 3), dtype=np.uint8)  # already square
    ts = [[float(2 * i)] for i in range(T)]
    return [a, b], [ts, ts], ["Find the events.", "Localize the moments in this clip."]


def test_prefix_embeddings_match(pipes):
    jpipe, tpipe = pipes
    frames, ts, qs = _videos()
    jprefix, jmask = jpipe._prepare_prefix_batch(frames, ts, qs)
    tprefix, tmask = tpipe.encode_prefix(frames, ts, qs)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(tprefix.numpy(), np.asarray(jprefix), rtol=2e-5, atol=2e-5)


def test_infer_events_batch_matches(pipes):
    jpipe, tpipe = pipes
    frames, ts, qs = _videos()
    want = jpipe.infer_events_batch(frames, ts, qs, max_new_tokens=40)
    got = tpipe.infer_events_batch(frames, ts, qs, max_new_tokens=40)
    assert [g.to_dict() for g in got] == [w.to_dict() for w in want]
    # and the token stream itself, through the JAX generate on the JAX prefix
    jprefix, jmask = jpipe._prepare_prefix_batch(frames, ts, qs)
    jtok = jgen.generate(jpipe._decoder_params, JCFG.decoder, jprefix, jmask,
                         jpipe._combined, max_new_tokens=40, initial_head=1)
    np.testing.assert_array_equal(tpipe.last_stats["tokens"], jtok.tokens)
    assert tpipe.last_stats["decode_steps"] > 0


def test_infer_text_matches(pipes):
    jpipe, tpipe = pipes
    frames, ts, _ = _videos()
    want = jpipe.infer_text(frames[1], ts[1], "Describe the video.", max_new_tokens=12)
    got = tpipe.infer_text(frames[1], ts[1], "Describe the video.", max_new_tokens=12)
    assert got == want


def test_expand_prompt_ids():
    ids = [1, 5, 6, MODAL_TOKEN_INDEX["VIDEO"], 7, MODAL_TOKEN_INDEX["SYNC"]]
    out, vp = expand_prompt_ids(ids, num_video_tokens=4, text_vocab_size=100)
    assert vp == 3 and out.tolist() == [1, 5, 6, 0, 0, 0, 0, 7, 100]
    with pytest.raises(AssertionError):
        expand_prompt_ids([1, 2], 4, 100)


def test_spm_like_tokenizer_matches_jax():
    from trace_tpu.tokenizers.text import SpmLikeTokenizer as JaxSpm

    text = "Localize the visual events, with timestamps; and caption each one."
    j, t = JaxSpm(), SpmLikeTokenizer()
    assert t.encode(text) == j.encode(text)
    assert t.decode(t.encode(text)) == j.decode(j.encode(text))


def test_large_rgb_frames_match_jax(pipes):
    """rgb frames larger than 1.3 S^2 are downscaled on the host first (the
    bicubic of video/preprocess.py in place of OpenCV's), then preprocessed
    on the device: the same events and tokens as the JAX package's."""
    jpipe, tpipe = pipes
    rng = np.random.default_rng(4)
    T = CFG.num_frames
    frames = [rng.integers(0, 256, (T, 90, 120, 3), dtype=np.uint8),
              rng.integers(0, 256, (T, 130, 70, 3), dtype=np.uint8)]
    ts = [[[float(i)] for i in range(T)]] * 2
    qs = ["Find the events.", "What happens?"]
    jprefix, jmask = jpipe._prepare_prefix_batch(frames, ts, qs)
    tprefix, _ = tpipe.encode_prefix(frames, ts, qs)
    np.testing.assert_allclose(tprefix.numpy(), np.asarray(jprefix), rtol=2e-5, atol=2e-5)
    want = jpipe.infer_events_batch(frames, ts, qs, max_new_tokens=40)
    got = tpipe.infer_events_batch(frames, ts, qs, max_new_tokens=40)
    assert [g.to_dict() for g in got] == [w.to_dict() for w in want]
    jtok = jgen.generate(jpipe._decoder_params, JCFG.decoder, jprefix, jmask,
                         jpipe._combined, max_new_tokens=40, initial_head=1)
    np.testing.assert_array_equal(tpipe.last_stats["tokens"], jtok.tokens)


def test_pipeline_defaults_to_cuda():
    if torch.cuda.is_available():
        assert TracePipeline({}, CFG, ByteTokenizer()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TracePipeline({}, CFG, ByteTokenizer())


def _port_sources():
    # the rank worker of the multi-process tests runs without JAX too, and
    # so do the twins of the launch scripts
    return sorted((ROOT / "trace_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "_torch_mp_worker.py",
        ROOT / "scripts" / "inference" / "inference_torch.py",
        ROOT / "scripts" / "inference" / "serve_batch_torch.py",
        ROOT / "examples" / "inference_torch.py"]


# the files that may import cv2, and the functions of each it is imported in
# (None: anywhere): the video reader's OpenCV route, as the JAX package's
# reader has it, and the smoke run, which writes its .mp4 files with it
CV2_IMPORTS = {"trace_tpu_torch/video/io.py": {"_read_cv2", "_probe_cv2"},
               "chip_smoke.py": None}


def test_port_never_imports_jax_or_the_jax_package():
    sources = {p.relative_to(ROOT).as_posix() for p in _port_sources()}
    assert {"trace_tpu_torch/runtime/mesh.py", "trace_tpu_torch/runtime/distributed.py",
            "trace_tpu_torch/parallel/__init__.py", "trace_tpu_torch/parallel/collectives.py",
            "trace_tpu_torch/parallel/pipeline.py"} <= sources
    cv2_seen = {}
    for path in _port_sources():
        rel = path.relative_to(ROOT).as_posix()
        tree = ast.parse(path.read_text(), filename=str(path))
        where = {}  # node -> the outermost function around it
        for fn in ast.walk(tree):
            if isinstance(fn, ast.FunctionDef):
                for node in ast.walk(fn):
                    where.setdefault(node, fn.name)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "optax", "orbax", "trace_tpu",
                                   "sklearn"), \
                    f"{path}: imports {name}"
                if top == "cv2":
                    assert rel in CV2_IMPORTS, f"{path}: imports cv2"
                    allowed = CV2_IMPORTS[rel]
                    assert allowed is None or where.get(node) in allowed, \
                        f"{path}: imports cv2 outside {sorted(allowed)}"
                    cv2_seen.setdefault(rel, set()).add(where.get(node))
    assert cv2_seen["trace_tpu_torch/video/io.py"] == CV2_IMPORTS["trace_tpu_torch/video/io.py"]


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "trace_tpu_torch").rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'orbax', 'trace_tpu', 'cv2', 'sklearn'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   capture_output=True, text=True)


def test_event_codec_matches_jax_and_drops_malformed_values():
    from trace_tpu.tokenizers import event_codec as jcodec
    from trace_tpu_torch.tokenizers import event_codec as tcodec

    tok = ByteTokenizer()
    events = [{"timestamp": [1.5, 12.0], "score": [3.2], "caption": "a cat"},
              {"timestamp": [20.0, 31.5], "score": [4.8], "caption": "jumps"}]
    ids = tcodec.encode_event_stream(events, lambda s: tok.encode(s)[1:])
    assert ids == jcodec.encode_event_stream(events, lambda s: tok.encode(s)[1:])
    got = tcodec.decode_event_stream(ids, tok.decode).to_dict()
    assert got == jcodec.decode_event_stream(ids, tok.decode).to_dict()
    # '1..5' is no number: the port drops it and keeps the rest
    dot, sep, sync = (tcodec.time_local_to_combined(i) for i in (12, 1, 0))
    one = tcodec.time_local_to_combined(3)
    bad = [one, dot, dot, one + 4, sep, one, sync]
    assert tcodec.decode_event_stream(bad, tok.decode).timestamps == [[1.0]]


def test_event_codec_malformed_value_jax_raises_port_drops_it():
    """Pins the one known difference of the codecs: on a value whose chars
    form no number the JAX package raises ValueError; the port returns
    exactly what it returns for the stream with that value's chars removed
    (its <sep> stays: an empty value adds nothing in either codec)."""
    from trace_tpu.tokenizers import event_codec as jcodec
    from trace_tpu_torch.tokenizers import event_codec as tcodec

    tok = ByteTokenizer()
    events = [{"timestamp": [1.5, 12.0], "score": [3.2], "caption": "a cat"},
              {"timestamp": [20.0, 31.5], "score": [4.8], "caption": "jumps"}]
    good = tcodec.encode_event_stream(events, lambda s: tok.encode(s)[1:])
    dot = tcodec.time_local_to_combined(12)
    at = good.index(dot)  # the '.' of 1.5
    bad = good[:at] + [dot] + good[at:]  # '1..5'
    with pytest.raises(ValueError):
        jcodec.decode_event_stream(bad, tok.decode)
    # remove the whole malformed value: every char id around the dots, up
    # to the <sep> / <sync> ids of the time block on either side
    ends = {tcodec.time_local_to_combined(i) for i in (0, 1)}
    chars = lambda i: min(ends) < bad[i] <= dot and bad[i] not in ends
    lo, hi = at, at
    while chars(lo - 1):
        lo -= 1
    while chars(hi + 1):
        hi += 1
    removed = bad[:lo] + bad[hi + 1:]
    got = tcodec.decode_event_stream(bad, tok.decode).to_dict()
    assert got == tcodec.decode_event_stream(removed, tok.decode).to_dict()
    assert got == jcodec.decode_event_stream(removed, tok.decode).to_dict()
    assert got["timestamps"][0] == [12.0] and got["timestamps"][1] == [20.0, 31.5]


# ---------------------------------------------------------------------------
# The int8 serving configuration as a whole.
#
# The JAX pipeline runs what it runs on a TPU, in interpret mode on the CPU:
# prefill through its Pallas flash kernel (the test sets
# ``generate.default_use_flash`` to True and routes
# ``flash_attention_trainable`` to ``flash_attention(..., interpret=True)``),
# each decode step through its Pallas int8 decode kernel
# (``TRACE_TPU_DECODE_ATTN=force``; it wants head_dim 128 and a cache length
# that is a multiple of 8, which the 128-token prefix bucket gives). Nothing
# in the JAX package changes. Both sides then compute one function, and the
# greedy streams are compared token for token. A summation-order difference
# could flip an int8 rounding and, on a near-tie, a token; on these seeds it
# does not (the decoder tests measure 3e-7 between the two).
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_serving_kernels_interpreted(monkeypatch):
    from trace_tpu.kernels import flash_attention as jfa

    monkeypatch.setenv("TRACE_TPU_DECODE_ATTN", "force")
    for name in ("TRACE_TPU_DECODE_ATTN_S8", "TRACE_TPU_STACKED_QMM", "TRACE_TPU_QMM"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(jgen, "default_use_flash", lambda: True)
    monkeypatch.setattr(
        jfa, "flash_attention_trainable",
        lambda q, k, v, bias, causal=False: jfa.flash_attention(
            q, k, v, bias, causal=causal, interpret=True))


def _int8_pipes():
    import dataclasses

    from trace_tpu.model import quantize as jq
    from trace_tpu_torch.model.quantize import int8_serving

    wide = dict(num_heads=4, num_kv_heads=2, head_dim=128, hidden_size=128)
    jcfg = dataclasses.replace(JCFG, decoder=dataclasses.replace(JCFG.decoder, **wide))
    tcfg = dataclasses.replace(CFG, decoder=dataclasses.replace(CFG.decoder, **wide))
    jp = jax_init(jcfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(10)
    dec = dict(jp["decoder"])
    for name in ("lm_head", "sync_head", "time_head", "score_head"):
        dec[name] = jnp.asarray(rng.standard_normal(dec[name].shape).astype(np.float32))
    jp = {**jp, "decoder": dec}
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    # the JAX serving pair, as model_init(..., quant="int8") and the bench build it
    jq_params = jq.quantize_trace_params(jp)
    jq_params["decoder"] = jq.fuse_decoder_serving(jq_params["decoder"])
    jq_cfg = dataclasses.replace(
        jcfg,
        decoder=dataclasses.replace(jcfg.decoder, kv_cache_dtype="int8", act_quant=True),
        vision=dataclasses.replace(jcfg.vision, act_quant=True))
    tq_params, tq_cfg = int8_serving(tp, tcfg)
    return (JaxPipeline(params=jq_params, config=jq_cfg, tokenizer=JaxByteTokenizer()),
            TracePipeline(tq_params, tq_cfg, ByteTokenizer(), device="cpu"))


def test_int8_serving_infer_events_batch_matches(jax_serving_kernels_interpreted):
    jpipe, tpipe = _int8_pipes()
    assert tpipe.config.decoder.kv_cache_dtype == "int8" and tpipe.config.vision.act_quant
    frames, ts, qs = _videos()
    jprefix, jmask = jpipe._prepare_prefix_batch(frames, ts, qs)
    tprefix, tmask = tpipe.encode_prefix(frames, ts, qs)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    # W8A8 ViT on preprocessed frames that differ by ~2e-5 (bicubic resize in
    # another order): a few int8 activations flip by one step, each moving
    # its frame's slots by up to ~1/127 of a term. Measured here: 0.03% of
    # the entries beyond 2e-3 of the largest value, the worst 7e-3. Limits:
    # 2e-2 of the largest value for any entry, 5e-3 for ||diff|| / ||ref||
    # (measured 1.5e-3).
    jpre = np.asarray(jprefix)
    diff = np.abs(tprefix.numpy() - jpre)
    assert diff.max() <= 2e-2 * np.abs(jpre).max()
    assert np.linalg.norm(diff) <= 5e-3 * np.linalg.norm(jpre)
    want = jpipe.infer_events_batch(frames, ts, qs, max_new_tokens=24)
    got = tpipe.infer_events_batch(frames, ts, qs, max_new_tokens=24)
    assert [g.to_dict() for g in got] == [w.to_dict() for w in want]
    jtok = jgen.generate(jpipe._decoder_params, jpipe.config.decoder, jprefix, jmask,
                         jpipe._combined, max_new_tokens=24, initial_head=1, use_flash=True)
    np.testing.assert_array_equal(tpipe.last_stats["tokens"], jtok.tokens)
    assert tpipe.last_stats["decode_steps"] > 0
    layers = tpipe._decoder_params["layers"]
    assert "wqkv" in layers and "w_gateup" in layers


# ---------------------------------------------------------------------------
# The int4p serving configuration as a whole, built on the JAX side as
# ``model_init(..., quant="int4p")`` builds it (host quantizer, fused on the
# host, int8 KV cache, ``act_quant``) with the bench's int8 W8A8 ViT. The JAX
# package's packed products take its plain route on the CPU, its attention the
# interpreted Pallas kernels as above. Two trees: per-channel scales (group 0)
# on the 128-wide decoder, where prefill is W4A8 and the steps are the
# per-channel weight-only product; group-128 scales on a 256-wide decoder
# (G = 2 for every weight), weight-only at every chunk length. Greedy streams
# are compared token for token.
# ---------------------------------------------------------------------------


def _int4p_pipes(group):
    import dataclasses

    from trace_tpu.model import quantize as jq
    from trace_tpu_torch.model.quantize import int4p_serving

    if group:
        wide = dict(num_heads=2, num_kv_heads=1, head_dim=128, hidden_size=256,
                    intermediate_size=256)
    else:
        wide = dict(num_heads=4, num_kv_heads=2, head_dim=128, hidden_size=128)
    jcfg = dataclasses.replace(JCFG, decoder=dataclasses.replace(JCFG.decoder, **wide))
    tcfg = dataclasses.replace(CFG, decoder=dataclasses.replace(CFG.decoder, **wide))
    jp = jax_init(jcfg, jax.random.PRNGKey(4))
    rng = np.random.default_rng(11)
    dec = dict(jp["decoder"])
    for name in ("lm_head", "sync_head", "time_head", "score_head"):
        dec[name] = jnp.asarray(rng.standard_normal(dec[name].shape).astype(np.float32))
    jp = {**jp, "decoder": dec}
    host = jax.tree.map(np.asarray, jp)
    tp = from_jax_params(host)
    jq_params = dict(jp)
    jq_params["decoder"] = jq.fuse_decoder_serving(
        jq.quantize_decoder_params_host(host["decoder"], 4, pack=True, group=group))
    jq_params["vision"] = jq.quantize_vision_params(jp["vision"])
    jq_cfg = dataclasses.replace(
        jcfg,
        decoder=dataclasses.replace(jcfg.decoder, kv_cache_dtype="int8", act_quant=True),
        vision=dataclasses.replace(jcfg.vision, act_quant=True))
    tq_params, tq_cfg = int4p_serving(tp, tcfg, group=group)
    return (JaxPipeline(params=jq_params, config=jq_cfg, tokenizer=JaxByteTokenizer()),
            TracePipeline(tq_params, tq_cfg, ByteTokenizer(), device="cpu"))


@pytest.mark.parametrize("group", [128, 0])
def test_int4p_serving_infer_events_batch_matches(jax_serving_kernels_interpreted, group):
    from trace_tpu_torch.model.quantize import packed4_groups

    jpipe, tpipe = _int4p_pipes(group)
    frames, ts, qs = _videos()
    want = jpipe.infer_events_batch(frames, ts, qs, max_new_tokens=24)
    got = tpipe.infer_events_batch(frames, ts, qs, max_new_tokens=24)
    assert [g.to_dict() for g in got] == [w.to_dict() for w in want]
    jprefix, jmask = jpipe._prepare_prefix_batch(frames, ts, qs)
    jtok = jgen.generate(jpipe._decoder_params, jpipe.config.decoder, jprefix, jmask,
                         jpipe._combined, max_new_tokens=24, initial_head=1, use_flash=True)
    np.testing.assert_array_equal(tpipe.last_stats["tokens"], jtok.tokens)
    assert tpipe.last_stats["decode_steps"] > 0
    layers = tpipe._decoder_params["layers"]
    assert sorted(n for n in layers if n.startswith("w")) == ["w_down", "w_gateup", "wo", "wqkv"]
    assert {packed4_groups(layers[n]) for n in ("w_down", "w_gateup", "wo", "wqkv")} == {
        2 if group else 1}
    assert set(tpipe._decoder_params["lm_head"]) == {"q", "s"}


def test_pipeline_fuses_an_unfused_int4p_tree():
    """A packed tree handed over per weight is fused at first use, as an int8
    one is."""
    from trace_tpu_torch.model.quantize import quantize_decoder_params
    from trace_tpu_torch.params import init_trace_params

    params = init_trace_params(CFG, torch.Generator().manual_seed(2), device="cpu")
    params["decoder"] = quantize_decoder_params(params["decoder"], bits=4, pack=True)
    pipe = TracePipeline(params, CFG, ByteTokenizer(), device="cpu")
    pipe._prepare_memory_layout()
    layers = pipe._decoder_params["layers"]
    assert "qp" in layers["wqkv"] and "qp" in layers["w_gateup"] and "wq" not in layers


def test_pipeline_fuses_an_unfused_int8_tree():
    """An int8 tree handed over per weight is put into the fused serving
    layout at first use; a dense tree is left as it is."""
    from trace_tpu_torch.model.quantize import quantize_trace_params
    from trace_tpu_torch.params import init_trace_params

    params = init_trace_params(CFG, torch.Generator().manual_seed(1), device="cpu")
    pipe = TracePipeline(quantize_trace_params(params), CFG, ByteTokenizer(), device="cpu")
    pipe._prepare_memory_layout()
    assert "wqkv" in pipe._decoder_params["layers"]
    dense = TracePipeline(params, CFG, ByteTokenizer(), device="cpu")
    dense._prepare_memory_layout()
    assert "wq" in dense._decoder_params["layers"]


# ---------------------------------------------------------------------------
# The public API from files: model_init on a checkpoint dir, infer_events /
# infer / x_infer on a video file, the batch-serving CLI. Both packages load
# the same dir (a merged TRACE checkpoint in bf16 safetensors shards and a
# word-level HF tokenizer, written by the helpers of test_torch_checkpoint),
# in fp32, with the tiny vision tower (fixture ``tiny_vision``) and a
# 256-wide decoder of head_dim 128 (the JAX int8 decode kernel's width; the
# group-128 int4p scales then give G = 2 for every weight). The JAX side runs
# its serving kernels interpreted, as above.
# ---------------------------------------------------------------------------

from test_torch_checkpoint import (  # noqa: E402
    assert_trees_equal,
    jax_config,
    tiny_vision,  # noqa: F401  (a fixture)
    write_hf_tokenizer,
    write_merged_checkpoint,
)

ASK = "Localize a series of activity events in the video ."


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    cfg = jax_config(decoder=dict(num_layers=2, num_heads=2, num_kv_heads=1, head_dim=128,
                                  hidden_size=256, intermediate_size=256))
    path = tmp_path_factory.mktemp("trace_ckpt")
    write_merged_checkpoint(path, cfg, seed=12, shards=2)
    write_hf_tokenizer(path, cfg.decoder.vocab_size)
    rng = np.random.default_rng(13)
    np.save(path / "video.npy", rng.integers(0, 256, (10, 64, 48, 3), dtype=np.uint8))
    return path


def _packed_int4(jparams) -> dict:
    """The JAX package's ``quant="int4"`` tree as the port holds it: every
    native-int4 layer weight (through the weight carry-over, one value an
    int8) nibble-packed per output channel in the flattened [L, K, N] view,
    with its [L, 1, N] scales, then fused."""
    from trace_tpu_torch.model.quantize import fuse_decoder_serving, pack4

    tree = from_jax_params(jax.tree.map(np.asarray, jparams))
    layers = dict(tree["decoder"]["layers"])
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        q, sc = layers[name]["q"], layers[name]["s"]
        L, N = q.shape[0], sc[0].numel()
        layers[name] = {"qp": pack4(q.reshape(L, -1, N)), "s": sc.reshape(L, 1, N)}
    tree["decoder"] = fuse_decoder_serving({**tree["decoder"], "layers": layers})
    return tree


@pytest.mark.parametrize("quant", ["bf16", "int8", "int4p", "int4"])
def test_model_init_matches_jax(ckpt_dir, tiny_vision, jax_serving_kernels_interpreted, quant):
    """model_init on the same dir: the same tree on the device (leaf for leaf,
    bit for bit: converted, host-quantized, fused; for int4 the JAX package's
    native-int4 values as the port packs them), the same config, and the
    same greedy events and tokens from ``infer_events`` on an ``.npy`` video."""
    from trace_tpu.runtime.pipeline import model_init as jax_model_init
    from trace_tpu_torch.runtime.pipeline import model_init

    jpipe = jax_model_init(str(ckpt_dir), dtype=jnp.float32, quant=quant)
    tpipe = model_init(str(ckpt_dir), dtype=torch.float32, quant=quant, device="cpu")
    jpipe._prepare_memory_layout()
    if quant == "int4":
        assert np.asarray(jpipe.params["decoder"]["layers"]["wq"]["q"]).dtype.name == "int4"
        assert_trees_equal(tpipe.params, _packed_int4(jpipe.params))
        assert not tpipe.config.decoder.act_quant
    else:
        assert_trees_equal(tpipe.params, jpipe.params)
    for part in ("decoder", "vision"):
        for f in dataclasses.fields(getattr(tpipe.config, part)):
            if hasattr(getattr(jpipe.config, part), f.name):
                assert (getattr(getattr(tpipe.config, part), f.name)
                        == getattr(getattr(jpipe.config, part), f.name)), f.name
    assert tpipe.config.decoder.kv_cache_dtype == ("bf16" if quant == "bf16" else "int8")
    assert not tpipe.config.vision.act_quant
    assert tpipe.tokenizer.vocab_size == jpipe.tokenizer.vocab_size == 384

    video = str(ckpt_dir / "video.npy")
    want = jpipe.infer_events(video, ASK, max_new_tokens=24)
    got = tpipe.infer_events(video, ASK, max_new_tokens=24)
    assert got.to_dict() == want.to_dict()
    # the 4-bit streams stay in the time head here
    assert got.timestamps or quant in ("int4p", "int4")
    frames, ts = jax_load_video(video, JCFG.num_frames)
    jprefix, jmask = jpipe._prepare_prefix_batch([frames], [ts], [ASK])
    jtok = jgen.generate(jpipe._decoder_params, jpipe.config.decoder, jprefix, jmask,
                         jpipe._combined, max_new_tokens=24, initial_head=1,
                         eos_id=jpipe.tokenizer.eos_token_id, use_flash=True)
    np.testing.assert_array_equal(tpipe.last_stats["tokens"], jtok.tokens)
    assert tpipe.last_stats["decode_steps"] > 0


def test_model_init_refusals(ckpt_dir):
    from trace_tpu_torch.runtime.pipeline import model_init

    with pytest.raises(ValueError, match="quant"):
        model_init(str(ckpt_dir), quant="int2", device="cpu")
    if not torch.cuda.is_available():  # fails before reading anything
        with pytest.raises(RuntimeError, match="CUDA"):
            model_init(str(ckpt_dir))


def test_public_api_from_a_video_file_matches_jax(pipes, tmp_path, monkeypatch):
    """``infer_events``, ``infer`` and ``x_infer`` (each mode, and the
    ValueError of an unknown one) on an ``.npy`` video, through both
    packages' top-level functions."""
    import trace_tpu
    import trace_tpu_torch

    jpipe, tpipe = pipes
    video = str(tmp_path / "v.npy")
    np.save(video, np.random.default_rng(14).integers(0, 256, (9, 60, 44, 3), dtype=np.uint8))
    want = trace_tpu.infer_events(jpipe, video, "Find the events.", max_new_tokens=30)
    got = trace_tpu_torch.infer_events(tpipe, video, "Find the events.", max_new_tokens=30)
    assert got.to_dict() == want.to_dict()
    assert (trace_tpu_torch.infer(tpipe, video, "Describe it.", max_new_tokens=10)
            == trace_tpu.infer(jpipe, video, "Describe it.", max_new_tokens=10))
    assert (trace_tpu_torch.x_infer(tpipe, video, "What is shown?", mode="mcqa",
                                    max_new_tokens=8)
            == trace_tpu.x_infer(jpipe, video, "What is shown?", mode="mcqa",
                                 max_new_tokens=8))
    # every mode's instruction, as each package's x_infer hands it to infer
    asked = {}
    for mod in (trace_tpu, trace_tpu_torch):
        monkeypatch.setattr(mod, "infer", lambda p, v, q, _m=mod, **kw: asked.setdefault(
            _m.__name__, []).append(q))
        for mode in ("mcqa", "openend", "vanilla"):
            mod.x_infer(None, video, "What is shown?", mode=mode)
        with pytest.raises(ValueError):
            mod.x_infer(None, video, "q", mode="bogus")
    assert asked["trace_tpu_torch"] == asked["trace_tpu"] and len(set(asked["trace_tpu"])) == 3


@pytest.mark.parametrize("route", ["this machine's", "opencv"])
def test_containers_served_match_jax(pipes, tmp_path, monkeypatch, capsys, route):
    """``infer_events`` and the serving CLI on ``.mp4`` files, on the route
    this machine gives (the native decoder where it builds) and through
    OpenCV on both sides: the JAX package's events and greedy tokens, the
    JAX script's JSONL (a junk ``.mp4`` its one error line); the CLI first
    says which route containers take."""
    import importlib.util
    import json

    import cv2

    import trace_tpu
    import trace_tpu.runtime.pipeline as jpl
    import trace_tpu_torch
    import trace_tpu_torch.runtime.pipeline as tpl
    from test_torch_video_io import force_opencv
    from trace_tpu_torch.runtime import serve_batch
    from trace_tpu_torch.video.io import container_reader

    if route == "opencv":
        force_opencv(monkeypatch, tmp_path)
    jpipe, tpipe = pipes
    videos = tmp_path / "videos"
    videos.mkdir()
    rng = np.random.default_rng(16)
    for i, (w, h) in enumerate(((64, 48), (48, 64))):
        vw = cv2.VideoWriter(str(videos / f"v{i}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                             (w, h))
        assert vw.isOpened()
        for _ in range(20):
            vw.write(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        vw.release()
    (videos / "junk.mp4").write_bytes(b"not a video container" * 4)

    video = str(videos / "v0.mp4")
    want = trace_tpu.infer_events(jpipe, video, ASK, max_new_tokens=24)
    got = trace_tpu_torch.infer_events(tpipe, video, ASK, max_new_tokens=24)
    assert got.to_dict() == want.to_dict()
    frames, ts = jax_load_video(video, JCFG.num_frames)
    jprefix, jmask = jpipe._prepare_prefix_batch([frames], [ts], [ASK])
    jtok = jgen.generate(jpipe._decoder_params, jpipe.config.decoder, jprefix, jmask,
                         jpipe._combined, max_new_tokens=24, initial_head=1,
                         eos_id=jpipe.tokenizer.eos_token_id)
    np.testing.assert_array_equal(tpipe.last_stats["tokens"], jtok.tokens)
    assert tpipe.last_stats["decode_steps"] > 0

    spec = importlib.util.spec_from_file_location(
        "jax_serve_batch", ROOT / "scripts" / "inference" / "serve_batch.py")
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    monkeypatch.setattr(jpl, "model_init", lambda *a, **k: jpipe)
    monkeypatch.setattr(tpl, "model_init", lambda *a, **k: tpipe)
    flags = ["--model-path", "ignored", "--videos", str(videos), "--batch", "2",
             "--frames", str(CFG.num_frames), "--max-new-tokens", "8"]
    monkeypatch.setattr(sys, "argv", ["serve_batch", "--out", str(tmp_path / "j.jsonl")] + flags)
    jmod.main()
    capsys.readouterr()
    result = serve_batch.main(["--out", str(tmp_path / "t.jsonl")] + flags)
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == f"serve_batch: video containers read through {container_reader()}"
    assert container_reader().startswith("opencv") or route != "opencv"
    lines = [json.loads(line) for line in (tmp_path / "t.jsonl").read_text().splitlines()]
    jlines = [json.loads(line) for line in (tmp_path / "j.jsonl").read_text().splitlines()]
    assert [("error" in line) for line in lines] == [True, False, False]
    if route != "opencv":  # the native route's error is its own reader's words
        lines[0]["error"] = jlines[0]["error"]
    assert lines == jlines
    assert result["ok"] == 2 and result["failed"] == 1


def test_serve_batch_cli_matches_jax(pipes, tmp_path, monkeypatch):
    """``python -m trace_tpu_torch.runtime.serve_batch`` writes the JSONL of
    the JAX package's scripts/inference/serve_batch.py: one line per video,
    an ``error`` line for the file that does not load; the shard split and
    its file names as there."""
    import importlib.util
    import json

    import trace_tpu.runtime.pipeline as jpl
    import trace_tpu_torch.runtime.pipeline as tpl
    from trace_tpu_torch.runtime import serve_batch

    spec = importlib.util.spec_from_file_location(
        "jax_serve_batch", ROOT / "scripts" / "inference" / "serve_batch.py")
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    jpipe, tpipe = pipes
    T = CFG.num_frames
    videos = tmp_path / "videos"
    videos.mkdir()
    rng = np.random.default_rng(15)
    for i in range(4):
        np.save(videos / f"v{i}.npy", rng.integers(0, 256, (T, 56, 56, 3), dtype=np.uint8))
    (videos / "bad.npy").write_bytes(b"not a numpy file")
    (videos / "notes.txt").write_text("skipped")
    monkeypatch.setattr(jpl, "model_init", lambda *a, **k: jpipe)
    monkeypatch.setattr(tpl, "model_init", lambda *a, **k: tpipe)
    for shards in ([], ["--num-shards", "2", "--shard", "1"]):
        flags = ["--model-path", "ignored", "--videos", str(videos), "--batch", "2",
                 "--frames", str(T), "--max-new-tokens", "8"] + shards
        monkeypatch.setattr(sys, "argv", ["serve_batch", "--out", str(tmp_path / "j.jsonl")]
                            + flags)
        jmod.main()
        result = serve_batch.main(["--out", str(tmp_path / "t.jsonl")] + flags)
        suffix = "_shard1of2" if shards else ""
        want = (tmp_path / f"j{suffix}.jsonl").read_text().splitlines()
        got = (tmp_path / f"t{suffix}.jsonl").read_text().splitlines()
        assert got == want
        lines = [json.loads(line) for line in got]
        errors = [line for line in lines if "error" in line]
        assert len(lines) == (2 if shards else 5) and len(errors) == (0 if shards else 1)
        assert result["ok"] + result["failed"] == len(lines)
