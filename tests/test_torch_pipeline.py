"""The port's TracePipeline against the JAX package's on the tiny config
(ByteTokenizer, weights through ``from_jax_params``), and the port's import
guard."""

import ast
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


def test_unported_host_paths_raise(pipes):
    import dataclasses

    _, tpipe = pipes
    frames = np.zeros((2, 56, 56, 3), np.uint8)
    tp = from_jax_params(jax.tree.map(np.asarray, _jax_params()))
    yuv = TracePipeline(tp, dataclasses.replace(CFG, upload_format="yuv420"),
                        ByteTokenizer(), device="cpu")
    with pytest.raises(NotImplementedError):
        yuv.infer_events_from_frames(frames, [[0.0], [1.0]], "q", max_new_tokens=2)
    big = np.zeros((2, 120, 120, 3), np.uint8)  # would need the cv2 downscale
    with pytest.raises(NotImplementedError):
        tpipe.infer_events_from_frames(big, [[0.0], [1.0]], "q", max_new_tokens=2)


def test_pipeline_defaults_to_cuda():
    if torch.cuda.is_available():
        assert TracePipeline({}, CFG, ByteTokenizer()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TracePipeline({}, CFG, ByteTokenizer())


def _port_sources():
    return sorted((ROOT / "trace_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_never_imports_jax_or_the_jax_package():
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "trace_tpu"), f"{path}: imports {name}"


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "trace_tpu_torch").rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'trace_tpu'))\n"
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
