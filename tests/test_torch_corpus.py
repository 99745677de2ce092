"""The port's prefill/decode split and corpus inference against the JAX
package's (tests/test_split_decode.py and tests/test_corpus_inference.py
check the JAX side against itself): greedy token streams and parsed events
must be identical, on the tiny config in fp32 with the same weights.

The int8-cache test runs the JAX side as it runs on a TPU, in interpret
mode (its Pallas flash kernel for prefill, its Pallas int8 decode kernel for
the steps; head_dim 128, which that kernel wants), as
tests/test_torch_decoder.py does."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trace_tpu.model.config import DecoderConfig as JDecoderConfig
from trace_tpu.model.config import TraceConfig as JTraceConfig
from trace_tpu.model.mistral import init_decoder_params
from trace_tpu.model.mistral import init_kv_cache as jax_init_kv_cache
from trace_tpu.model.trace_model import init_trace_params as jax_init
from trace_tpu.runtime import generate as jgen
from trace_tpu.runtime.pipeline import TracePipeline as JaxPipeline
from trace_tpu.tokenizers.text import ByteTokenizer as JaxByteTokenizer
from trace_tpu_torch.model.config import DecoderConfig, TraceConfig
from trace_tpu_torch.model.mistral import init_kv_cache
from trace_tpu_torch.params import from_jax_params
from trace_tpu_torch.runtime import generate as tgen
from trace_tpu_torch.runtime.pipeline import TracePipeline
from trace_tpu_torch.tokenizers.text import ByteTokenizer

JDEC, DEC = JDecoderConfig.tiny(), DecoderConfig.tiny()
B, P, NEW = 4, 8, 12
PAD = tgen.PAD_OUTPUT_ID


def _decoder(jcfg, seed):
    jp = init_decoder_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    # larger output heads spread the greedy stream over many ids and heads
    for name in ("lm_head", "sync_head", "time_head", "score_head"):
        jp[name] = jnp.asarray(rng.standard_normal(jp[name].shape).astype(np.float32))
    rows = [rng.standard_normal((n, jcfg.hidden_size)).astype(np.float32)
            for n in (1, jcfg.time_vocab_size, jcfg.score_vocab_size)]
    jemb = jgen.build_combined_embedding(jp["embed"], *map(jnp.asarray, rows))
    prefix = (rng.standard_normal((B, P, jcfg.hidden_size)) * 0.5).astype(np.float32)
    mask = np.ones((B, P), bool)
    mask[0, :3] = False  # two rows left-padded to other real lengths
    mask[2, :1] = False
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    return jp, jemb, tp, torch.from_numpy(np.array(jemb)), prefix, mask


@pytest.fixture(scope="module")
def dec():
    return _decoder(JDEC, 0)


def _port(tp, temb, prefix, mask, cfg=DEC, fn=tgen.generate_split, **kw):
    return fn(tp, cfg, torch.from_numpy(prefix), torch.from_numpy(mask), temb, **kw)


@pytest.mark.parametrize("sub", [1, 2, 3])
def test_generate_split_matches_jax_and_monolithic(dec, sub):
    jp, jemb, tp, temb, prefix, mask = dec
    want = jgen.generate_split(jp, JDEC, jnp.asarray(prefix), jnp.asarray(mask), jemb,
                               prefill_batch=sub, max_new_tokens=NEW, use_flash=False)
    got = _port(tp, temb, prefix, mask, prefill_batch=sub, max_new_tokens=NEW, time_phases=True)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.num_generated, want.num_generated)
    mono = _port(tp, temb, prefix, mask, fn=tgen.generate, max_new_tokens=NEW)
    np.testing.assert_array_equal(got.tokens, mono.tokens)
    assert set(got.phase_times) == {"prefill_s", "decode_s"} and got.cache is not None
    assert (got.tokens != PAD).any(axis=1).all()


@pytest.mark.parametrize("sub", [2, 4])
def test_prefill_merge_decode_matches_jax(dec, sub):
    """The phases as entry points of their own: prefill in sub-batches,
    merge_cache_rows into one cache, one decode (with max_steps), as
    tests/test_split_decode.py runs them on the JAX side."""
    jp, jemb, tp, temb, prefix, mask = dec
    S = P + NEW
    heads = jnp.ones((B,), jnp.int32)
    want, want_n = jgen.generate_jit(jp, JDEC, jnp.asarray(prefix), jnp.asarray(mask), jemb,
                                     heads, max_new_tokens=NEW, cache_len=S,
                                     rng=jax.random.PRNGKey(0))
    big = init_kv_cache(DEC, B, S, dtype=torch.float32)
    cms, lhs, nps = [], [], []
    for r in range(0, B, sub):
        cache, cm, lh, npos = tgen.prefill(tp, DEC, torch.from_numpy(prefix[r:r + sub]),
                                           torch.from_numpy(mask[r:r + sub]), cache_len=S)
        assert tgen.merge_cache_rows(big, cache, r) is big
        cms.append(cm)
        lhs.append(lh)
        nps.append(npos)
    cm = torch.cat(cms)
    tokens, num, steps = tgen.decode(tp, DEC, big, cm, torch.cat(lhs), torch.cat(nps), temb,
                                     torch.ones(B, dtype=torch.long), prefix_len=P,
                                     max_new_tokens=NEW)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want))
    np.testing.assert_array_equal(num.numpy(), np.asarray(want_n))
    assert cm[:, P:P + steps].all() and not cm[:, P + steps:].any()


@pytest.mark.parametrize("pb", [1, 2, 3])
def test_generate_prefill_batch_matches_jax(dec, pb):
    jp, jemb, tp, temb, prefix, mask = dec
    want = jgen.generate(jp, JDEC, jnp.asarray(prefix), jnp.asarray(mask), jemb,
                         max_new_tokens=NEW, prefill_batch=pb, use_flash=False)
    got = _port(tp, temb, prefix, mask, fn=tgen.generate, max_new_tokens=NEW, prefill_batch=pb)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    mono = _port(tp, temb, prefix, mask, fn=tgen.generate, max_new_tokens=NEW)
    np.testing.assert_array_equal(got.tokens, mono.tokens)


def test_generate_split_takes_ownership_of_list_arguments(dec):
    _, _, tp, temb, prefix, mask = dec
    pe, pm = [torch.from_numpy(prefix)], [torch.from_numpy(mask)]
    got = tgen.generate_split(tp, DEC, pe, pm, temb, prefill_batch=2, max_new_tokens=NEW)
    assert pe == [] and pm == []
    want = _port(tp, temb, prefix, mask, prefill_batch=2, max_new_tokens=NEW)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_generate_split_arena_reuse(dec):
    """A reused arena (stale contents of another batch) changes no token;
    an arena of other shapes is replaced by a new one."""
    jp, jemb, tp, temb, prefix, mask = dec
    prefix2 = (np.random.default_rng(11).standard_normal(prefix.shape) * 0.5).astype(np.float32)
    want = jgen.generate_split(jp, JDEC, jnp.asarray(prefix2), jnp.asarray(mask), jemb,
                               prefill_batch=2, max_new_tokens=NEW, use_flash=False)
    first = _port(tp, temb, prefix, mask, prefill_batch=2, max_new_tokens=NEW)
    arena = first.cache
    got = _port(tp, temb, prefix2, mask, prefill_batch=2, max_new_tokens=NEW, cache=arena)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.cache is arena  # the same tensors, written in place
    bad = init_kv_cache(DEC, B, P + NEW + 128)
    got2 = _port(tp, temb, prefix2, mask, prefill_batch=2, max_new_tokens=NEW, cache=bad)
    np.testing.assert_array_equal(got2.tokens, want.tokens)
    assert got2.cache is not bad


def test_token_budget_stops_at_max_new_tokens(dec):
    """token_budget sizes the arena and the token buffer for the larger
    budget while the loop stops at max_new_tokens (PAD beyond); a
    budget-length run on the same arena decodes the same first tokens."""
    jp, jemb, tp, temb, prefix, mask = dec
    budget = NEW + 8
    want = jgen.generate_split(jp, JDEC, jnp.asarray(prefix), jnp.asarray(mask), jemb,
                               prefill_batch=2, max_new_tokens=NEW, use_flash=False,
                               token_budget=budget)
    short = _port(tp, temb, prefix, mask, prefill_batch=2, max_new_tokens=NEW,
                  token_budget=budget)
    assert short.tokens.shape == want.tokens.shape == (B, budget)
    np.testing.assert_array_equal(short.tokens, want.tokens)
    assert (short.tokens[:, NEW:] == PAD).all()
    assert short.decode_steps <= NEW - 1
    plain = _port(tp, temb, prefix, mask, prefill_batch=2, max_new_tokens=NEW)
    np.testing.assert_array_equal(short.tokens[:, :NEW], plain.tokens)
    arena = short.cache
    long = _port(tp, temb, prefix, mask, prefill_batch=2, max_new_tokens=budget,
                 token_budget=budget, cache=arena)
    assert long.cache is arena and long.tokens.shape == (B, budget)
    np.testing.assert_array_equal(long.tokens[:, :NEW], plain.tokens)
    jlong = jgen.generate_split(jp, JDEC, jnp.asarray(prefix), jnp.asarray(mask), jemb,
                                prefill_batch=2, max_new_tokens=budget, use_flash=False,
                                token_budget=budget)
    np.testing.assert_array_equal(long.tokens, jlong.tokens)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_merge_cache_rows_matches_jax(kv):
    """Rows [2, 4) of the big cache replaced in place, the others kept."""
    jcfg = dataclasses.replace(JDEC, kv_cache_dtype=kv)
    rng = np.random.default_rng(3)

    def rand(cache):
        if isinstance(cache, dict):
            return {k: (rng.integers(-127, 128, v.shape).astype(np.int8) if v.dtype == jnp.int8
                        else rng.random(v.shape).astype(np.float32)) for k, v in cache.items()}
        return tuple(rng.standard_normal(v.shape).astype(np.float32) for v in cache)

    big, small = rand(jax_init_kv_cache(jcfg, 5, 16, jnp.float32)), \
        rand(jax_init_kv_cache(jcfg, 2, 16, jnp.float32))
    cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16)
                                  if a.dtype == np.float32 and kv == "int8" else jnp.asarray(a), t)
    want = jgen.merge_cache_rows(cast(big), cast(small), jnp.int32(2))
    tcast = lambda t: jax.tree.map(
        lambda a: torch.from_numpy(a).to(torch.bfloat16) if a.dtype == np.float32 and kv == "int8"
        else torch.from_numpy(a.copy()), t)
    tbig = tcast(big)
    got = tgen.merge_cache_rows(tbig, tcast(small), 2)
    assert got is tbig
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))


# ---------------------------------------------------------------------------
# The split over an int8 KV cache, the JAX side through its interpreted
# kernels (see the module docstring).
# ---------------------------------------------------------------------------

QJDEC = dataclasses.replace(JDEC, num_heads=4, num_kv_heads=2, head_dim=128, hidden_size=128,
                            kv_cache_dtype="int8")
QDEC = dataclasses.replace(DEC, num_heads=4, num_kv_heads=2, head_dim=128, hidden_size=128,
                           kv_cache_dtype="int8")


@pytest.fixture
def jax_kernels_interpreted(monkeypatch):
    from trace_tpu.kernels import flash_attention as jfa

    monkeypatch.setenv("TRACE_TPU_DECODE_ATTN", "force")
    for name in ("TRACE_TPU_DECODE_ATTN_S8", "TRACE_TPU_STACKED_QMM", "TRACE_TPU_QMM"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(
        jfa, "flash_attention_trainable",
        lambda q, k, v, bias, causal=False: jfa.flash_attention(
            q, k, v, bias, causal=causal, interpret=True))


def test_generate_split_int8_cache_matches_jax(jax_kernels_interpreted):
    jp, jemb, tp, temb, prefix, mask = _decoder(QJDEC, 1)
    new = 16  # the 128-slot bucket + 16: a cache length the JAX kernel takes
    want = jgen.generate_split(jp, QJDEC, jnp.asarray(prefix), jnp.asarray(mask), jemb,
                               prefill_batch=2, max_new_tokens=new, use_flash=True)
    got = _port(tp, temb, prefix, mask, cfg=QDEC, prefill_batch=2, max_new_tokens=new)
    assert isinstance(got.cache, dict) and got.cache["kq"].dtype == torch.int8
    np.testing.assert_array_equal(got.tokens, want.tokens)
    mono = _port(tp, temb, prefix, mask, cfg=QDEC, fn=tgen.generate, max_new_tokens=new)
    np.testing.assert_array_equal(got.tokens, mono.tokens)


# ---------------------------------------------------------------------------
# Corpus inference, on the tiny TRACE config
# ---------------------------------------------------------------------------

JCFG, CFG = JTraceConfig.tiny(), TraceConfig.tiny()


def _pipes(jcfg=JCFG, cfg=CFG, seed=0):
    jp = jax_init(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 9)
    dec = dict(jp["decoder"])
    for name in ("lm_head", "sync_head", "time_head", "score_head"):
        dec[name] = jnp.asarray(rng.standard_normal(dec[name].shape).astype(np.float32))
    jp = {**jp, "decoder": dec}
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    return (JaxPipeline(params=jp, config=jcfg, tokenizer=JaxByteTokenizer()),
            TracePipeline(tp, cfg, ByteTokenizer(), device="cpu"))


@pytest.fixture(scope="module")
def pipes():
    return _pipes()


def _items(n, shape=(56, 56), seed=0):
    T = CFG.num_frames
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 255, (T,) + shape + (3,), dtype=np.uint8),
             [[float(2 * i + k)] for i in range(T)], f"question {k}") for k in range(n)]


def _dicts(preds):
    return [p.to_dict() for p in preds]


def test_corpus_matches_jax_and_per_video(pipes):
    jpipe, tpipe = pipes
    items = _items(3)
    kw = dict(encode_batch=2, decode_batch=2, max_new_tokens=12)
    got = tpipe.infer_events_corpus(lambda i: items[i], 3, **kw)
    assert _dicts(got) == _dicts(jpipe.infer_events_corpus(lambda i: items[i], 3, **kw))
    singles = [tpipe.infer_events_from_frames(f, ts, q, max_new_tokens=12) for f, ts, q in items]
    assert _dicts(got) == _dicts(singles)
    assert set(tpipe.last_corpus_stats) == set(jpipe.last_corpus_stats)
    assert tpipe.last_corpus_stats["prefix_tokens"] == jpipe.last_corpus_stats["prefix_tokens"]


def test_corpus_split_store_path_matches_jax(pipes):
    """Split mode: prefixes into per-chunk stores, one reused arena."""
    jpipe, tpipe = pipes
    items = _items(6, seed=1)
    kw = dict(encode_batch=2, decode_batch=4, prefill_batch=2, max_new_tokens=12)
    got = tpipe.infer_events_corpus(lambda i: items[i], 6, **kw)
    assert _dicts(got) == _dicts(jpipe.infer_events_corpus(lambda i: items[i], 6, **kw))
    plain = tpipe.infer_events_corpus(lambda i: items[i], 6, encode_batch=2, decode_batch=2,
                                      max_new_tokens=12)
    assert _dicts(got) == _dicts(plain)
    assert tpipe.last_corpus_stats["streamed"] is False


def test_corpus_prepared_np_items_match(pipes):
    """load_item may return PreparedSampleNP items: the same results as the
    raw triples, two-phase and streamed."""
    jpipe, tpipe = pipes
    items = _items(4, shape=(40, 56), seed=2)
    kw = dict(encode_batch=2, decode_batch=2, max_new_tokens=12)
    want = tpipe.infer_events_corpus(lambda i: items[i], 4, **kw)
    prepared = [tpipe.prepare_sample_host_np(f, ts, q) for f, ts, q in items]
    got = tpipe.infer_events_corpus(lambda i: prepared[i], 4, **kw)
    assert _dicts(got) == _dicts(want)
    got2 = tpipe.infer_events_corpus(lambda i: prepared[i], 4, encode_batch=2, decode_batch=4,
                                     prefill_batch=2, max_new_tokens=12, streamed=True)
    assert _dicts(got2) == _dicts(want)
    jprepared = [jpipe.prepare_sample_host_np(f, ts, q) for f, ts, q in items]
    assert _dicts(got) == _dicts(jpipe.infer_events_corpus(lambda i: jprepared[i], 4, **kw))


def test_corpus_split_bucket_overflow(pipes):
    """A later prompt longer than the first batch's bucket sends its chunk
    back to per-video rows without touching the other chunks."""
    jpipe, tpipe = pipes
    items = _items(4, seed=3)
    items[3] = (items[3][0], items[3][1], "why " * 80)
    kw = dict(encode_batch=2, decode_batch=2, prefill_batch=1, max_new_tokens=10)
    got = tpipe.infer_events_corpus(lambda i: items[i], 4, **kw)
    singles = [tpipe.infer_events_from_frames(f, ts, q, max_new_tokens=10) for f, ts, q in items]
    assert _dicts(got) == _dicts(singles)
    assert _dicts(got) == _dicts(jpipe.infer_events_corpus(lambda i: items[i], 4, **kw))


def test_streamed_corpus_matches_two_phase_and_jax(pipes):
    """Streamed (decode thread beside the encode loop) gives exactly the
    two-phase results, a partial last chunk included, and the JAX
    package's."""
    jpipe, tpipe = pipes
    items = _items(7, shape=(40, 56), seed=4)
    kw = dict(encode_batch=2, decode_batch=3, prefill_batch=1, max_new_tokens=8,
              token_budget=12, offload_vision=False)
    streamed = tpipe.infer_events_corpus(lambda i: items[i], 7, streamed=True, **kw)
    assert tpipe.last_corpus_stats["streamed"] is True
    two_phase = tpipe.infer_events_corpus(lambda i: items[i], 7, streamed=False, **kw)
    assert _dicts(streamed) == _dicts(two_phase)
    want = jpipe.infer_events_corpus(lambda i: items[i], 7, streamed=True, **kw)
    assert jpipe.last_corpus_stats["streamed"] is True
    assert _dicts(streamed) == _dicts(want)


def test_corpus_constrain_time_matches_jax(pipes):
    jpipe, tpipe = pipes
    items = _items(4, seed=5)
    kw = dict(encode_batch=2, decode_batch=4, prefill_batch=2, max_new_tokens=16,
              constrain_time=True)
    got = tpipe.infer_events_corpus(lambda i: items[i], 4, **kw)
    assert _dicts(got) == _dicts(jpipe.infer_events_corpus(lambda i: items[i], 4, **kw))


def test_streamed_decode_failure_propagates(pipes, monkeypatch):
    """An exception on the decode thread reaches the caller."""
    _, tpipe = pipes
    items = _items(6, seed=6)

    def boom(*a, **k):
        raise RuntimeError("synthetic decode failure")

    monkeypatch.setattr(tgen, "generate_split", boom)
    with pytest.raises(RuntimeError, match="synthetic decode failure"):
        tpipe.infer_events_corpus(lambda i: items[i], 6, encode_batch=2, decode_batch=3,
                                  prefill_batch=1, max_new_tokens=6, streamed=True)


# ---------------------------------------------------------------------------
# The yuv420 upload
# ---------------------------------------------------------------------------

YJCFG = dataclasses.replace(JCFG, upload_format="yuv420")
YCFG = dataclasses.replace(CFG, upload_format="yuv420")


@pytest.fixture(scope="module")
def yuv_pipes():
    return _pipes(YJCFG, YCFG, seed=1)


def _mixed_videos():
    """Landscape larger than 1.3 S^2 (band route), square at S (the whole
    frame), portrait larger than 1.3 S^2 (full host downscale, then the
    band), and a small frame (rgb route, cut into patches to join the
    batch)."""
    rng = np.random.default_rng(8)
    T = CFG.num_frames
    shapes = [(90, 160), (56, 56), (160, 120), (40, 48)]
    vids = [rng.integers(0, 256, (T, h, w, 3), dtype=np.uint8) for h, w in shapes]
    ts = [[[float(2 * i)] for i in range(T)]] * len(vids)
    return vids, ts, ["Find the events."] * len(vids)


def test_yuv420_infer_events_batch_matches_jax(yuv_pipes):
    jpipe, tpipe = yuv_pipes
    vids, ts, qs = _mixed_videos()
    jprefix, jmask = jpipe._prepare_prefix_batch(vids, ts, qs)
    tprefix, tmask = tpipe.encode_prefix(vids, ts, qs)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    # the device preprocess differs from XLA's by fp32 ulps (test_torch_yuv)
    np.testing.assert_allclose(tprefix.numpy(), np.asarray(jprefix), rtol=2e-5, atol=2e-5)
    want = jpipe.infer_events_batch(vids, ts, qs, max_new_tokens=40)
    got = tpipe.infer_events_batch(vids, ts, qs, max_new_tokens=40)
    assert _dicts(got) == _dicts(want)
    jtok = jgen.generate(jpipe._decoder_params, YJCFG.decoder, jprefix, jmask,
                         jpipe._combined, max_new_tokens=40, initial_head=1)
    np.testing.assert_array_equal(tpipe.last_stats["tokens"], jtok.tokens)


def test_yuv420_corpus_matches_jax(yuv_pipes):
    """The bench's serving shape at the tiny size: 16:9 frames prepared on
    the host, streamed split corpus with a token budget."""
    jpipe, tpipe = yuv_pipes
    rng = np.random.default_rng(12)
    T = CFG.num_frames
    vids = [rng.integers(0, 256, (T, 72, 128, 3), dtype=np.uint8) for _ in range(3)]
    ts = [[float(i)] for i in range(T)]
    pool = [tpipe.prepare_sample_host_np(v, ts, "Localize the events.") for v in vids]
    jpool = [jpipe.prepare_sample_host_np(v, ts, "Localize the events.") for v in vids]
    assert pool[0].frames_spec[0] == "yuv_band_p"
    kw = dict(encode_batch=2, decode_batch=4, prefill_batch=2, max_new_tokens=12,
              token_budget=16)
    got = tpipe.infer_events_corpus(lambda i: pool[i % 3], 8, streamed=True, **kw)
    two_phase = tpipe.infer_events_corpus(lambda i: pool[i % 3], 8, **kw)
    assert _dicts(got) == _dicts(two_phase)
    want = jpipe.infer_events_corpus(lambda i: jpool[i % 3], 8, **kw)
    assert _dicts(got) == _dicts(want)
