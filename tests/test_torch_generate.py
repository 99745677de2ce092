"""The port's generate loop against the JAX package's on the tiny decoder:
greedy token streams must be identical (EOS, stop sequences, the
time-constraint trie included), with the same weights and prefix."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trace_tpu.model.config import DecoderConfig as JDecoderConfig
from trace_tpu.model.mistral import init_decoder_params
from trace_tpu.runtime import generate as jgen
from trace_tpu.tokenizers.event_codec import TIME_CODEC
from trace_tpu_torch.model.config import DecoderConfig
from trace_tpu_torch.params import from_jax_params
from trace_tpu_torch.runtime import generate as tgen

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

JCFG = JDecoderConfig.tiny()
CFG = DecoderConfig.tiny()
B, P = 2, 20


@pytest.fixture(scope="module")
def model():
    jp = init_decoder_params(JCFG, jax.random.PRNGKey(0))
    # larger output heads spread the greedy stream over many ids and heads
    rng = np.random.default_rng(0)
    for name in ("lm_head", "sync_head", "time_head", "score_head"):
        jp[name] = jnp.asarray(rng.standard_normal(jp[name].shape).astype(np.float32))
    rows = [rng.standard_normal((n, CFG.hidden_size)).astype(np.float32)
            for n in (1, CFG.time_vocab_size, CFG.score_vocab_size)]
    jemb = jgen.build_combined_embedding(jp["embed"], *map(jnp.asarray, rows))
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    temb = torch.from_numpy(np.array(jemb))
    prefix = rng.standard_normal((B, P, CFG.hidden_size)).astype(np.float32)
    mask = np.ones((B, P), bool)
    mask[1, :5] = False  # row 1 is shorter, left-padded
    return jp, jemb, tp, temb, prefix, mask


def _both(model, **kw):
    jp, jemb, tp, temb, prefix, mask = model
    jkw = dict(kw)
    tkw = dict(kw)
    if "frame_time_ids" in kw:
        jkw["frame_time_ids"] = jnp.asarray(kw["frame_time_ids"])
        tkw["frame_time_ids"] = torch.from_numpy(kw["frame_time_ids"])
    want = jgen.generate(jp, JCFG, jnp.asarray(prefix), jnp.asarray(mask), jemb, **jkw)
    got = tgen.generate(tp, CFG, torch.from_numpy(prefix), torch.from_numpy(mask),
                        temb, **tkw)
    return got, want


@pytest.mark.parametrize("initial_head", [0, 1])
def test_greedy_tokens_exact(model, initial_head):
    got, want = _both(model, max_new_tokens=24, initial_head=initial_head, eos_id=-5)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.num_generated, want.num_generated)
    assert got.decode_steps == 23
    if initial_head == 1:  # the time stream ends in <sync>: the FSM moves on
        heads_seen = {0 if t <= CFG.vocab_size else
                      1 if t < CFG.vocab_size + 1 + CFG.time_vocab_size else 2
                      for t in got.tokens.ravel()}
        assert len(heads_seen) >= 2


def test_eos_ends_rows_exactly(model):
    first, _ = _both(model, max_new_tokens=16, initial_head=0, eos_id=-5)
    eos = int(first.tokens[0, 3])  # row 0 emits it at step 3
    got, want = _both(model, max_new_tokens=16, initial_head=0, eos_id=eos)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.tokens[0, 3] == eos and (got.tokens[0, 4:] == tgen.PAD_OUTPUT_ID).all()


def test_stop_sequence_ends_rows_exactly(model):
    first, _ = _both(model, max_new_tokens=16, initial_head=0, eos_id=-5)
    stop = [int(first.tokens[1, 4]), int(first.tokens[1, 5])]
    got, want = _both(model, max_new_tokens=16, initial_head=0, eos_id=-5,
                      stop_sequences=[stop, [7, 7, 7]])
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert (got.tokens[1, 6:] == tgen.PAD_OUTPUT_ID).all()


def test_time_constraint_trie_exact(model):
    rng = np.random.default_rng(1)
    T = 5
    frame_ids = np.stack([
        np.stack([np.asarray(TIME_CODEC.encode_value(float(t)), np.int32)
                  for t in sorted(rng.uniform(0, 900, T))])
        for _ in range(B)
    ])
    got, want = _both(model, max_new_tokens=30, initial_head=1, eos_id=-5,
                      constrain_time=True, frame_time_ids=frame_ids)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_sampling_stays_in_head_slices_and_is_seeded(model):
    """temperature > 0 draws with torch.multinomial: equal to JAX in
    distribution only, so check structure and reproducibility."""
    _, _, tp, temb, prefix, mask = model
    run = lambda seed: tgen.generate(
        tp, CFG, torch.from_numpy(prefix), torch.from_numpy(mask), temb,
        max_new_tokens=20, temperature=1.0, seed=seed, eos_id=-5)
    a, b, c = run(3), run(3), run(4)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert not np.array_equal(a.tokens, c.tokens)
    assert ((a.tokens >= 0) & (a.tokens < CFG.combined_vocab_size)).all()


def test_tables_and_packing_match():
    np.testing.assert_array_equal(tgen.head_mask_table(CFG).numpy(),
                                  np.asarray(jgen.head_mask_table(JCFG)))
    tok = np.array([CFG.vocab_size, CFG.vocab_size + 1, CFG.vocab_size + 14, 5])
    head = np.array([0, 1, 2, 1])
    np.testing.assert_array_equal(
        tgen.swap_heads(CFG, torch.from_numpy(head), torch.from_numpy(tok)).numpy(),
        np.asarray(jgen.swap_heads(JCFG, jnp.asarray(head), jnp.asarray(tok))))
    seqs = [[4, 5, 6], [9], []]
    np.testing.assert_array_equal(tgen.pack_stop_sequences(seqs).numpy(),
                                  np.asarray(jgen.pack_stop_sequences(seqs)))
    assert tgen.pack_stop_sequences([]) is None
