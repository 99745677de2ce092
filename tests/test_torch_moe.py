"""The port's Mixtral family (trace_tpu_torch/model/moe.py, the routed MLP
in model/mistral.py, checkpoint/convert.py's Mixtral route, model_init and
training) against the JAX package's on ``tiny_moe`` and a tiny HF
``MixtralForCausalLM``, with weights and inputs made by numpy from a seed
and carried across by ``from_jax_params``.

Tolerances: fp32 outputs of ``moe_mlp`` within rtol 1e-5 / atol 1e-6 of the
largest |value| (the same products summed in other orders; the dense mix sums
its experts in order 0 .. E-1, JAX's einsum in its own); the routing integers
(top-k indices, ``keep``, ``slot``) exactly equal; decoder hidden states and
logits within 1e-5 (tests/test_torch_decoder.py's limit); HF's logits within
3e-4 (tests/test_mixtral.py's limit for JAX); gradients rtol 2e-4 (as
tests/test_torch_train.py) with an atol of 1e-5 of the leaf's largest
gradient, where that file allows 2e-6: behind a routed layer the backward
also runs through the gates' softmax Jacobian, differences of near-equal
products, and an element near zero of a leaf upstream (the connector's slots)
keeps fp32 noise of up to ~3e-6 of the largest; greedy streams token-exact.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file as save_torch

from test_torch_checkpoint import (
    MANIFEST,
    _value,
    assert_trees_equal,
    hf_config_of,
    jax_config,
    tiny_vision,  # noqa: F401  (a fixture)
    write_hf_tokenizer,
)
from test_torch_train import _batch as train_batch
from test_torch_train import _jax_loss_and_grads, _paths, _torch_loss_and_grads
from trace_tpu.checkpoint import convert as jconvert
from trace_tpu.model import lora as jlora
from trace_tpu.model import mistral as jm
from trace_tpu.model import moe as jmoe
from trace_tpu.model import trace_model as jtm
from trace_tpu.model.config import TraceConfig as JTraceConfig
from trace_tpu.model.quantize import quantize_decoder_params_host
from trace_tpu.runtime import generate as jgen
from trace_tpu.video.io import load_video_frames as jax_load_video
from trace_tpu_torch.checkpoint import convert as tconvert
from trace_tpu_torch.model import mistral as tm
from trace_tpu_torch.model import moe as tmoe
from trace_tpu_torch.model.config import MoEConfig, TraceConfig
from trace_tpu_torch.model.quantize import (
    int4_serving,
    int4p_serving,
    int8_serving,
    quantize_decoder_params,
    quantize_trace_params,
)
from trace_tpu_torch.params import from_jax_params
from trace_tpu_torch.runtime import generate as tgen
from trace_tpu_torch.train import train as ttrain

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

JCFG = jmoe.MoEConfig.tiny_moe()
CFG = MoEConfig.tiny_moe()
RTOL, ATOL = 1e-5, 1e-6  # moe_mlp, fp32; atol in units of max |ref|
TOL = 1e-5               # decoder hidden states and logits
HF_TOL = 3e-4
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-5  # gradients; atol in units of the leaf's max |ref|


def _configs(**kw):
    return dataclasses.replace(JCFG, **kw), dataclasses.replace(CFG, **kw)


def _layer_weights(seed, E=None, D=64, I=96):
    """One layer's router and experts at scales that give O(1) outputs and
    spread routing: router N(0, 0.3), w_gate / w_up N(0, 0.15), w_down
    N(0, 0.1)."""
    E = E or CFG.num_experts
    rng = np.random.default_rng(seed)
    w = lambda shape, s: (rng.standard_normal(shape) * s).astype(np.float32)
    return {"router": w((D, E), 0.3), "w_gate": w((E, D, I), 0.15),
            "w_up": w((E, D, I), 0.15), "w_down": w((E, I, D), 0.1)}


def _x(seed, B, T, D=64, zero_rows=()):
    x = np.random.default_rng(seed).standard_normal((B, T, D)).astype(np.float32)
    for b, t in zero_rows:
        x[b, t] = 0.0
    return x


def _jax_routing(x, lp, jc):
    """JAX's routing integers for x [B, T, D], written out from
    trace_tpu/model/moe.py:_moe_mlp_sparse (its lines 99-112)."""
    N, E, k = x.shape[0] * x.shape[1], jc.num_experts, jc.top_k
    C = max(1, math.ceil(N * k * jc.capacity_factor / E))
    logits = jnp.einsum("nd,de->ne", jnp.asarray(x.reshape(N, -1)), lp["router"],
                        preferred_element_type=jnp.float32)
    _, top_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    flat_e = top_idx.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    within = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=1)
    keep = within < C
    slot = jnp.where(keep, flat_e * C + within, E * C)
    return C, np.asarray(top_idx), np.asarray(keep), np.asarray(slot)


def _moe_both(x, lp_np, jc, tc):
    want = np.asarray(jmoe.moe_mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in lp_np.items()},
                                   jc))
    tlp = from_jax_params(lp_np)
    got = tmoe.moe_mlp(torch.from_numpy(x), tlp, tc).numpy()
    return got, want, tlp


def _check_routing(x, lp_np, jc, tc, tlp):
    C, jidx, jkeep, jslot = _jax_routing(x, {k: jnp.asarray(v) for k, v in lp_np.items()}, jc)
    N = x.shape[0] * x.shape[1]
    _, tidx = tmoe.route(torch.from_numpy(x).reshape(N, -1), tlp["router"], tc.top_k)
    assert tmoe.capacity(N, tc) == C
    _, tkeep, tslot = tmoe.dispatch(tidx, tc.num_experts, C)
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    np.testing.assert_array_equal(tkeep.numpy(), jkeep)
    np.testing.assert_array_equal(tslot.numpy(), jslot)
    return C, jkeep


def _assert_close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * np.abs(want).max())


# ---------------------------------------------------------------------------
# moe_mlp: both forms, routing integers, capacity, ties, the aux loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl,cf", [("dense", 2.0), ("sparse", 2.0), ("sparse", 0.25)])
def test_moe_mlp_matches_jax(impl, cf):
    """B 2 x T 16 tokens, E 4, k 2: at cf 2 C = 32 = N and nothing drops; at
    cf 0.25 C = 4, the buckets overflow and the dropped assignments are
    JAX's."""
    jc, tc = _configs(moe_impl=impl, capacity_factor=cf)
    x, lp = _x(1, 2, 16), _layer_weights(0)
    got, want, tlp = _moe_both(x, lp, jc, tc)
    _assert_close(got, want)
    _, keep = _check_routing(x, lp, jc, tc, tlp)
    assert keep.all() == (cf == 2.0)


def test_sparse_matches_dense_without_drops():
    """At capacity_factor = E / k no assignment overflows (C = N), so the
    sparse dispatch equals the dense mixture (tests/test_mixtral.py)."""
    tc_dense = dataclasses.replace(CFG, moe_impl="dense")
    tc_sparse = dataclasses.replace(CFG, moe_impl="sparse",
                                    capacity_factor=CFG.num_experts / CFG.top_k)
    x, tlp = torch.from_numpy(_x(1, 2, 16)), from_jax_params(_layer_weights(0))
    _assert_close(tmoe.moe_mlp(x, tlp, tc_sparse).numpy(),
                  tmoe.moe_mlp(x, tlp, tc_dense).numpy())


def test_decode_step_capacity_one():
    """A decode step of B = 2 rows at Mixtral's E = 8, k = 2, cf = 2: C = 1,
    so the second assignment to an expert drops; which one is slot order,
    JAX's."""
    jc, tc = _configs(num_experts=8, moe_impl="sparse")
    lp = _layer_weights(3, E=8)
    # both rows route alike (one scaled copy of the other) so that they collide
    x = _x(4, 1, 1)
    x = np.concatenate([x, 1.5 * x], axis=0)
    got, want, tlp = _moe_both(x, lp, jc, tc)
    _assert_close(got, want)
    C, keep = _check_routing(x, lp, jc, tc, tlp)
    assert C == 1 and keep.tolist() == [True, True, False, False]


@pytest.mark.parametrize("impl", ["dense", "sparse"])
def test_ties_break_to_the_lower_expert(impl):
    """Zero rows (left padding) meet the router as exactly uniform
    probabilities: top-k takes experts 0 .. k-1, as ``jax.lax.top_k``."""
    jc, tc = _configs(moe_impl=impl)
    x, lp = _x(5, 2, 6, zero_rows=[(0, 0), (0, 1), (1, 0)]), _layer_weights(6)
    got, want, tlp = _moe_both(x, lp, jc, tc)
    _assert_close(got, want)
    _check_routing(x, lp, jc, tc, tlp)
    _, idx = tmoe.route(torch.from_numpy(x).reshape(12, -1), tlp["router"], tc.top_k)
    for n in (0, 1, 6):
        assert idx[n].tolist() == [0, 1]


def test_moe_aux_loss_matches_jax():
    x, lp = _x(7, 2, 32), _layer_weights(8)
    want = float(jmoe.moe_aux_loss(jnp.asarray(x), {k: jnp.asarray(v) for k, v in lp.items()},
                                   JCFG))
    tlp = from_jax_params(lp)
    assert abs(tmoe.moe_aux_loss(torch.from_numpy(x), tlp, CFG).item() - want) <= 1e-6
    tlp["router"] = torch.zeros_like(tlp["router"])  # uniform router: exactly 1
    assert abs(tmoe.moe_aux_loss(torch.from_numpy(x), tlp, CFG).item() - 1.0) < 1e-5


def _jax_moe_decoder(seed):
    """A tree of JAX's ``init_moe_decoder_params`` layout (its shapes, read
    without drawing them) with numpy values: weights N(0, 0.02), norms 1."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jmoe.init_moe_decoder_params(JCFG, jax.random.PRNGKey(0)))
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (np.ones(a.shape, np.float32) if "norm" in jax.tree_util.keystr(path)
                         else (rng.standard_normal(a.shape) * 0.02).astype(np.float32)),
        shapes)


def test_init_shapes_and_the_weight_bridge():
    """``init_moe_decoder_params`` builds JAX's leaves and shapes; the
    [L, E, ...] stacks of a JAX tree cross ``from_jax_params`` as they are."""
    jp = _jax_moe_decoder(0)
    tp = tmoe.init_moe_decoder_params(CFG, torch.Generator().manual_seed(0))
    bridged = from_jax_params(jp)
    flat = lambda t, p="": ({f"{p}{k}": v.shape for k, v in t.items() if not isinstance(v, dict)}
                            | {q: s for k, v in t.items() if isinstance(v, dict)
                               for q, s in flat(v, f"{p}{k}/").items()})
    assert flat(tp) == {k: torch.Size(v) for k, v in flat(jp).items()}
    assert "w_gate" in tp["layers"] and tp["layers"]["w_gate"].shape == (2, 4, 64, 96)
    for name in ("router", "w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(bridged["layers"][name].numpy(), jp["layers"][name])


# ---------------------------------------------------------------------------
# the decoder: forward, cache, greedy generation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def decoders():
    """(JAX params, port params): a tree of JAX's ``init_moe_decoder_params``
    layout with the routed leaves drawn at _layer_weights' scales."""
    jp = _jax_moe_decoder(1)
    layers = dict(jp["layers"])
    for name, shape in (("router", 0.3), ("w_gate", 0.15), ("w_up", 0.15), ("w_down", 0.1)):
        rng = np.random.default_rng(len(name))
        layers[name] = jnp.asarray(
            (rng.standard_normal(layers[name].shape) * shape).astype(np.float32))
    rng = np.random.default_rng(9)
    jp = {**jp, "layers": layers}
    for name in ("lm_head", "sync_head", "time_head", "score_head"):
        jp[name] = jnp.asarray(rng.standard_normal(jp[name].shape).astype(np.float32))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("impl", ["dense", "sparse"])
def test_decoder_prefill_and_step_match_jax(decoders, impl):
    """A left-padded prefill into a cache and one decode step: hidden states
    and logits of both against JAX's cached forward."""
    jc, tc = _configs(moe_impl=impl)
    jp, tp = decoders
    B, P, S = 2, 9, 16
    rng = np.random.default_rng(10)
    x = (rng.standard_normal((B, P + 1, 64)) * 0.5).astype(np.float32)
    mask = np.ones((B, P), bool)
    mask[1, :3] = False
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0)
    jcache = jm.init_kv_cache(jc, B, S, dtype=jnp.float32)
    jh, jcache = jm.decoder_forward(jp, jc, jnp.asarray(x[:, :P]), jnp.asarray(mask),
                                    jnp.asarray(pos), cache=jcache, cache_index=jnp.int32(0),
                                    cache_mask=jnp.zeros((B, S), bool))
    tcache = tm.init_kv_cache(tc, B, S, dtype=torch.float32)
    th, _ = tm.decoder_forward(tp, tc, torch.from_numpy(x[:, :P]), torch.from_numpy(mask),
                               torch.from_numpy(pos), cache=tcache, cache_index=0)
    # real positions: a left-padded one sees no key, which the two attend differently
    _assert_close(th.numpy()[mask], np.asarray(jh)[mask], TOL, TOL)
    cmask = np.zeros((B, S), bool)
    cmask[:, :P] = mask
    step_pos = pos[:, -1:] + 1
    jh1, _ = jm.decoder_forward(jp, jc, jnp.asarray(x[:, P:]), jnp.ones((B, 1), bool),
                                jnp.asarray(step_pos), cache=jcache, cache_index=jnp.int32(P),
                                cache_mask=jnp.asarray(cmask))
    th1, _ = tm.decoder_forward(tp, tc, torch.from_numpy(x[:, P:]), torch.ones((B, 1), dtype=torch.bool),
                                torch.from_numpy(step_pos), cache=tcache, cache_index=P,
                                cache_mask=torch.from_numpy(cmask))
    _assert_close(th1.numpy(), np.asarray(jh1), TOL, TOL)
    _assert_close(tm.compute_logits(tp, th1).numpy(),
                  np.asarray(jm.compute_logits(jp, jh1)), TOL, TOL)


def test_decode_step_matches_the_full_forward(decoders):
    """The dense form (no drops): the step after a cached prefill gives the
    full forward's last position (tests/test_moe_decoder.py)."""
    tc = dataclasses.replace(CFG, moe_impl="dense")
    _, tp = decoders
    B, P, S = 1, 6, 16
    x = torch.from_numpy((np.random.default_rng(11).standard_normal((B, P + 1, 64)) * 0.5)
                         .astype(np.float32))
    pos = torch.arange(P + 1)[None]
    full, _ = tm.decoder_forward(tp, tc, x, torch.ones((B, P + 1), dtype=torch.bool), pos)
    cache = tm.init_kv_cache(tc, B, S, dtype=torch.float32)
    tm.decoder_forward(tp, tc, x[:, :P], torch.ones((B, P), dtype=torch.bool), pos[:, :P],
                       cache=cache)
    cmask = torch.zeros((B, S), dtype=torch.bool)
    cmask[:, :P] = True
    step, _ = tm.decoder_forward(tp, tc, x[:, P:], torch.ones((B, 1), dtype=torch.bool),
                                 pos[:, P:], cache=cache, cache_index=P, cache_mask=cmask)
    torch.testing.assert_close(step[:, 0], full[:, -1], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["dense", "sparse"])
def test_greedy_generate_matches_jax(decoders, impl):
    jc, tc = _configs(moe_impl=impl)
    jp, tp = decoders
    rng = np.random.default_rng(12)
    rows = [rng.standard_normal((n, 64)).astype(np.float32)
            for n in (1, CFG.time_vocab_size, CFG.score_vocab_size)]
    jemb = jgen.build_combined_embedding(jp["embed"], *map(jnp.asarray, rows))
    temb = torch.from_numpy(np.array(jemb))
    prefix = rng.standard_normal((2, 12, 64)).astype(np.float32)
    mask = np.ones((2, 12), bool)
    mask[1, :4] = False
    kw = dict(max_new_tokens=20, initial_head=0, eos_id=-5)
    want = jgen.generate(jp, jc, jnp.asarray(prefix), jnp.asarray(mask), jemb, **kw)
    got = tgen.generate(tp, tc, torch.from_numpy(prefix), torch.from_numpy(mask), temb, **kw)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert len(set(got.tokens.ravel().tolist())) > 3


# ---------------------------------------------------------------------------
# left padding with overflowing buckets. The JAX side runs what it runs on a
# TPU: prefill through its Pallas flash kernel (``use_flash=True``, routed to
# ``flash_attention(..., interpret=True)`` as tests/test_torch_decoder.py
# does). A pad row sees no key; there it gets the mean of v over the keys
# once the prefix fills the kernel's 128-key tiles, as in the port. The pad
# rows take bucket slots before the real tokens of their row, so which real
# assignments overflow follows what they hold.
# ---------------------------------------------------------------------------

@pytest.fixture
def jax_flash_interpreted(monkeypatch):
    from trace_tpu.kernels import flash_attention as jfa

    monkeypatch.setattr(
        jfa, "flash_attention_trainable",
        lambda q, k, v, bias, causal=False: jfa.flash_attention(
            q, k, v, bias, causal=causal, interpret=True))


def _record_real_drops(monkeypatch, mask):
    """Per call of the port's sparse dispatch, the real tokens' assignments
    it drops (``mask`` [B, T]: the real tokens of a prefill)."""
    drops, dispatch = [], tmoe.dispatch

    def recorded(top_idx, num_experts, cap):
        out = dispatch(top_idx, num_experts, cap)
        keep = out[1].reshape(top_idx.shape)
        if keep.shape[0] == mask.size:
            drops.append(int((~keep)[torch.from_numpy(mask.reshape(-1))].sum()))
        return out

    monkeypatch.setattr(tmoe, "dispatch", recorded)
    return drops


def _left_padded(seed, B, P, pads, zero_pads=False):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, P + 1, 64)) * 0.5).astype(np.float32)
    mask = np.ones((B, P), bool)
    for b, n in enumerate(pads):
        mask[b, :n] = False
    if zero_pads:  # the pipeline's pad embeddings
        x[:, :P][~mask] = 0.0
    return x, mask


@pytest.mark.parametrize("zero_pads", [False, True])
def test_sparse_left_padded_overflow_matches_jax(decoders, jax_flash_interpreted, monkeypatch,
                                                 zero_pads):
    """Capacity factor 1 (C = N / 2 at E 4, k 2), a 128-token prefill with
    20 and 50 pad rows: real assignments overflow in every layer, and the
    hidden states of every row, pad rows included, the cache step after it
    and its logits match JAX's."""
    jc, tc = _configs(moe_impl="sparse", capacity_factor=1.0)
    jp, tp = decoders
    B, P, S = 2, 128, 136
    x, mask = _left_padded(13, B, P, (20, 50), zero_pads)
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0)
    drops = _record_real_drops(monkeypatch, mask)
    jh, jcache = jm.decoder_forward(jp, jc, jnp.asarray(x[:, :P]), jnp.asarray(mask),
                                    jnp.asarray(pos), cache=jm.init_kv_cache(jc, B, S, dtype=jnp.float32),
                                    cache_index=jnp.int32(0),
                                    cache_mask=jnp.zeros((B, S), bool), use_flash=True)
    tcache = tm.init_kv_cache(tc, B, S, dtype=torch.float32)
    th, _ = tm.decoder_forward(tp, tc, torch.from_numpy(x[:, :P]), torch.from_numpy(mask),
                               torch.from_numpy(pos), cache=tcache, cache_index=0)
    assert len(drops) == CFG.num_layers and min(drops) > 0, drops
    _assert_close(th.numpy(), np.asarray(jh), TOL, TOL)
    cmask = np.pad(mask, ((0, 0), (0, S - P)))
    step_pos = pos[:, -1:] + 1
    jh1, _ = jm.decoder_forward(jp, jc, jnp.asarray(x[:, P:]), jnp.ones((B, 1), bool),
                                jnp.asarray(step_pos), cache=jcache, cache_index=jnp.int32(P),
                                cache_mask=jnp.asarray(cmask))
    th1, _ = tm.decoder_forward(tp, tc, torch.from_numpy(x[:, P:]),
                                torch.ones((B, 1), dtype=torch.bool),
                                torch.from_numpy(step_pos), cache=tcache, cache_index=P,
                                cache_mask=torch.from_numpy(cmask))
    _assert_close(th1.numpy(), np.asarray(jh1), TOL, TOL)
    _assert_close(tm.compute_logits(tp, th1).numpy(),
                  np.asarray(jm.compute_logits(jp, jh1)), TOL, TOL)


def test_sparse_left_padded_overflow_generates_as_jax(decoders, jax_flash_interpreted,
                                                      monkeypatch):
    """Greedy ``generate`` at capacity factor 1 from a 128-token prefix with
    zero pad embeddings (as the pipeline pads): real assignments overflow in
    the prefill, and the streams are token-exact with JAX's."""
    jc, tc = _configs(moe_impl="sparse", capacity_factor=1.0)
    jp, tp = decoders
    rng = np.random.default_rng(14)
    rows = [rng.standard_normal((n, 64)).astype(np.float32)
            for n in (1, CFG.time_vocab_size, CFG.score_vocab_size)]
    jemb = jgen.build_combined_embedding(jp["embed"], *map(jnp.asarray, rows))
    x, mask = _left_padded(15, 2, 128, (30, 70), zero_pads=True)
    prefix = x[:, :128]
    drops = _record_real_drops(monkeypatch, mask)
    kw = dict(max_new_tokens=16, initial_head=0, eos_id=-5)
    want = jgen.generate(jp, jc, jnp.asarray(prefix), jnp.asarray(mask), jemb, use_flash=True,
                         **kw)
    got = tgen.generate(tp, tc, torch.from_numpy(prefix), torch.from_numpy(mask),
                        torch.from_numpy(np.array(jemb)), **kw)
    assert min(drops[:CFG.num_layers]) > 0, drops
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert len(set(got.tokens.ravel().tolist())) > 3


# ---------------------------------------------------------------------------
# training: gradients of every trainable leaf against jax.grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl,stage", [("dense", "sft"), ("sparse", "sft"),
                                        ("sparse", "lora"), ("dense", "pretrain")])
def test_train_gradients_match_jax(impl, stage):
    """The tiny TRACE on a ``tiny_moe`` decoder (the JAX package's
    ``init_moe_decoder_params`` layout) in each stage of the JAX train loop:
    the loss and the gradient of every trainable leaf, router and experts
    included (sft), the attention adapters (lora, as the JAX package adapts a
    Mixtral layer), or the connector, towers and heads through the frozen
    routed layers (pretrain)."""
    jdec, tdec = _configs(moe_impl=impl)
    if stage == "lora":
        jdec, tdec = (dataclasses.replace(c, lora_r=4, lora_alpha=8.0) for c in (jdec, tdec))
    jcfg = dataclasses.replace(JTraceConfig.tiny(), decoder=jdec)
    cfg = dataclasses.replace(TraceConfig.tiny(), decoder=tdec)
    jp = jtm.init_trace_params(jcfg, jax.random.PRNGKey(0))
    jp["decoder"] = jax.tree.map(jnp.asarray, _jax_moe_decoder(2))
    if stage == "lora":
        dec = jlora.add_lora_params(jp["decoder"], jdec, jax.random.PRNGKey(2),
                                    targets=("wq", "wk", "wv", "wo"))
        layers = dict(dec["layers"])
        rng = np.random.default_rng(5)
        for name in [n for n in layers if n.endswith("_lora_b")]:
            layers[name] = jnp.asarray(
                rng.standard_normal(layers[name].shape).astype(np.float32) * 0.05)
        jp["decoder"] = {**dec, "layers": layers}
    batch = train_batch()
    jloss, _, jgrads = _jax_loss_and_grads(jp, jcfg, batch)
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    tloss, _, tgrads = _torch_loss_and_grads(tp, cfg, batch, stage, remat=True)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5, atol=1e-5)
    checked = 0
    for path, want in _paths(jgrads).items():
        got = tgrads[path]
        if ttrain.param_group(path, stage) == "frozen":
            assert got is None, f"{path}: a frozen leaf took a gradient"
            continue
        np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * max(np.abs(want).max(), 1e-30),
                                   err_msg=path)
        checked += 1
    assert checked >= 8
    for name in ("router", "w_gate", "w_down"):
        g = tgrads[f"decoder/layers/{name}"]
        assert (g is None) == (stage != "sft")
        assert g is None or g.abs().max() > 0


# ---------------------------------------------------------------------------
# checkpoints: the converter, the config, model_init, the train CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hf_mixtral():
    from transformers import MixtralConfig, MixtralForCausalLM

    hf_cfg = MixtralConfig(
        vocab_size=390, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16, rms_norm_eps=1e-5,
        max_position_embeddings=256, num_local_experts=4, num_experts_per_tok=2,
        attention_dropout=0.0, tie_word_embeddings=False, output_router_logits=False,
        sliding_window=None, rope_theta=1e6)
    torch.manual_seed(0)
    return MixtralForCausalLM(hf_cfg).eval(), hf_cfg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_mixtral_decoder_matches_jax_and_hf(hf_mixtral, dtype):
    """The converted tree bit for bit against JAX's (a 390-row vocabulary cut
    to 384), and in fp32 the port's logits against HF's."""
    hf, hf_cfg = hf_mixtral
    sd = {k: v.detach() for k, v in hf.state_dict().items()}
    want_cfg = jconvert.trace_config_from_hf(hf_cfg.to_dict())
    got_cfg = tconvert.trace_config_from_hf(hf_cfg.to_dict())
    jdec = dataclasses.replace(want_cfg.decoder, vocab_size=384)
    tdec = dataclasses.replace(got_cfg.decoder, vocab_size=384)
    want = jconvert.convert_mixtral_decoder({k: v.numpy() for k, v in sd.items()}, jdec,
                                            dtype=getattr(jnp, dtype))
    got = tconvert.convert_mixtral_decoder(sd, tdec, dtype=getattr(torch, dtype))
    assert_trees_equal(got, want)
    assert got["layers"]["w_down"].shape == (2, 4, 96, 64)
    if dtype == "bfloat16":
        return
    ids = np.random.default_rng(0).integers(0, 384, size=(2, 9))
    with torch.no_grad():
        hf_logits = hf(torch.from_numpy(ids)).logits.numpy()[..., :384]
    h, _ = tm.decoder_forward(got, tdec, got["embed"][torch.from_numpy(ids)],
                              torch.ones((2, 9), dtype=torch.bool),
                              torch.arange(9).expand(2, 9))
    logits = tm.compute_logits(got, h)[..., :384].numpy()
    np.testing.assert_allclose(logits, hf_logits, rtol=HF_TOL, atol=HF_TOL)


@pytest.mark.parametrize("hf", [
    {"model_type": "mixtral"},
    {"num_local_experts": 4, "num_experts_per_tok": 1, "hidden_size": 256,
     "num_attention_heads": 8, "rope_theta": 1e6},
    {"model_type": "mixtral", "vocab_size": 32000, "hidden_size": 4096,
     "intermediate_size": 14336, "num_hidden_layers": 32, "num_attention_heads": 32,
     "num_key_value_heads": 8, "rope_theta": 1e6, "rms_norm_eps": 1e-5,
     "num_local_experts": 8, "num_experts_per_tok": 2},
])
def test_trace_config_from_hf_mixtral_matches_jax(hf):
    want = jconvert.trace_config_from_hf(hf).decoder
    got = tconvert.trace_config_from_hf(hf).decoder
    assert isinstance(got, MoEConfig) and got.moe_impl == "dense"
    for f in dataclasses.fields(got):
        if hasattr(want, f.name):
            assert getattr(got, f.name) == getattr(want, f.name), f.name


def write_mixtral_checkpoint(path, cfg, *, num_experts=4, top_k=2, seed=0, shards=2):
    """A merged TRACE checkpoint dir of the manifest's keys for ``cfg`` with
    each layer's MLP replaced by a ``block_sparse_moe`` (router ``gate``
    [E, D], experts' w1 / w3 [I, D] and w2 [D, I]), bf16 safetensors, and a
    mixtral ``config.json``."""
    d = cfg.decoder
    keys = {k: v for k, v in MANIFEST.full_manifest(cfg, "merged", bundled_vision=True).items()
            if ".mlp." not in k or "vision" in k}
    for i in range(d.num_layers):
        moe = f"model.layers.{i}.block_sparse_moe."
        keys[moe + "gate.weight"] = (num_experts, d.hidden_size)
        for j in range(num_experts):
            keys[f"{moe}experts.{j}.w1.weight"] = (d.intermediate_size, d.hidden_size)
            keys[f"{moe}experts.{j}.w3.weight"] = (d.intermediate_size, d.hidden_size)
            keys[f"{moe}experts.{j}.w2.weight"] = (d.hidden_size, d.intermediate_size)
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in keys.items():
        v = _value(key, shape, rng) * (10.0 if "block_sparse_moe.gate" in key else 1.0)
        sd[key] = torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
    path.mkdir(parents=True, exist_ok=True)
    names = list(sd)
    for s in range(shards):
        save_torch({k: sd[k].contiguous() for k in names[s::shards]},
                   str(path / f"model-{s + 1:05d}-of-{shards:05d}.safetensors"))
    (path / "config.json").write_text(json.dumps({
        **hf_config_of(cfg), "model_type": "mixtral", "num_local_experts": num_experts,
        "num_experts_per_tok": top_k}))
    return sd


ASK = "Localize a series of activity events in the video ."


@pytest.fixture(scope="module")
def mixtral_dir(tmp_path_factory):
    cfg = jax_config(decoder=dict(num_layers=2, intermediate_size=96))
    path = tmp_path_factory.mktemp("mixtral")
    write_mixtral_checkpoint(path, cfg, seed=21)
    write_hf_tokenizer(path, cfg.decoder.vocab_size)
    rng = np.random.default_rng(22)
    np.save(path / "video.npy", rng.integers(0, 256, (10, 64, 48, 3), dtype=np.uint8))
    return path


def test_model_init_mixtral_matches_jax(mixtral_dir, tiny_vision):
    """model_init on the same dir: the same tree (experts stacked [L, E, ...])
    and config (the dense form), and the same greedy events and tokens from
    ``infer_events``."""
    from trace_tpu.runtime.pipeline import model_init as jax_model_init
    from trace_tpu_torch.runtime.pipeline import model_init

    jpipe = jax_model_init(str(mixtral_dir), dtype=jnp.float32, quant="bf16")
    tpipe = model_init(str(mixtral_dir), dtype=torch.float32, quant="bf16", device="cpu")
    jpipe._prepare_memory_layout()
    assert_trees_equal(tpipe.params, jpipe.params)
    dec = tpipe.config.decoder
    assert isinstance(dec, MoEConfig) and (dec.num_experts, dec.top_k, dec.moe_impl) == \
        (4, 2, "dense")
    for f in dataclasses.fields(dec):
        if hasattr(jpipe.config.decoder, f.name):
            assert getattr(dec, f.name) == getattr(jpipe.config.decoder, f.name), f.name
    video = str(mixtral_dir / "video.npy")
    want = jpipe.infer_events(video, ASK, max_new_tokens=16)
    got = tpipe.infer_events(video, ASK, max_new_tokens=16)
    assert got.to_dict() == want.to_dict()
    frames, ts = jax_load_video(video, jpipe.config.num_frames)
    jprefix, jmask = jpipe._prepare_prefix_batch([frames], [ts], [ASK])
    jtok = jgen.generate(jpipe._decoder_params, jpipe.config.decoder, jprefix, jmask,
                         jpipe._combined, max_new_tokens=16, initial_head=1,
                         eos_id=jpipe.tokenizer.eos_token_id)
    np.testing.assert_array_equal(tpipe.last_stats["tokens"], jtok.tokens)
    assert tpipe.last_stats["decode_steps"] > 0


def test_base_route_converts_mixtral_where_jax_raises(mixtral_dir, tiny_vision):
    """``load_pretrained`` with a ``model_base`` (the base + projector route)
    converts a Mixtral dir through the same dispatch as a merged dir; the JAX
    package's route reads the dense MLP keys and raises ``KeyError`` (a
    pinned difference)."""
    from trace_tpu.checkpoint import loader as jloader
    from trace_tpu_torch.checkpoint import loader as tloader

    params, config = tloader.load_pretrained(str(mixtral_dir), model_base=str(mixtral_dir),
                                             model_name="trace-base", dtype=torch.float32)
    assert isinstance(config.decoder, MoEConfig)
    assert params["decoder"]["layers"]["w_up"].shape == (2, 4, 64, 96)
    with pytest.raises(KeyError, match="mlp"):
        jloader.load_pretrained(str(mixtral_dir), model_base=str(mixtral_dir),
                                model_name="trace-base", dtype=jnp.float32)


@pytest.mark.parametrize("quant", ["int8", "int4p", "int4"])
def test_quantized_mixtral_raises_where_jax_fails(mixtral_dir, quant):
    """No quantized Mixtral: the port raises ValueError, naming Mixtral,
    before any weight is read (model_init) or touched (the quantizers). The
    JAX package's host quantizer reduces the [L, E, D, I] stacks over the
    expert axis, and its decoder then fails with TypeError (pinned)."""
    from trace_tpu_torch.runtime.pipeline import model_init

    with pytest.raises(ValueError, match="Mixtral"):
        model_init(str(mixtral_dir), quant=quant, device="cpu")
    tdec = tmoe.init_moe_decoder_params(CFG, torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in tdec["layers"].items()}
    tree = {"decoder": tdec, "vision": {}}
    for fn in (lambda: quantize_decoder_params(tdec),
               lambda: quantize_decoder_params(tdec, bits=4, pack=True),
               lambda: quantize_decoder_params(tdec, bits=4),
               lambda: int4_serving(tree, TraceConfig.tiny()),
               lambda: quantize_trace_params(tree),
               lambda: int8_serving(tree, TraceConfig.tiny()),
               lambda: int4p_serving(tree, TraceConfig.tiny())):
        with pytest.raises(ValueError, match="Mixtral"):
            fn()
    for k, v in tdec["layers"].items():
        assert torch.equal(v, before[k]), k

    q = quantize_decoder_params_host(_jax_moe_decoder(3), 8 if quant == "int8" else 4, pack=quant == "int4p")
    assert q["layers"]["w_gate"]["s"].shape[1] == 1  # reduced over the expert axis
    jc = dataclasses.replace(JCFG, act_quant=True)
    with pytest.raises(TypeError):
        jm.decoder_forward(q, jc, jnp.ones((1, 4, 64)) * 0.1, jnp.ones((1, 4), bool),
                           jnp.arange(4)[None])


def test_train_cli_starts_from_a_mixtral_checkpoint(mixtral_dir, tmp_path, capsys,
                                                    monkeypatch):
    """``--init-checkpoint`` on the Mixtral dir: stage lora (adapters on the
    seven projections, as the JAX CLI adds them; the MLP ones stay idle on
    routed layers) trains two steps on the CPU."""
    from trace_tpu_torch.model.config import VisionConfig
    from trace_tpu_torch.train import cli

    orig = tconvert.trace_config_from_hf
    monkeypatch.setattr(tconvert, "trace_config_from_hf",
                        lambda hf, **kw: orig(hf, **{"vision": VisionConfig.tiny(), **kw}))
    records = [{"conversations": [{"from": "human", "value": "What is shown ?"},
                                  {"from": "gpt", "value": f"the video w{i}"}]}
               for i in range(4)]
    data = tmp_path / "anno.json"
    data.write_text(json.dumps(records))
    cli.main(["--stage", "lora", "--data-path", str(data), "--output-dir",
              str(tmp_path / "run"), "--num-frames", "4", "--max-len", "256",
              "--batch-size", "2", "--lora-r", "4", "--device", "cpu",
              "--init-checkpoint", str(mixtral_dir)])
    out = capsys.readouterr().out
    assert "final metrics" in out and "tiny random model" not in out
    assert "step 2:" in out
