"""The port's Mistral decoder (dense branch, run here in fp32, the int8
serving branch and the nibble-packed int4 branch) against the JAX package's
on the tiny config, with the same weights and inputs.

Tolerance: 1e-5 absolute/relative on fp32 values (same math, other
summation orders and transcendental implementations); the int8 tests state
theirs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trace_tpu.model import mistral as jm
from trace_tpu.model.config import DecoderConfig as JDecoderConfig
from trace_tpu_torch.model import mistral as tm
from trace_tpu_torch.model.config import DecoderConfig
from trace_tpu_torch.params import from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-5
JCFG = JDecoderConfig.tiny()
CFG = DecoderConfig.tiny()


@pytest.fixture(scope="module")
def params():
    jp = jm.init_decoder_params(JCFG, jax.random.PRNGKey(0))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


def _inputs(B=2, T=12, seed=0, pad=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, CFG.hidden_size)).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[1, :pad] = False  # row 1 left-padded
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    return x, mask, pos


def test_rms_norm_and_rope_match():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 7, 16)).astype(np.float32)
    w = rng.standard_normal((16,)).astype(np.float32)
    _close(tm.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           jm.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    pos = rng.integers(0, 3000, (2, 7)).astype(np.int32)
    cos, sin = tm.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0)
    jcos, jsin = jm.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    # positions up to 3000 radians: fp32 cos/sin of the same argument
    _close(cos, jcos, 2e-4)
    _close(sin, jsin, 2e-4)
    _close(tm.apply_rope(torch.from_numpy(x), cos, sin),
           jm.apply_rope(jnp.asarray(x), jcos, jsin), 2e-4)


def test_cacheless_forward_matches(params):
    """The port runs the cache-less forward through flash_attention (its
    plain version here), the JAX package on the CPU through its einsum
    path; the real rows agree (left-padded rows see no key and differ)."""
    jp, tp = params
    x, mask, pos = _inputs()
    jh, _ = jm.decoder_forward(jp, JCFG, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(pos))
    th, _ = tm.decoder_forward(tp, CFG, torch.from_numpy(x), torch.from_numpy(mask),
                               torch.from_numpy(pos))
    real = mask[:, :, None]
    _close(th * torch.from_numpy(real), np.asarray(jh) * real)


@pytest.mark.parametrize("left_pad", [False, True])
def test_prefill_then_decode_matches(params, left_pad):
    """Prefill into a static cache, then one T=1 step; hidden states and
    cache contents match. The port's prefill runs through
    ``flash_attention`` (its plain version here), which the JAX side cannot
    run on the CPU outside interpret mode; the JAX side takes its cache
    path, and the real rows agree. ``left_pad`` left-pads row 1 by 4."""
    jp, tp = params
    x, mask, pos = _inputs(T=16, seed=2, pad=4 if left_pad else 0)
    B, T, S = 2, 16, 24
    jcache = jm.init_kv_cache(JCFG, B, S, dtype=jnp.float32)
    jh, jcache = jm.decoder_forward(
        jp, JCFG, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(pos),
        cache=jcache, cache_index=jnp.int32(0),
        cache_mask=jnp.zeros((B, S), bool))
    tcache = tm.init_kv_cache(CFG, B, S, dtype=torch.float32)
    th, tcache = tm.decoder_forward(
        tp, CFG, torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(pos),
        cache=tcache, cache_index=0, cache_mask=torch.zeros((B, S), dtype=torch.bool))
    # padded rows are garbage that differs between the two attention paths;
    # every real query masks them out
    real = mask[:, :, None]
    _close(th * torch.from_numpy(real), np.asarray(jh) * real)
    slots = np.pad(mask, ((0, 0), (0, S - T)))[None, :, None, :, None]
    slots_t = torch.from_numpy(slots)
    for i in (0, 1):
        _close(tcache[i] * slots_t, np.asarray(jcache[i]) * slots)

    # one decode step at slot T
    rng = np.random.default_rng(3)
    x1 = rng.standard_normal((B, 1, CFG.hidden_size)).astype(np.float32)
    pos1 = mask.sum(1, keepdims=True).astype(np.int32)
    cmask = np.pad(mask, ((0, 0), (0, S - T)))
    jh1, jcache = jm.decoder_forward(
        jp, JCFG, jnp.asarray(x1), jnp.ones((B, 1), bool), jnp.asarray(pos1),
        cache=jcache, cache_index=jnp.int32(T), cache_mask=jnp.asarray(cmask))
    th1, tcache = tm.decoder_forward(
        tp, CFG, torch.from_numpy(x1), torch.ones((B, 1), dtype=torch.bool),
        torch.from_numpy(pos1), cache=tcache, cache_index=T,
        cache_mask=torch.from_numpy(cmask))
    _close(th1, jh1)
    slots[..., T, :] = True
    for i in (0, 1):
        _close(tcache[i] * torch.from_numpy(slots), np.asarray(jcache[i]) * slots)


def test_compute_logits_matches(params):
    jp, tp = params
    rng = np.random.default_rng(4)
    h = rng.standard_normal((3, CFG.hidden_size)).astype(np.float32)
    got = tm.compute_logits(tp, torch.from_numpy(h))
    assert got.shape == (3, CFG.combined_vocab_size) and got.dtype == torch.float32
    _close(got, jm.compute_logits(jp, jnp.asarray(h)))


def test_compute_logits_is_fp32_for_bf16_weights(params):
    _, tp = params
    bf = {k: v.to(torch.bfloat16) for k, v in tp.items() if k.endswith("_head")}
    h = torch.randn((2, CFG.hidden_size), generator=torch.Generator().manual_seed(0))
    got = tm.compute_logits(bf, h.to(torch.bfloat16))
    want = h.to(torch.bfloat16).double() @ torch.cat(
        [bf[n].double() for n in tm.HEAD_NAMES], dim=-1)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.double(), want, atol=1e-5, rtol=1e-5)


def test_init_kv_cache_layout():
    k, v = tm.init_kv_cache(CFG, 3, 40)
    jk, _ = jm.init_kv_cache(JCFG, 3, 40)
    assert tuple(k.shape) == jk.shape and k.dtype == torch.bfloat16
    assert k[1].is_contiguous() and not k.any() and not v.any()
    # the int8 layout: values int8, scales bf16 [L, B, NKV, 1, S] set to one
    qcfg = dataclasses.replace(CFG, kv_cache_dtype="int8")
    c = tm.init_kv_cache(qcfg, 3, 40)
    jc = jm.init_kv_cache(dataclasses.replace(JCFG, kv_cache_dtype="int8"), 3, 40)
    assert set(c) == set(jc) == {"kq", "ks", "vq", "vs"}
    for name in c:
        assert tuple(c[name].shape) == jc[name].shape, name
        assert str(c[name].dtype).split(".")[-1] == jc[name].dtype.name, name
        np.testing.assert_array_equal(c[name].float().numpy(),
                                      np.asarray(jc[name].astype(jnp.float32)))
    assert c["ks"][1].is_contiguous() and c["kq"][1].is_contiguous()
    with pytest.raises(ValueError):
        tm.init_kv_cache(dataclasses.replace(CFG, kv_cache_dtype="fp8"), 1, 8)


# ---------------------------------------------------------------------------
# int8 serving branch: int8 weights (fused or per weight), W8A8 prefill,
# weight-only T = 1 step, int8 KV cache.
#
# The JAX side runs what it runs on a TPU, in interpret mode: prefill through
# its Pallas flash kernel (``use_flash=True``; the test routes
# ``flash_attention_trainable`` to ``flash_attention(..., interpret=True)``,
# which the CPU backend needs), the T = 1 step through its Pallas decode
# kernel (``TRACE_TPU_DECODE_ATTN=force``, as tests/test_decode_attention.py
# does). head_dim is 128, which that kernel wants. Nothing in the JAX package
# changes.
#
# Tolerance. Both sides compute the same function with fp32 activations; they
# differ by fp32 summation order (~1e-6 relative), and where such a difference
# falls on a rounding boundary an int8 value (activation, K/V or probability)
# flips by one step. One flipped activation of a row moves that row's output
# by ~1/127 of one of K terms, ~1e-3 of the output's scale at K = 128; flips
# are rare. Hidden states and logits: 2e-3 of the largest value. Cache: int8
# values equal but for flips of one step in at most 0.1% of the entries;
# scales to one bf16 step (2^-7 relative).
# ---------------------------------------------------------------------------

INT8_TOL = 2e-3
QJCFG = dataclasses.replace(JCFG, num_heads=4, num_kv_heads=2, head_dim=128, hidden_size=128,
                            kv_cache_dtype="int8")
QCFG = dataclasses.replace(CFG, num_heads=4, num_kv_heads=2, head_dim=128, hidden_size=128,
                           kv_cache_dtype="int8")


@pytest.fixture
def jax_kernels_interpreted(monkeypatch):
    from trace_tpu.kernels import flash_attention as jfa

    monkeypatch.setenv("TRACE_TPU_DECODE_ATTN", "force")
    monkeypatch.delenv("TRACE_TPU_DECODE_ATTN_S8", raising=False)
    monkeypatch.delenv("TRACE_TPU_STACKED_QMM", raising=False)
    monkeypatch.setattr(
        jfa, "flash_attention_trainable",
        lambda q, k, v, bias, causal=False: jfa.flash_attention(
            q, k, v, bias, causal=causal, interpret=True))


def _int8_trees(fused: bool, seed: int):
    from trace_tpu.model import quantize as jq

    jp = jq.quantize_decoder_params(jm.init_decoder_params(QJCFG, jax.random.PRNGKey(seed)))
    if fused:
        jp = jq.fuse_decoder_serving(jp)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


def _close_scaled(got, want, tol=INT8_TOL):
    want = np.asarray(want, np.float32)
    unit = np.abs(want).max()
    np.testing.assert_allclose(got.detach().float().numpy() / unit, want / unit,
                               rtol=tol, atol=tol)


def _assert_int8_cache_close(tcache, jcache, slots):
    """slots: [B, S] bool, the slots written so far."""
    sel = slots[None, :, None, :]
    for vals, scales in (("kq", "ks"), ("vq", "vs")):
        tq = tcache[vals].numpy().astype(np.int32)
        jq_ = np.asarray(jcache[vals]).astype(np.int32)
        diff = np.abs(tq - jq_) * sel[..., None]
        assert diff.max() <= 1, vals
        assert (diff != 0).mean() <= 1e-3, (vals, (diff != 0).mean())
        ts = tcache[scales].float().numpy()
        js = np.asarray(jcache[scales].astype(jnp.float32))
        np.testing.assert_allclose(ts * sel[:, :, :, None], js * sel[:, :, :, None],
                                   rtol=2 ** -7, atol=0, err_msg=scales)


@pytest.mark.parametrize("fused,act_quant", [(True, True), (False, True), (False, False)])
def test_int8_prefill_then_decode_matches(jax_kernels_interpreted, fused, act_quant):
    """Prefill (W8A8 with ``act_quant``, else weight-only) into the int8
    cache, then one weight-only T = 1 step over it; hidden states, cache
    contents and the logits of the quantized ``lm_head`` against JAX."""
    jp, tp = _int8_trees(fused, seed=5)
    jcfg = dataclasses.replace(QJCFG, act_quant=act_quant)
    tcfg = dataclasses.replace(QCFG, act_quant=act_quant)
    B, T, S = 2, 16, 24
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((B, T, tcfg.hidden_size)) * 0.5).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[1, :4] = False
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)

    jh, jcache = jm.decoder_forward(
        jp, jcfg, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(pos),
        cache=jm.init_kv_cache(jcfg, B, S), cache_index=jnp.int32(0),
        cache_mask=jnp.zeros((B, S), bool), use_flash=True)
    th, tcache = tm.decoder_forward(
        tp, tcfg, torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(pos),
        cache=tm.init_kv_cache(tcfg, B, S), cache_index=0,
        cache_mask=torch.zeros((B, S), dtype=torch.bool))
    assert isinstance(tcache, dict) and tcache["kq"].dtype == torch.int8
    real = mask[:, :, None]
    _close_scaled(th * torch.from_numpy(real), np.asarray(jh) * real)
    slots = np.pad(mask, ((0, 0), (0, S - T)))
    _assert_int8_cache_close(tcache, jcache, slots)

    x1 = (rng.standard_normal((B, 1, tcfg.hidden_size)) * 0.5).astype(np.float32)
    pos1 = mask.sum(1, keepdims=True).astype(np.int32)
    jh1, jcache = jm.decoder_forward(
        jp, jcfg, jnp.asarray(x1), jnp.ones((B, 1), bool), jnp.asarray(pos1),
        cache=jcache, cache_index=jnp.int32(T), cache_mask=jnp.asarray(slots))
    th1, tcache = tm.decoder_forward(
        tp, tcfg, torch.from_numpy(x1), torch.ones((B, 1), dtype=torch.bool),
        torch.from_numpy(pos1), cache=tcache, cache_index=T,
        cache_mask=torch.from_numpy(slots))
    _close_scaled(th1, jh1)
    slots[:, T] = True
    _assert_int8_cache_close(tcache, jcache, slots)

    got = tm.compute_logits(tp, th1[:, -1])
    assert got.dtype == torch.float32 and got.shape == (B, tcfg.combined_vocab_size)
    _close_scaled(got, jm.compute_logits(jp, jh1[:, -1]))


# Nibble-packed int4 trees. The JAX side runs its packed products through the
# plain route its ``quant_apply`` takes on the CPU (unpack, scale, one product
# with an fp32 sum), the attention as above. Both sides compute one function:
# the tolerance is the int8 branch's (summation order, and where it falls on a
# rounding boundary an int8 activation or cache value one step apart).
P4_WIDE = dict(hidden_size=256, intermediate_size=256, num_heads=2, num_kv_heads=1)


@pytest.mark.parametrize("kind,fused", [("w4a8", True), ("w4a8", False),
                                        ("weight_only", False), ("grouped", True),
                                        ("grouped", False)])
def test_int4p_prefill_then_decode_matches(jax_kernels_interpreted, kind, fused):
    """Per-channel packed leaves with ``act_quant`` (W4A8 prefill, then the
    weight-only T = 1 step), without it (weight-only at every T), and
    group-128 leaves on a hidden-256 config (G = 2: weight-only at every T even
    under ``act_quant``); hidden states, the int8 cache and the logits of the
    int8 ``lm_head`` against JAX."""
    from trace_tpu.model import quantize as jq

    wide = P4_WIDE if kind == "grouped" else {}
    jcfg = dataclasses.replace(QJCFG, act_quant=kind != "weight_only", **wide)
    tcfg = dataclasses.replace(QCFG, act_quant=kind != "weight_only", **wide)
    jp = jq.quantize_decoder_params(jm.init_decoder_params(jcfg, jax.random.PRNGKey(14)),
                                    bits=4, pack=True, group=128 if kind == "grouped" else 0)
    assert {leaf["s"].shape[1] for leaf in jp["layers"].values() if "qp" in leaf} == {
        2 if kind == "grouped" else 1}
    if fused:
        jp = jq.fuse_decoder_serving(jp)
        assert "qp" in jp["layers"]["wqkv"]
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    B, T, S = 2, 16, 24
    rng = np.random.default_rng(15)
    x = (rng.standard_normal((B, T, tcfg.hidden_size)) * 0.5).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[1, :4] = False
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)

    jh, jcache = jm.decoder_forward(
        jp, jcfg, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(pos),
        cache=jm.init_kv_cache(jcfg, B, S), cache_index=jnp.int32(0),
        cache_mask=jnp.zeros((B, S), bool), use_flash=True)
    th, tcache = tm.decoder_forward(
        tp, tcfg, torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(pos),
        cache=tm.init_kv_cache(tcfg, B, S), cache_index=0,
        cache_mask=torch.zeros((B, S), dtype=torch.bool))
    real = mask[:, :, None]
    _close_scaled(th * torch.from_numpy(real), np.asarray(jh) * real)
    slots = np.pad(mask, ((0, 0), (0, S - T)))
    _assert_int8_cache_close(tcache, jcache, slots)

    x1 = (rng.standard_normal((B, 1, tcfg.hidden_size)) * 0.5).astype(np.float32)
    pos1 = mask.sum(1, keepdims=True).astype(np.int32)
    jh1, jcache = jm.decoder_forward(
        jp, jcfg, jnp.asarray(x1), jnp.ones((B, 1), bool), jnp.asarray(pos1),
        cache=jcache, cache_index=jnp.int32(T), cache_mask=jnp.asarray(slots))
    th1, tcache = tm.decoder_forward(
        tp, tcfg, torch.from_numpy(x1), torch.ones((B, 1), dtype=torch.bool),
        torch.from_numpy(pos1), cache=tcache, cache_index=T,
        cache_mask=torch.from_numpy(slots))
    _close_scaled(th1, jh1)
    slots[:, T] = True
    _assert_int8_cache_close(tcache, jcache, slots)
    _close_scaled(tm.compute_logits(tp, th1[:, -1]), jm.compute_logits(jp, jh1[:, -1]))


def test_int4p_routing_follows_the_q_leaf(monkeypatch):
    """Which product each chunk takes: W4A8 (``quant_apply_w8a8``) only for
    per-channel packed leaves under ``act_quant`` at T > 1; the stacked
    weight-only product otherwise. Seven products a layer on a per-weight
    tree."""
    from trace_tpu_torch.model import quantize as tq

    calls = []
    for name in ("quant_apply_w8a8", "quant_apply_stacked"):
        real = getattr(tm, name)
        monkeypatch.setattr(tm, name, lambda *a, _n=name, _f=real, **k: (calls.append(_n),
                                                                         _f(*a, **k))[1])
    for wide, group, want_prefill in (({}, 0, "quant_apply_w8a8"),
                                      (P4_WIDE, 128, "quant_apply_stacked")):
        cfg = dataclasses.replace(QCFG, act_quant=True, kv_cache_dtype="bf16", **wide)
        jp = jm.init_decoder_params(dataclasses.replace(QJCFG, **wide), jax.random.PRNGKey(16))
        tp = tq.quantize_decoder_params(from_jax_params(jax.tree.map(np.asarray, jp)),
                                        bits=4, pack=True, group=group)
        x = torch.zeros((1, 4, cfg.hidden_size))
        ones = torch.ones((1, 4), dtype=torch.bool)
        cache = tm.init_kv_cache(cfg, 1, 8, dtype=torch.float32)
        calls.clear()
        tm.decoder_forward(tp, cfg, x, ones, torch.arange(4)[None], cache=cache)
        assert calls == [want_prefill] * 7 * cfg.num_layers
        calls.clear()
        tm.decoder_forward(tp, cfg, x[:, :1], ones[:, :1], torch.tensor([[4]]), cache=cache,
                           cache_index=4, cache_mask=torch.zeros((1, 8), dtype=torch.bool))
        assert calls == ["quant_apply_stacked"] * 7 * cfg.num_layers


def test_int8_dequant_decode_body_matches(jax_kernels_interpreted, monkeypatch):
    """``decode_attn_int8="dequant"`` is the JAX package's
    TRACE_TPU_DECODE_ATTN_S8=0 body."""
    monkeypatch.setenv("TRACE_TPU_DECODE_ATTN_S8", "0")
    jp, tp = _int8_trees(True, seed=7)
    tcfg = dataclasses.replace(QCFG, decode_attn_int8="dequant")
    B, S = 2, 16
    rng = np.random.default_rng(8)
    k = rng.standard_normal((QCFG.num_layers * B, QCFG.num_kv_heads, S, QCFG.head_dim))
    jcache, tcache = {}, {}
    for vals, scales in (("kq", "ks"), ("vq", "vs")):
        xq, xs = jm._quantize_kv(jnp.asarray(k.astype(np.float32)))
        k = k[::-1] * 0.7
        shape = (QCFG.num_layers, B, QCFG.num_kv_heads)
        jcache[vals] = xq.reshape(shape + (S, QCFG.head_dim))
        jcache[scales] = xs.reshape(shape + (1, S))
        tcache[vals] = torch.from_numpy(np.array(jcache[vals]))
        tcache[scales] = torch.from_numpy(
            np.array(jcache[scales].astype(jnp.float32))).to(torch.bfloat16)
    x1 = (rng.standard_normal((B, 1, QCFG.hidden_size)) * 0.5).astype(np.float32)
    pos1 = np.full((B, 1), 9, np.int32)
    cmask = np.broadcast_to(np.arange(S)[None] < 9, (B, S)).copy()
    jh1, _ = jm.decoder_forward(
        jp, QJCFG, jnp.asarray(x1), jnp.ones((B, 1), bool), jnp.asarray(pos1),
        cache=jcache, cache_index=jnp.int32(9), cache_mask=jnp.asarray(cmask))
    th1, _ = tm.decoder_forward(
        tp, tcfg, torch.from_numpy(x1), torch.ones((B, 1), dtype=torch.bool),
        torch.from_numpy(pos1), cache=tcache, cache_index=9,
        cache_mask=torch.from_numpy(cmask))
    _close_scaled(th1, jh1)


def test_fused_int8_tree_matches_per_weight_tree():
    """Column n of a fused product is column n of the weight that owns it:
    the fused and the per-weight int8 trees give the same hidden states, in
    the W8A8 prefill exactly (integer sums, the same epilogue per column)."""
    from trace_tpu_torch.model.quantize import fuse_decoder_serving

    _, tp = _int8_trees(False, seed=9)
    fused = fuse_decoder_serving(tp)
    assert "wqkv" in fused["layers"] and "wq" not in fused["layers"]
    cfg = dataclasses.replace(QCFG, act_quant=True)
    x, mask, pos = (torch.from_numpy(a) for a in _inputs(T=8, seed=10, pad=0))
    x = torch.nn.functional.pad(x, (0, QCFG.hidden_size - x.shape[-1]))
    want, _ = tm.decoder_forward(tp, cfg, x, mask, pos)
    got, _ = tm.decoder_forward(fused, cfg, x, mask, pos)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_quantize_kv_matches_jax():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 2, 5, 128)).astype(np.float32)
    x[0, 1, 3] = 0.0  # an all-zero slot takes the 1e-8 floor
    jq_, js = jm._quantize_kv(jnp.asarray(x))
    tq_, ts = tm._quantize_kv(torch.from_numpy(x))
    assert tq_.dtype == torch.int8 and ts.dtype == torch.bfloat16
    assert tuple(ts.shape) == (2, 2, 1, 5)
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(ts.view(torch.int16).numpy(),
                                  np.asarray(js).view(np.int16))


def test_bf16_mlp_keeps_gate_and_up_in_fp32():
    """bf16 weights: gate and up enter silu as the fp32 sums (JAX's
    preferred_element_type=float32), not rounded to bf16 first. The
    attention output is zeroed (wo = 0) so that both sides feed the MLP the
    same bf16 input; gate/up weights are scaled so the products are O(1).
    Then the outputs agree bit for bit but for a rare flip where the two
    fp32 sums straddle a rounding boundary (limit: 2% of the entries; none
    on this seed), while rounding gate and up to bf16 first changes 44-50%
    of them."""
    jcfg = dataclasses.replace(JCFG, num_layers=1)
    cfg = dataclasses.replace(CFG, num_layers=1)
    jp = jm.init_decoder_params(jcfg, jax.random.PRNGKey(12))
    layers = dict(jp["layers"])
    layers["w_gate"], layers["w_up"] = layers["w_gate"] * 20, layers["w_up"] * 20
    layers["wo"] = layers["wo"] * 0
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), {**jp, "layers": layers})
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    assert tp["layers"]["w_gate"].dtype == torch.bfloat16
    x, mask, pos = _inputs(seed=13, pad=0)
    jh, _ = jm.decoder_forward(jp, jcfg, jnp.asarray(x).astype(jnp.bfloat16),
                               jnp.asarray(mask), jnp.asarray(pos))
    th, _ = tm.decoder_forward(tp, cfg, torch.from_numpy(x).to(torch.bfloat16),
                               torch.from_numpy(mask), torch.from_numpy(pos))
    assert th.dtype == torch.bfloat16
    got, want = th.float().numpy(), np.asarray(jh.astype(jnp.float32))
    assert (got != want).mean() <= 0.02
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)


# Chunked prefill: a prompt written into the cache in chunks (T > 1 at
# cache_index > 0), each attending the slots valid before it and its own
# real slots up to each query, as the JAX package's einsum path computes it
# (its CPU default; its accelerator flash path drops the earlier slots, which
# the port does not copy). The dense cache runs on the tiny fp32 config
# (TOL); the int8 cache on the int8 branch's head_dim-128 config with dense
# weights, its T = 1 steps through the JAX package's decode kernel in
# interpret mode, as above (INT8_TOL). Then greedy decode steps from the last
# chunk's logits: the tokens equal.


def _chunked_run(forward, embed, logits, x, mask, pos, chunks, S, steps, cache, torch_side):
    """Prefill ``x`` in ``chunks`` then ``steps`` greedy steps through one
    package's ``forward``; returns (real-row hidden of each chunk, the cache,
    the greedy tokens, the first step's logits)."""
    B = x.shape[0]
    asarr = (lambda a: torch.from_numpy(np.ascontiguousarray(a))) if torch_side else jnp.asarray
    hidden, start = [], 0
    for n in chunks:
        sl = slice(start, start + n)
        cmask = np.zeros((B, S), bool)
        cmask[:, :start] = mask[:, :start]
        h, cache = forward(asarr(x[:, sl]), asarr(mask[:, sl]), asarr(pos[:, sl]), cache,
                           start, asarr(cmask))
        hidden.append(np.asarray(h.detach() if torch_side else h) * mask[:, sl, None])
        start += n
    T = start
    valid = np.zeros((B, S), bool)
    valid[:, :T] = mask
    tokens, first = [], None
    last = h[:, -1]
    p = mask.sum(1, keepdims=True).astype(np.int32)
    for i in range(steps):
        lg = np.asarray(logits(last).detach() if torch_side else logits(last))
        first = lg if first is None else first
        tok = lg[:, :CFG.vocab_size].argmax(-1)
        tokens.append(tok)
        h, cache = forward(asarr(embed(tok)[:, None]), asarr(np.ones((B, 1), bool)), asarr(p + i),
                           cache, T + i, asarr(valid))
        valid[:, T + i] = True
        last = h[:, -1]
    return hidden, cache, np.stack(tokens, 1), first


@pytest.mark.parametrize("chunks", [(4, 8), (4, 4, 4)])
@pytest.mark.parametrize("left_pad", [False, True])
@pytest.mark.parametrize("kv", ["dense", "int8"])
def test_chunked_prefill_matches_jax(jax_kernels_interpreted, kv, left_pad, chunks):
    """A 12-token prompt in two or three chunks (row 1 left-padded by 5, so
    that its first chunk holds no real token), then 4 greedy steps: each
    chunk's hidden states on the real rows, the cache's real slots, the
    first step's logits and the greedy tokens against JAX's einsum path."""
    if kv == "dense":
        jcfg, tcfg, tol = JCFG, CFG, TOL
    else:
        jcfg = dataclasses.replace(QJCFG, vocab_size=JCFG.vocab_size)
        tcfg, tol = dataclasses.replace(QCFG, vocab_size=CFG.vocab_size), INT8_TOL
    jp = jm.init_decoder_params(jcfg, jax.random.PRNGKey(7))
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    B, T, S, steps = 2, sum(chunks), 24, 4
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((B, T, tcfg.hidden_size)) * 0.5).astype(np.float32)
    mask = np.ones((B, T), bool)
    if left_pad:
        mask[1, :5] = False
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)

    def jforward(x, m, p, cache, index, cmask):
        # the first chunk of an int8 cache through JAX's flash route, which
        # attends the chunk's unquantized k / v as the port's prefill does
        # (its einsum route would read them back quantized)
        return jm.decoder_forward(jp, jcfg, x, m, p, cache=cache,
                                  cache_index=jnp.int32(index), cache_mask=cmask,
                                  use_flash=kv == "int8" and index == 0)

    def tforward(x, m, p, cache, index, cmask):
        return tm.decoder_forward(tp, tcfg, x, m, p, cache=cache, cache_index=index,
                                  cache_mask=cmask)

    jcache = jm.init_kv_cache(jcfg, B, S, dtype=jnp.float32)
    tcache = tm.init_kv_cache(tcfg, B, S, dtype=torch.float32)
    jh, jcache, jtok, jlog = _chunked_run(
        jforward, lambda t: np.asarray(jp["embed"])[t], lambda h: jm.compute_logits(jp, h),
        x, mask, pos, chunks, S, steps, jcache, False)
    th, tcache, ttok, tlog = _chunked_run(
        tforward, lambda t: tp["embed"][torch.from_numpy(t)].numpy(),
        lambda h: tm.compute_logits(tp, h), x, mask, pos, chunks, S, steps, tcache, True)
    for got, want in zip(th, jh):
        _close_scaled(torch.from_numpy(got), want, tol) if kv == "int8" else \
            _close(torch.from_numpy(got), want, tol)
    slots = np.zeros((B, S), bool)
    slots[:, :T] = mask
    slots[:, T:T + steps] = True
    if kv == "int8":
        _assert_int8_cache_close(tcache, jcache, slots)
        _close_scaled(torch.from_numpy(tlog), jlog, tol)
    else:
        sel = slots[None, :, None, :, None]
        for i in (0, 1):
            _close(tcache[i] * torch.from_numpy(sel), np.asarray(jcache[i]) * sel)
        _close(torch.from_numpy(tlog), jlog, tol)
    np.testing.assert_array_equal(ttok, jtok)


def test_chunked_prefill_equals_one_shot_prefill(params):
    """The port alone: a prompt prefilled in chunks gives the one-shot
    prefill's hidden states on the real rows and the same cache slots."""
    _, tp = params
    x, mask, pos = _inputs(T=12, seed=9, pad=5)
    B, S = 2, 16
    one, c1 = tm.decoder_forward(tp, CFG, torch.from_numpy(x), torch.from_numpy(mask),
                                 torch.from_numpy(pos),
                                 cache=tm.init_kv_cache(CFG, B, S, dtype=torch.float32))
    cache, parts = tm.init_kv_cache(CFG, B, S, dtype=torch.float32), []
    for lo, hi in ((0, 5), (5, 12)):
        cmask = torch.zeros((B, S), dtype=torch.bool)
        cmask[:, :lo] = torch.from_numpy(mask[:, :lo])
        h, cache = tm.decoder_forward(
            tp, CFG, torch.from_numpy(x[:, lo:hi]), torch.from_numpy(mask[:, lo:hi]),
            torch.from_numpy(pos[:, lo:hi]), cache=cache, cache_index=lo, cache_mask=cmask)
        parts.append(h)
    real = torch.from_numpy(mask[:, :, None])
    _close(torch.cat(parts, 1) * real, (one * real).numpy())
    sel = torch.from_numpy(np.pad(mask, ((0, 0), (0, S - 12)))[None, :, None, :, None])
    for i in (0, 1):
        _close(cache[i] * sel, (c1[i] * sel).numpy())


@pytest.mark.parametrize("cache_index", [6, 10])
@pytest.mark.parametrize("kv", ["dense", "int8"])
def test_chunk_parts_merged_by_lse_match_jax(kv, cache_index):
    """The card's route for a chunk whose cache mask marks slots at or past
    ``cache_index`` (``_attend_chunk_parts``: the slots of ``old`` without a
    causal mask, the chunk's other real slots causally at the query offset,
    merged by ``merge_attention``), fed here the two partial attentions and
    their logsumexps from the plain expressions, against the JAX package's
    chunk expression (``_attention`` under the visibility its
    ``decoder_forward`` builds). Row 0 marks slots before, inside and past
    the chunk; row 1 marks none and is left-padded, so that its first
    queries see no key in either part (the mean of v), and its others none
    in the first."""
    B, NH, NKV, T, S, hd = 2, 4, 2, 5, 24, 16
    rng = np.random.default_rng(31)
    normal = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    q = normal(B, NH, T, hd)
    k, v = normal(B, NKV, S, hd), normal(B, NKV, S, hd)
    if kv == "int8":  # the stripe as the port's chunk reads it: each value times its scale
        k, v = (xq.float() * xs.transpose(-1, -2).float()
                for xq, xs in (tm._quantize_kv(x.to(torch.bfloat16)) for x in (k, v)))
    old = np.zeros((B, S), bool)
    old[0, [1, 2, 4, cache_index + 1, cache_index + 3, S - 2]] = True
    real = np.ones((B, T), bool)
    real[1, :2] = False
    new = np.zeros((B, S), bool)
    new[:, cache_index:cache_index + T] = real
    got = tm._attend_chunk_parts(q, k, v, torch.from_numpy(old), torch.from_numpy(new),
                                 cache_index, "auto")
    slot = np.arange(S)[None, None, None, :]
    qoff = np.arange(T)[None, None, :, None]
    in_chunk = (slot >= cache_index) & (slot <= cache_index + qoff)
    vis = old[:, None, None, :] | (in_chunk & new[:, None, None, :])
    bias = np.where(vis, 0.0, jm.NEG_INF).astype(np.float32)
    want = jm._attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)), jnp.asarray(bias))
    _close(got, want)
    np.testing.assert_allclose(got[1, :, :2].numpy(), np.broadcast_to(
        v[1].mean(1).repeat_interleave(NH // NKV, 0)[:, None], (NH, 2, hd)), rtol=TOL, atol=TOL)
