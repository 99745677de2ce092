"""The port's Mistral decoder (bf16 branch, run here in fp32) against the JAX
package's on the tiny config, with the same weights and inputs.

Tolerance: 1e-5 absolute/relative on fp32 values (same math, other
summation orders and transcendental implementations).
"""

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


def test_chunked_prefill_raises(params):
    """A T > 1 chunk after earlier cache slots has no kernel: it raises
    rather than attending through a plain path."""
    _, tp = params
    x, mask, pos = _inputs(T=4)
    cache = tm.init_kv_cache(CFG, 2, 16, dtype=torch.float32)
    with pytest.raises(NotImplementedError):
        tm.decoder_forward(tp, CFG, torch.from_numpy(x), torch.from_numpy(mask),
                           torch.from_numpy(pos), cache=cache, cache_index=4)


def test_init_kv_cache_layout():
    k, v = tm.init_kv_cache(CFG, 3, 40)
    jk, _ = jm.init_kv_cache(JCFG, 3, 40)
    assert tuple(k.shape) == jk.shape and k.dtype == torch.bfloat16
    assert k[1].is_contiguous() and not k.any() and not v.any()
    with pytest.raises(NotImplementedError):
        import dataclasses
        tm.init_kv_cache(dataclasses.replace(CFG, kv_cache_dtype="int8"), 1, 8)
