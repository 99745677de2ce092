"""The port's attention forward-with-residuals and backward (their plain
versions, which the wrappers take for CPU tensors) against the JAX package's
Pallas kernels in interpret mode, on the same inputs from a numpy seed.

Tolerances as tests/test_flash_backward.py holds the Pallas kernels to their
XLA reference in fp32: o and lse 2e-5, gradients rtol/atol 2e-4 (other
summation orders, exp implementations). Query rows that see no key (left
padding under the causal mask) are padding: their ``do`` is zero, and only
then do the two backwards agree on them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trace_tpu.kernels import flash_backward as jfb
from trace_tpu.kernels.flash_attention import flash_attention_trainable as j_trainable
from trace_tpu.kernels.flash_attention import xla_attention as j_xla_attention
from trace_tpu_torch.kernels import flash_backward as tfb
from trace_tpu_torch.kernels.flash_attention import flash_attention_trainable

B, H, NKV, HD = 2, 4, 2, 32   # GQA, G = 2
TQ = TK = 160


def _inputs(side, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)
    q, k, v, do = f(B, H, TQ, HD), f(B, NKV, TK, HD), f(B, NKV, TK, HD), f(B, H, TQ, HD) * 2
    pads = np.array([[3], [60]])
    pos = np.arange(TK)[None, :]
    valid = pos >= pads if side == "left" else pos < TK - pads
    bias = np.where(valid, 0.0, -1e30).astype(np.float32)
    do = do * valid[:, None, :, None]  # the loss ignores padded query rows
    return q, k, v, bias, do, valid


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_fwd_res_and_bwd_match_pallas_interpret(causal, side):
    q, k, v, bias, do, valid = _inputs(side)
    jo, jlse = jfb.flash_attention_fwd_res(q, k, v, bias, causal=causal, interpret=True)
    to, tlse = tfb.flash_attention_fwd_res(*_t(q, k, v, bias), causal=causal)
    assert tlse.shape == (B, H, TQ, 1) and tlse.dtype == torch.float32
    sees = np.ones_like(valid) if not (causal and side == "left") else valid
    rows = sees[:, None, :, None]
    np.testing.assert_allclose(to.numpy() * rows, np.asarray(jo) * rows, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.where(rows, tlse.numpy(), 0), np.where(rows, jlse, 0),
                               rtol=2e-5, atol=2e-5)
    # rows that see no key: lse is the mask value on both sides
    np.testing.assert_array_equal(tlse.numpy()[~rows.repeat(H, 1)],
                                  np.asarray(jlse)[~rows.repeat(H, 1)])

    jgrads = jfb.flash_attention_bwd(q, k, v, bias, jo, jlse, do, causal=causal,
                                     interpret=True)
    tgrads = tfb.flash_attention_bwd(*_t(q, k, v, bias), to, tlse, *_t(do), causal=causal)
    for got, want, name in zip(tgrads, jgrads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


def test_split_backward_entries_agree_with_the_joint_one():
    q, k, v, bias, do, _ = _inputs("right", seed=3)
    tq, tk, tv, tb, tdo = _t(q, k, v, bias, do)
    o, lse = tfb.flash_attention_fwd_res(tq, tk, tv, tb, causal=True)
    delta = tfb.flash_attention_bwd_delta(o, tdo)
    assert delta.shape == lse.shape
    dq = tfb.flash_attention_bwd_dq(tq, tk, tv, tb, tdo, lse, delta, causal=True)
    dk, dv = tfb.flash_attention_bwd_dkv(tq, tk, tv, tb, tdo, lse, delta, causal=True)
    for a, b in zip((dq, dk, dv), tfb.flash_attention_bwd(tq, tk, tv, tb, o, lse, tdo,
                                                          causal=True)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tfb.flash_attention_bwd_dq(tq, tk, tv, tb, tdo, lse, delta, causal=True, impl="fast")


@pytest.mark.parametrize("side", ["left", "right"])
def test_trainable_matches_jax_grad(side, monkeypatch):
    """flash_attention_trainable under autograd against jax.grad through the
    JAX package's custom_vjp (its Pallas kernels in interpret mode) and
    through its XLA attention."""
    q, k, v, bias, do, _ = _inputs(side, seed=1)
    monkeypatch.setattr(jfb, "flash_attention_fwd_res",
                        functools.partial(jfb.flash_attention_fwd_res, interpret=True))
    monkeypatch.setattr(jfb, "flash_attention_bwd",
                        functools.partial(jfb.flash_attention_bwd, interpret=True))
    jgrads = jax.grad(lambda a, b, c: jnp.sum(j_trainable(a, b, c, bias, True) * do),
                      argnums=(0, 1, 2))(q, k, v)
    xgrads = jax.grad(lambda a, b, c: jnp.sum(j_xla_attention(a, b, c, bias, causal=True) * do),
                      argnums=(0, 1, 2))(q, k, v)

    leaves = [t.requires_grad_(True) for t in _t(q, k, v)]
    tb, tdo = _t(bias, do)
    tb.requires_grad_(True)  # the bias takes no gradient
    (flash_attention_trainable(*leaves, tb, True) * tdo).sum().backward()
    assert tb.grad is None
    for leaf, jg, xg, name in zip(leaves, jgrads, xgrads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg), rtol=2e-4, atol=2e-4,
                                   err_msg=name)
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(xg), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


def test_trainable_under_checkpoint_and_no_grad():
    from torch.utils.checkpoint import checkpoint

    q, k, v, bias, do, _ = _inputs("right", seed=2)
    tb, tdo = _t(bias, do)
    plain = [t.requires_grad_(True) for t in _t(q, k, v)]
    (flash_attention_trainable(*plain, tb, True) * tdo).sum().backward()
    ckpt = [t.requires_grad_(True) for t in _t(q, k, v)]
    out = checkpoint(lambda a, b, c: flash_attention_trainable(a, b, c, tb, True), *ckpt,
                     use_reentrant=False)
    (out * tdo).sum().backward()
    for a, b in zip(plain, ckpt):
        assert torch.equal(a.grad, b.grad)
    with torch.no_grad():
        o = flash_attention_trainable(*plain, tb, True)
    assert o.grad_fn is None and not o.requires_grad
