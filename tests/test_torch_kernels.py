"""Plain versions of the port's attention kernels against the JAX package's
Pallas kernels, run in interpret mode on the CPU (the CUDA kernels against
their plain versions are in test_torch_cuda.py).

Tolerance: fp32, 2e-5 (the same scores summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trace_tpu.kernels.decode_attention import decode_attention as jax_decode
from trace_tpu.kernels.flash_attention import flash_attention as jax_flash
from trace_tpu.kernels.flash_attention import vit_attention_btd as jax_btd
from trace_tpu_torch.kernels.decode_attention import decode_attention, grouped_attention
from trace_tpu_torch.kernels.flash_attention import (
    flash_attention,
    vit_attention_btd,
    vit_attention_btd_reference,
    xla_attention,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 2e-5


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize(
    "B,H,Hkv,T,hd,causal",
    [
        (1, 2, 2, 128, 64, False),   # ViT-like (MHA, bidirectional)
        (2, 4, 2, 256, 128, True),   # LM-like (GQA, causal)
        (1, 2, 1, 200, 64, True),    # Tq/Tk not a multiple of the block
    ],
)
def test_flash_plain_matches_pallas(B, H, Hkv, T, hd, causal):
    rng = np.random.default_rng(0)
    q, k, v = _normal(rng, B, H, T, hd), _normal(rng, B, Hkv, T, hd), _normal(rng, B, Hkv, T, hd)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, interpret=True))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), None, causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_flash_padding_bias_matches_pallas():
    B, H, Hkv, T, hd = 2, 4, 2, 128, 64
    rng = np.random.default_rng(1)
    q, k, v = _normal(rng, B, H, T, hd), _normal(rng, B, Hkv, T, hd), _normal(rng, B, Hkv, T, hd)
    bias = np.zeros((B, T), np.float32)
    bias[0, :10] = -1e30   # left padding: rows 0..9 see no visible key
    bias[1, -20:] = -1e30  # right padding
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(bias), causal=True, interpret=True))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), torch.from_numpy(bias), True)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_flash_fully_masked_rows_are_finite():
    rng = np.random.default_rng(2)
    q, k, v = (_normal(rng, 1, 1, 128, 64) for _ in range(3))
    bias = np.full((1, 128), -1e30, np.float32)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), torch.from_numpy(bias), False)
    assert torch.isfinite(got).all()
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(bias), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_vit_btd_plain_matches_pallas():
    B, P, NH, HD, TQ = 2, 32, 2, 64, 29
    rng = np.random.default_rng(3)
    q, k, v = (_normal(rng, B, P, NH * HD) for _ in range(3))
    want = np.asarray(jax_btd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              tq=TQ, num_heads=NH, interpret=True))
    got = vit_attention_btd(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), TQ, NH)
    # pad rows (>= tq) are unspecified in both; compare the real rows
    np.testing.assert_allclose(got.numpy()[:, :TQ], want[:, :TQ], rtol=TOL, atol=TOL)


def test_decode_plain_matches_pallas_bf16_body():
    L, B, NKV, G, S, HD, li = 3, 2, 2, 4, 64, 128, 1
    rng = np.random.default_rng(4)
    q = _normal(rng, B, NKV * G, 1, HD)
    k, v = _normal(rng, L, B, NKV, S, HD), _normal(rng, L, B, NKV, S, HD)
    valid = np.arange(S)[None, :] < np.array([[37], [64]])
    bias = np.where(valid, 0.0, -1e30).astype(np.float32)
    want = np.asarray(jax_decode(jnp.asarray(q), (jnp.asarray(k), jnp.asarray(v)),
                                 jnp.int32(li), jnp.asarray(bias), interpret=True))
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    assert kt[li].is_contiguous()  # the layer's stripe is a view, read in place
    got = decode_attention(torch.from_numpy(q), kt[li], vt[li], torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_cpu_wrappers_run_plain_and_count_no_launch():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(_normal(rng, 1, 2, 16, 64))
    before = (flash_attention.launches, vit_attention_btd.launches,
              decode_attention.launches)
    torch.testing.assert_close(flash_attention(q, q, q, None, True),
                               xla_attention(q, q, q, None, causal=True))
    x = q.reshape(1, 16, 128)
    torch.testing.assert_close(vit_attention_btd(x, x, x, 12, 2),
                               vit_attention_btd_reference(x, x, x, tq=12, num_heads=2))
    bias = torch.zeros((1, 16))
    torch.testing.assert_close(
        decode_attention(q[:, :, :1], q, q, bias),
        grouped_attention(q[:, :, :1], q, q, bias[:, None, None, :]))
    assert (flash_attention.launches, vit_attention_btd.launches,
            decode_attention.launches) == before


def test_unknown_impl_is_refused():
    q = torch.zeros((1, 2, 4, 64))
    with pytest.raises(ValueError):
        flash_attention(q, q, q, None, True, impl="kernel")
    with pytest.raises(ValueError):
        decode_attention(q[:, :, :1], q, q, torch.zeros((1, 4)), impl="fast")
