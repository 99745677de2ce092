"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA
card. Every test here is marked ``cuda`` and skips without a card.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed: ``python -m pytest --noconftest tests/test_torch_cuda.py``
(the repo's conftest imports JAX).
"""

import numpy as np
import pytest
import torch

from trace_tpu_torch.kernels.decode_attention import decode_attention
from trace_tpu_torch.kernels.flash_attention import flash_attention, vit_attention_btd

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# Each CUDA kernel against its plain version (bf16), per kernel: |diff| <=
# atol + rtol |ref| element by element, and ||diff|| / ||ref|| <= REL_NORM.
# The two differ by bf16 rounding of the output and of the probabilities
# fed to P.V, and the online softmax's other summation order: about one
# bf16 step of the output, so rtol is two steps (2^-7). atol covers the
# step at each kernel's largest outputs: flash's early rows average few
# keys (|o| up to ~4, step 2^-6), a ViT or decode output averages many
# (|o| < 1 and < 0.5 here). The limits are those of chip_smoke.py.

RTOL = 2 ** -7
ATOL = {"flash": 3e-2, "vit": 8e-3, "decode": 2e-3}
REL_NORM = 1e-2


def _assert_matches(got, want, atol):
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, atol=atol, rtol=RTOL)
    assert ((got - want).norm() / want.norm()).item() <= REL_NORM


def _bf16(rng, shape, dev):
    return torch.from_numpy(_normal(rng, *shape)).to(dev, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,T,hd,pad", [(2, 8, 2, 300, 128, 37), (1, 4, 4, 128, 64, 0)])
def test_flash_kernel_matches_plain(cuda, B, H, Hkv, T, hd, pad):
    rng = np.random.default_rng(6)
    q, k, v = _bf16(rng, (B, H, T, hd), cuda), _bf16(rng, (B, Hkv, T, hd), cuda), \
        _bf16(rng, (B, Hkv, T, hd), cuda)
    bias = torch.zeros((B, T), device=cuda)
    bias[0, :pad] = -1e30
    n = flash_attention.launches
    got = flash_attention(q, k, v, bias, True)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    want = flash_attention(q, k, v, bias, True, impl="plain")
    assert torch.isfinite(got).all()
    # left-padded rows see no key; their (finite) values are unspecified
    _assert_matches(got[:, :, pad:], want[:, :, pad:], ATOL["flash"])


@pytest.mark.cuda
def test_vit_kernel_matches_plain_on_fused_slices(cuda):
    B, P, NH, HD, TQ = 3, 80, 4, 64, 77
    rng = np.random.default_rng(7)
    qkv = _bf16(rng, (B, P, 3 * NH * HD), cuda)
    q, k, v = qkv.split(NH * HD, dim=-1)  # strided column slices, read in place
    got = vit_attention_btd(q, k, v, TQ, NH)
    want = vit_attention_btd(q, k, v, TQ, NH, impl="plain")
    _assert_matches(got[:, :TQ], want[:, :TQ], ATOL["vit"])


@pytest.mark.cuda
def test_decode_kernel_matches_plain(cuda):
    L, B, NKV, G, S, HD = 3, 3, 2, 4, 333, 128
    rng = np.random.default_rng(8)
    q = _bf16(rng, (B, NKV * G, 1, HD), cuda)
    k, v = _bf16(rng, (L, B, NKV, S, HD), cuda), _bf16(rng, (L, B, NKV, S, HD), cuda)
    masked = torch.from_numpy(rng.random((B, S)) < 0.5).to(cuda)
    bias = torch.where(masked, -1e30, 0.0).float()
    got = decode_attention(q, k[1], v[1], bias)
    want = decode_attention(q, k[1], v[1], bias, impl="plain")
    _assert_matches(got, want, ATOL["decode"])


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_they_do_not_take(cuda):
    q = torch.zeros((1, 2, 64, 64), device=cuda)  # fp32: the kernels take bf16
    with pytest.raises(TypeError):
        flash_attention(q, q, q, None, True)
    with pytest.raises(ValueError):
        decode_attention(q[:, :, :1], q, q, torch.zeros((1, 64), device=cuda))
