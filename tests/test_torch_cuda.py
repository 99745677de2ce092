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
from trace_tpu_torch.kernels.quant_matmul import (
    int8_matmul,
    quant_apply_w8a8,
    quant_matmul,
    quant_matmul_p4,
    quant_matmul_p4_grouped,
    quant_matmul_p4_grouped_stacked,
    quant_matmul_p4_stacked,
    quant_matmul_stacked,
    quantize_acts,
)

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


# The int8 weight product sums the same exact products (bf16 x int8) in fp32
# in another order than its plain version: the sums differ by ~sqrt(K) eps of
# their size. Outputs are compared in units of the largest one: 1e-5 absolute,
# and for a bf16 output two bf16 steps relative (a rounding that flips).
def _assert_qmm_matches(got, want, out_dtype):
    unit = want.float().abs().max()
    rtol = 2 ** -7 if out_dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float() / unit, want.float() / unit, atol=1e-5, rtol=rtol)


def _int8_weight(rng, shape, dev):
    q = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)).to(dev)
    s = torch.from_numpy((rng.random(shape[:-2] + shape[-1:]) * 4e-3 + 1e-3)
                         .astype(np.float32)).to(dev, torch.bfloat16)
    return q, s


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,out_dtype", [
    (1, 64, 16, torch.bfloat16),        # smaller than one strip and one chunk
    (2, 4096, 32000, torch.float32),    # the lm_head of a decode step
    (3, 1000, 1100, torch.bfloat16),    # ragged K and N: the byte-wise loads
    (37, 520, 1040, torch.float32),     # M over several row tiles
    (300, 256, 512, torch.bfloat16),    # weight-only prefill, many row tiles
])
def test_quant_matmul_kernel_matches_plain(cuda, M, K, N, out_dtype):
    rng = np.random.default_rng(9)
    x = _bf16(rng, (M, K), cuda)
    q, s = _int8_weight(rng, (K, N), cuda)
    n = quant_matmul.launches
    got = quant_matmul(x, q, s, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert quant_matmul.launches == n + 1 and got.dtype == out_dtype
    _assert_qmm_matches(got, quant_matmul(x, q, s, out_dtype=out_dtype, impl="plain"),
                        out_dtype)
    # no atomics: the same bits from run to run
    assert torch.equal(got, quant_matmul(x, q, s, out_dtype=out_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,out_dtype", [
    (4096, 6144, torch.bfloat16), (4096, 28672, torch.float32),
    (14336, 4096, torch.bfloat16), (200, 136, torch.float32)])
@pytest.mark.parametrize("li", [0, 2])
def test_quant_matmul_stacked_kernel_matches_plain(cuda, K, N, out_dtype, li):
    rng = np.random.default_rng(10)
    x = _bf16(rng, (2, K), cuda)
    q, s = _int8_weight(rng, (3, K, N), cuda)
    n = quant_matmul_stacked.launches
    got = quant_matmul_stacked(x, q, s, li, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert quant_matmul_stacked.launches == n + 1
    _assert_qmm_matches(got, quant_matmul_stacked(x, q, s, li, out_dtype=out_dtype,
                                                  impl="plain"), out_dtype)
    # the layer is read in place: the same bits as the 2-D entry on its slice
    assert torch.equal(got, quant_matmul(x, q[li], s[li], out_dtype=out_dtype))


# The packed-int4 products sum exact products in fp32 (bf16 x a nibble, or
# bf16 x the scaled weight rounded to bf16, which both versions round alike).
# Split-K form (M <= 8): fp32 multiply-adds in another order than the plain
# version: the int8 product's limits. Tensor-core form: mma.sync adds each 16
# products into the fp32 accumulator with truncation, not rounding to nearest,
# so over K / 16 steps the sum drifts by up to ~K / 16 x 2^-24 of the largest
# partial sum: 1e-4 of the largest output at K <= 14336 (a dropped k step or a
# misplaced nibble moves outputs by 1e-2 and more).
def _assert_p4_matches(got, want, out_dtype, form):
    unit = want.float().abs().max()
    atol = 1e-5 if form == "splitk" else 1e-4
    rtol = 2 ** -7 if out_dtype == torch.bfloat16 else atol
    torch.testing.assert_close(got.float() / unit, want.float() / unit, atol=atol, rtol=rtol)


def _packed_weight(rng, shape, groups, dev):
    """qp [.., K/2, N] random bytes (every nibble value, -8 too) and bf16
    scales [.., groups, N] that differ by up to 5x between groups."""
    qp = torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8)).to(dev)
    s = torch.from_numpy((rng.random(shape[:-2] + (groups, shape[-1])) * 4e-3 + 1e-3)
                         .astype(np.float32)).to(dev, torch.bfloat16)
    return qp, s


P4_SHAPES = [  # M, K, N, out dtype
    (1, 256, 16, torch.bfloat16),        # one group pair, under one strip
    (2, 4096, 6144, torch.bfloat16),     # wqkv of a decode step
    (2, 14336, 4096, torch.bfloat16),    # w_down of a decode step
    (5, 512, 1100, torch.float32),       # split-K form, ragged N: byte-wise loads
    (8, 1024, 520, torch.float32),       # the last M of the split-K form
    (9, 512, 136, torch.bfloat16),       # the first M of the tensor-core form
    (300, 1024, 1100, torch.float32),    # ragged M and N (N % 16 != 0): scalar tile loads
    (333, 512, 520, torch.bfloat16),     # N % 16 != 0 but % 8 == 0: vector stores
    (1943, 4096, 512, torch.bfloat16),   # a prefill row block at full K
]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,out_dtype", P4_SHAPES)
def test_quant_matmul_p4_grouped_kernel_matches_plain(cuda, M, K, N, out_dtype):
    rng = np.random.default_rng(14)
    x = _bf16(rng, (M, K), cuda)
    qp, s = _packed_weight(rng, (K // 2, N), K // 128, cuda)
    form = "splitk" if M <= 8 else "mma"
    before = dict(quant_matmul_p4_grouped.launches_by_form)
    got = quant_matmul_p4_grouped(x, qp, s, out_dtype=out_dtype)
    torch.cuda.synchronize()
    before[form] += 1
    assert quant_matmul_p4_grouped.launches_by_form == before and got.dtype == out_dtype
    assert torch.isfinite(got).all()
    _assert_p4_matches(got, quant_matmul_p4_grouped(x, qp, s, out_dtype=out_dtype,
                                                    impl="plain"), out_dtype, form)
    assert torch.equal(got, quant_matmul_p4_grouped(x, qp, s, out_dtype=out_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,out_dtype", P4_SHAPES + [
    (3, 200, 130, torch.float32),        # K / 2 no multiple of 8, per channel only
    (40, 200, 130, torch.bfloat16),      # the same in the tensor-core form: scalar x loads
])
def test_quant_matmul_p4_kernel_matches_plain(cuda, M, K, N, out_dtype):
    rng = np.random.default_rng(15)
    x = _bf16(rng, (M, K), cuda)
    qp, s = _packed_weight(rng, (K // 2, N), 1, cuda)
    form = "splitk" if M <= 8 else "mma"
    before = dict(quant_matmul_p4.launches_by_form)
    got = quant_matmul_p4(x, qp, s, out_dtype=out_dtype)
    torch.cuda.synchronize()
    before[form] += 1
    assert quant_matmul_p4.launches_by_form == before and got.dtype == out_dtype
    _assert_p4_matches(got, quant_matmul_p4(x, qp, s, out_dtype=out_dtype, impl="plain"),
                       out_dtype, form)
    assert torch.equal(got, quant_matmul_p4(x, qp, s, out_dtype=out_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [2, 200])
@pytest.mark.parametrize("li", [0, 2])
def test_quant_matmul_p4_stacked_kernels_read_the_layer_in_place(cuda, M, li):
    rng = np.random.default_rng(16)
    K, N = 512, 1040
    x = _bf16(rng, (M, K), cuda)
    for groups, stacked, flat in ((1, quant_matmul_p4_stacked, quant_matmul_p4),
                                  (K // 128, quant_matmul_p4_grouped_stacked,
                                   quant_matmul_p4_grouped)):
        qp, s = _packed_weight(rng, (3, K // 2, N), groups, cuda)
        n = flat.launches
        got = stacked(x, qp, s, li, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert flat.launches == n + 1
        _assert_p4_matches(got, stacked(x, qp, s, li, out_dtype=torch.float32, impl="plain"),
                           torch.float32, "splitk" if M <= 8 else "mma")
        sl = s[li].reshape(-1) if groups == 1 else s[li]
        assert torch.equal(got, flat(x, qp[li], sl, out_dtype=torch.float32))


@pytest.mark.cuda
def test_w4a8_product_on_the_card_matches_plain(cuda):
    """Two ``torch._int_mm`` products over the nibble halves against the exact
    plain product: the integer sums are equal, the fp32 epilogue elementwise."""
    rng = np.random.default_rng(17)
    K, N = 1024, 264
    x = torch.from_numpy(_normal(rng, 40, K)).to(cuda)
    qp, s = _packed_weight(rng, (K // 2, N), 1, cuda)
    xq, xs = quantize_acts(x)
    got = quant_apply_w8a8(xq, xs, {"qp": qp, "s": s}, (N,), out_dtype=torch.float32)
    want = quant_apply_w8a8(xq, xs, {"qp": qp, "s": s}, (N,), out_dtype=torch.float32,
                            impl="plain")
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_p4_wrappers_refuse_what_they_do_not_take(cuda):
    rng = np.random.default_rng(18)
    qp, s = _packed_weight(rng, (128, 32), 2, cuda)
    x = torch.zeros((2, 256), device=cuda)  # fp32: the kernels take bf16
    with pytest.raises(TypeError):
        quant_matmul_p4_grouped(x, qp, s)
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError):
        quant_matmul_p4_grouped(xb, qp, s.cpu())
    qp4, s4 = _packed_weight(rng, (128, 32), 4, cuda)  # groups of 64: plain only
    with pytest.raises(ValueError, match="128"):
        quant_matmul_p4_grouped(xb, qp4, s4)
    with pytest.raises(ValueError):
        quant_matmul_p4(xb, qp[:, ::2], s[0, ::2])  # strided qp


def _int8_stripe(rng, L, B, NKV, S, HD, dev):
    from trace_tpu_torch.model.config import DecoderConfig
    from trace_tpu_torch.model.mistral import _quantize_kv, init_kv_cache

    cfg = DecoderConfig(num_layers=L, num_kv_heads=NKV, head_dim=HD, kv_cache_dtype="int8")
    cache = init_kv_cache(cfg, B, S, device=dev)
    for vals, scales in (("kq", "ks"), ("vq", "vs")):
        for li in range(L):
            cache[vals][li], cache[scales][li] = _quantize_kv(_bf16(rng, (B, NKV, S, HD), dev))
    return cache


# int8 decode attention: integer sums are exact and every fp32 step that
# feeds a rounding is the plain version's, so kernel and plain differ only
# where expf and torch.exp round a probability apart: a quantized p * vs on
# a half flips by one step (at most ps * 127 / l of an output, ~1/S of it),
# then the bf16 output may round to its neighbour: two bf16 steps relative,
# and the bf16 decode kernel's absolute limit.
@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["s8dot", "dequant"])
@pytest.mark.parametrize("L,B,NKV,G,S,HD", [(3, 3, 2, 4, 333, 128), (2, 2, 2, 2, 40, 64),
                                            (2, 4, 8, 4, 2304, 128)])
def test_int8_decode_kernel_matches_plain(cuda, mode, L, B, NKV, G, S, HD):
    rng = np.random.default_rng(11)
    q = _bf16(rng, (B, NKV * G, 1, HD), cuda)
    cache = _int8_stripe(rng, L, B, NKV, S, HD, cuda)
    stripe = {name: leaf[1] for name, leaf in cache.items()}
    masked = torch.from_numpy(rng.random((B, S)) < 0.5).to(cuda)
    bias = torch.where(masked, -1e30, 0.0).float()
    n = decode_attention.launches_int8[mode]
    got = decode_attention(q, stripe, None, bias, mode=mode)
    torch.cuda.synchronize()
    assert decode_attention.launches_int8[mode] == n + 1
    want = decode_attention(q, stripe, None, bias, mode=mode, impl="plain")
    assert torch.isfinite(got).all()
    _assert_matches(got, want, ATOL["decode"])
    assert torch.equal(got, decode_attention(q, stripe, None, bias, mode=mode))


@pytest.mark.cuda
def test_int8_product_on_the_card_is_exact_or_refused(cuda):
    rng = np.random.default_rng(12)
    a = torch.from_numpy(rng.integers(100, 128, (32, 1600), dtype=np.int8)).to(cuda)
    b = torch.from_numpy(rng.integers(100, 128, (1600, 24), dtype=np.int8)).to(cuda)
    exact = (a.cpu().long() @ b.cpu().long())
    assert exact.max() > 2 ** 24
    for impl in ("auto", "plain"):
        assert torch.equal(int8_matmul(a, b, impl=impl).cpu(), exact.float())
    with pytest.raises(ValueError):
        int8_matmul(a[:16], b)       # 16 rows or fewer
    with pytest.raises(ValueError):
        int8_matmul(a, b[:, :20])    # N no multiple of 8


@pytest.mark.cuda
def test_int8_wrappers_refuse_what_they_do_not_take(cuda):
    x = torch.zeros((2, 64), device=cuda)  # fp32: the kernel takes bf16
    q = torch.zeros((64, 32), dtype=torch.int8, device=cuda)
    s = torch.ones((32,), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError):
        quant_matmul(x, q, s)
    xb = torch.zeros((2, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        quant_matmul(xb[:, ::2], q, s)  # strided x
    with pytest.raises(ValueError):
        quant_matmul(xb[:, :64].contiguous(), q, s.cpu())
    rng = np.random.default_rng(13)
    cache = _int8_stripe(rng, 1, 1, 2, 16, 128, cuda)
    stripe = {name: leaf[0] for name, leaf in cache.items()}
    qh = torch.zeros((1, 4, 1, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        decode_attention(qh, {**stripe, "ks": stripe["ks"].float()}, None,
                         torch.zeros((1, 16), device=cuda))
    with pytest.raises(ValueError):
        decode_attention(qh, stripe, None, torch.zeros((1, 16), device=cuda), mode="fp8")
