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


FLASH_CASES = [  # B, H, Hkv, T, hd, pad, side
    (2, 8, 2, 300, 128, 37, "left"),
    (1, 4, 4, 128, 64, 0, "left"),
    # the forward's tile edges: 128 query rows a block, 128 keys a tile
    (2, 8, 2, 128, 128, 0, "left"),     # one whole query tile
    (1, 4, 1, 129, 128, 5, "left"),     # a second query tile holding one row
    (2, 8, 2, 257, 128, 20, "right"),   # right padding: every row sees a key
    (1, 8, 2, 257, 64, 0, "left"),      # hd = 64, GQA group 4
    (2, 16, 4, 129, 64, 3, "right"),    # hd = 64, GQA group 4, right padding
    (2, 28, 4, 300, 128, 37, "left"),   # qwen2-7B's heads: GQA group 7
]


def _flash_inputs(cuda, B, H, Hkv, T, hd, pad, side, seed=6):
    rng = np.random.default_rng(seed)
    q, k, v = _bf16(rng, (B, H, T, hd), cuda), _bf16(rng, (B, Hkv, T, hd), cuda), \
        _bf16(rng, (B, Hkv, T, hd), cuda)
    bias = torch.zeros((B, T), device=cuda)
    if pad:
        if side == "left":
            bias[0, :pad] = -1e30
        else:
            bias[0, T - pad:] = -1e30
    return q, k, v, bias


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,T,hd,pad,side", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, B, H, Hkv, T, hd, pad, side):
    q, k, v, bias = _flash_inputs(cuda, B, H, Hkv, T, hd, pad, side)
    n = flash_attention.launches
    got = flash_attention(q, k, v, bias, True)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    want = flash_attention(q, k, v, bias, True, impl="plain")
    assert torch.isfinite(got).all()
    # every row, the left-padded ones that see no key too (the mean of v)
    _assert_matches(got, want, ATOL["flash"])


NO_KEY_CASES = [  # B, H, Hkv, T, hd, causal, the masked keys of batch row 0
    (2, 8, 2, 300, 128, True, (0, 37)),      # left padding
    (2, 8, 2, 300, 128, True, (0, 300)),     # a row wholly masked
    (2, 8, 2, 300, 128, False, (0, 300)),    # the same, not causal
    (1, 8, 2, 257, 64, True, (0, 130)),      # hd = 64, past a key tile
    (2, 28, 4, 2048, 128, True, (0, 300)),   # the prefill shape, GQA group 7
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,T,hd,causal,masked", NO_KEY_CASES)
def test_flash_rows_that_see_no_key_get_the_mean_of_v(cuda, B, H, Hkv, T, hd, causal,
                                                      masked):
    """A query row whose keys are all masked gets the mean of v over the
    keys, as the plain version's uniform softmax over equal -1e30 scores (and
    the Pallas kernel's at a multiple of 128 keys) gives it; the rows that see
    a key are untouched. A routed MoE layer gives such rows bucket slots."""
    q, k, v, _ = _flash_inputs(cuda, B, H, Hkv, T, hd, 0, "left", seed=8)
    bias = torch.zeros((B, T), device=cuda)
    bias[0, masked[0]:masked[1]] = -1e30
    got = flash_attention(q, k, v, bias, causal)
    want = flash_attention(q, k, v, bias, causal, impl="plain")
    torch.cuda.synchronize()
    _assert_matches(got, want, ATOL["flash"])
    unseen = masked[1] if causal or masked[1] == T else 0
    mean = v[0].float().mean(dim=1).repeat_interleave(H // Hkv, dim=0)  # [H, hd]
    rows = got[0, :, :unseen].float()
    torch.testing.assert_close(rows, mean[:, None].expand_as(rows), atol=1e-6, rtol=2 ** -8)
    assert unseen > 0


@pytest.mark.cuda
@pytest.mark.parametrize("B,P,NH,HD,TQ", [(3, 80, 4, 64, 77), (2, 592, 16, 64, 577)])
def test_vit_kernel_matches_plain_on_fused_slices(cuda, B, P, NH, HD, TQ):
    rng = np.random.default_rng(7)
    qkv = _bf16(rng, (B, P, 3 * NH * HD), cuda)
    q, k, v = qkv.split(NH * HD, dim=-1)  # strided column slices, read in place
    got = vit_attention_btd(q, k, v, TQ, NH)
    want = vit_attention_btd(q, k, v, TQ, NH, impl="plain")
    _assert_matches(got[:, :TQ], want[:, :TQ], ATOL["vit"])


@pytest.mark.cuda
@pytest.mark.parametrize("row", ["flash_attention", "vit_attention_btd",
                                 "flash_attention_fwd_res"])
def test_attention_forward_repeats_bit_for_bit(cuda, row):
    """The forward sums in a fixed order and has no atomics: two launches on
    the same inputs give the same bits, for each of the rows it serves."""
    from trace_tpu_torch.kernels.flash_backward import flash_attention_fwd_res

    if row == "vit_attention_btd":
        rng = np.random.default_rng(20)
        q, k, v = _bf16(rng, (2, 592, 3 * 1024), cuda).split(1024, dim=-1)
        run = lambda: (vit_attention_btd(q, k, v, 577, 16),)
    else:
        q, k, v, bias = _flash_inputs(cuda, 2, 8, 2, 300, 128, 37, "left", seed=20)
        if row == "flash_attention":
            run = lambda: (flash_attention(q, k, v, bias, True),)
        else:
            run = lambda: flash_attention_fwd_res(q, k, v, bias, causal=True)
    first, second = run(), run()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_forward_pv_product_on_one_tile(cuda, hd):
    """The forward's O += P V on one tile alone (P in the A fragments, V
    through its tensor map and the MN-major swizzled descriptor) against
    torch.matmul in fp32: bf16 x bf16 products are exact in fp32, so only the
    summation order differs. A wrong descriptor offset moves whole blocks of
    O."""
    import ctypes

    from trace_tpu_torch.kernels.build import check, load

    lib = load("attention.cu")
    bk = lib.attn_fwd_tile_keys(hd)
    assert bk == (64 if hd == 256 else 128)
    rng = np.random.default_rng(21)
    p = torch.from_numpy(rng.random((64, bk)).astype(np.float32)).to(cuda, torch.bfloat16)
    v = _bf16(rng, (bk, hd), cuda)
    o = torch.empty((64, hd), dtype=torch.float32, device=cuda)
    fn = lib.attn_pv_tile_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    check(fn(p.data_ptr(), v.data_ptr(), o.data_ptr(), hd,
             torch.cuda.current_stream().cuda_stream), "attn_pv_tile_bf16")
    torch.cuda.synchronize()
    torch.testing.assert_close(o, p.float() @ v.float(), atol=1e-4, rtol=1e-5)


# bf16 decode attention: kernel and plain version round p to bf16 at the
# same point (under the row max, before the division), so they differ by the
# order of the fp32 sums and where expf and torch.exp round a p apart; the
# limits of the other decode tests hold.
def _bf16_stripe(cuda, B, NKV, G, S, HD, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((B, NKV * G, 1, HD), generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn((B, NKV, S, HD), generator=gen, device=cuda).to(torch.bfloat16)
    v = torch.randn((B, NKV, S, HD), generator=gen, device=cuda).to(torch.bfloat16)
    return q, k, v


def _check_bf16_decode(q, k, v, bias):
    n = decode_attention.launches
    got = decode_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert decode_attention.launches == n + 1
    want = decode_attention(q, k, v, bias, impl="plain")
    assert torch.isfinite(got).all()
    _assert_matches(got, want, ATOL["decode"])
    assert torch.equal(got, decode_attention(q, k, v, bias))  # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("HD", [64, 128])
@pytest.mark.parametrize("S", [333, 2304])
def test_decode_kernel_matches_plain(cuda, G, HD, S):
    """Layer 1's stripe of a 3-layer cache, read in place; half the slots
    masked at random."""
    L, B, NKV = 3, 3, 2
    rng = np.random.default_rng(8)
    q = _bf16(rng, (B, NKV * G, 1, HD), cuda)
    k, v = _bf16(rng, (L, B, NKV, S, HD), cuda), _bf16(rng, (L, B, NKV, S, HD), cuda)
    bias = _edge_bias(rng, "random", B, S).to(cuda)
    _check_bf16_decode(q, k[1], v[1], bias)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["no_visible", "one_visible", "all_visible", "serving"])
@pytest.mark.parametrize("S", [40, 1100])
def test_decode_kernel_on_edge_masks(cuda, kind, S):
    q, k, v = _bf16_stripe(cuda, 3, 2, 4, S, 128, seed=31)
    bias = _edge_bias(np.random.default_rng(31), kind, 3, S).to(cuda)
    _check_bf16_decode(q, k, v, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "serving"])
def test_decode_kernel_at_the_bench_decode_batch(cuda, kind):
    """B = 32 (the bench's decode batch), S = 2304."""
    q, k, v = _bf16_stripe(cuda, 32, 8, 4, 2304, 128, seed=32)
    bias = _edge_bias(np.random.default_rng(32), kind, 32, 2304).to(cuda)
    _check_bf16_decode(q, k, v, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(64, 8192), (64, 16384), (1, 65536)])
def test_decode_kernel_on_a_large_grid_at_a_long_length(cuda, B, S):
    """B x NKV = 512 (row, kv head) pairs: the grid alone would leave one
    block per pair, whose share of the slots fits its shared memory at
    S = 8192 and not at 16384, so there the cluster keeps more blocks; and
    one row at S = 65536, past the lengths the int8 kernel takes, with 8
    blocks."""
    q, k, v = _bf16_stripe(cuda, B, 8, 4, S, 128, seed=33)
    bias = _edge_bias(np.random.default_rng(33), "random", B, S).to(cuda)
    _check_bf16_decode(q, k, v, bias)


# Attention backward: the kernels round p and ds to bf16 before their second
# product (p^T do, ds k, ds^T q) where the plain version keeps fp32, and both
# round the result to bf16. A gradient sums up to T signed terms, so an
# element's error is a fraction of the gradient's typical size, not of its own:
# limits are in units of the largest |ref|, 2e-2 absolute (measured ~4e-3) and
# two bf16 steps relative, and ||diff|| / ||ref|| <= REL_NORM. lse is fp32 on
# both sides and differs by the online softmax's summation order: 1e-4.
BWD_CASES = [  # B, H, Hkv, Tq, Tk, hd, pad, side, causal
    (2, 8, 2, 300, 300, 128, 37, "right", True),
    (2, 8, 2, 300, 300, 128, 37, "left", True),
    (1, 4, 4, 128, 128, 64, 0, "right", True),
    (2, 4, 1, 77, 77, 64, 5, "right", False),
    (1, 8, 2, 1024, 1024, 128, 100, "right", True),
    # ragged T on both sides of the kernels' 64- and 128-row tiles
    (1, 4, 2, 63, 63, 128, 0, "right", True),
    (1, 4, 2, 200, 200, 128, 20, "right", True),
    (1, 8, 2, 2020, 2020, 128, 0, "right", True),
    (1, 8, 2, 2020, 2020, 64, 50, "left", False),
    # G 1 / 2 / 4 at hd 64 and hd 128, left and right padding, causal and not
    (2, 4, 4, 129, 129, 128, 7, "left", True),
    (2, 4, 4, 200, 200, 64, 30, "left", False),
    (2, 4, 2, 200, 200, 64, 30, "left", True),
    (2, 4, 2, 257, 257, 128, 40, "right", False),
    (1, 8, 2, 257, 257, 64, 0, "right", False),
    (2, 8, 2, 330, 330, 128, 60, "left", False),
    # Tq != Tk: query rows past Tk (causal, they see every key), keys no
    # query row sees (causal, their gradients are zero), and neither
    (1, 4, 2, 330, 200, 128, 25, "right", True),
    (2, 4, 2, 200, 330, 64, 25, "right", True),
    (2, 4, 2, 200, 330, 64, 25, "left", False),
    # the training shape
    (2, 32, 8, 2048, 2048, 128, 300, "right", True),
]


def _bwd_inputs(cuda, B, H, Hkv, Tq, Tk, hd, pad, side):
    """q, k, v, the key bias, do and the query rows that are real; ``pad``
    slots of batch row 0 are padding on ``side`` among both the query rows
    and the keys."""
    rng = np.random.default_rng(11)
    q, do = _bf16(rng, (B, H, Tq, hd), cuda), _bf16(rng, (B, H, Tq, hd), cuda)
    k, v = _bf16(rng, (B, Hkv, Tk, hd), cuda), _bf16(rng, (B, Hkv, Tk, hd), cuda)

    def real(T):
        r = torch.ones((B, T), dtype=torch.bool, device=cuda)
        if pad:
            if side == "right":
                r[0, T - pad:] = False
            else:
                r[0, :pad] = False
        return r

    bias = torch.where(real(Tk), 0.0, -1e30).float()
    real_q = real(Tq)
    do = do * real_q[:, None, :, None]  # padded query rows carry no loss
    return q, k, v, bias, do, real_q


def _assert_grad_matches(got, want, name):
    unit = want.float().abs().max()
    got, want = got.float() / unit, want.float() / unit
    torch.testing.assert_close(got, want, atol=2e-2, rtol=RTOL, msg=lambda m: f"{name}: {m}")
    assert ((got - want).norm() / want.norm()).item() <= REL_NORM, name


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,Tq,Tk,hd,pad,side,causal", BWD_CASES)
def test_flash_backward_kernels_match_plain(cuda, B, H, Hkv, Tq, Tk, hd, pad, side, causal):
    from trace_tpu_torch.kernels import flash_backward as fb

    q, k, v, bias, do, real = _bwd_inputs(cuda, B, H, Hkv, Tq, Tk, hd, pad, side)
    counts = [f.launches for f in (fb.flash_attention_fwd_res, fb.flash_attention_bwd_dq,
                                   fb.flash_attention_bwd_dkv)]
    o, lse = fb.flash_attention_fwd_res(q, k, v, bias, causal=causal)
    o_ref, lse_ref = fb.flash_attention_fwd_res(q, k, v, bias, causal=causal, impl="plain")
    torch.cuda.synchronize()
    sees = torch.ones_like(real)  # query rows that see a key
    if causal and side == "left":
        sees[0, :pad] = False
    rows = sees[:, None, :, None].expand_as(lse)
    # o on every row: a row that sees no key gets the mean of v on both sides
    _assert_matches(o, o_ref, ATOL["flash"])
    torch.testing.assert_close(lse[rows], lse_ref[rows], atol=1e-4, rtol=1e-5)
    assert (lse[~rows] == lse_ref[~rows]).all()  # -1e30 on both sides

    # both backwards from the kernel's own residuals, as training runs them
    got = fb.flash_attention_bwd(q, k, v, bias, o, lse, do, causal=causal)
    want = fb.flash_attention_bwd(q, k, v, bias, o, lse, do, causal=causal, impl="plain")
    torch.cuda.synchronize()
    assert [f.launches for f in (fb.flash_attention_fwd_res, fb.flash_attention_bwd_dq,
                                 fb.flash_attention_bwd_dkv)] == [c + 1 for c in counts]
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert torch.isfinite(g).all(), name
        _assert_grad_matches(g, w, name)
    # and bit for bit the same on a second run: no atomics, a fixed order
    again = fb.flash_attention_bwd(q, k, v, bias, o, lse, do, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_flash_attention_trainable_on_the_card(cuda):
    """The autograd Function against autograd through the plain attention,
    under a non-reentrant checkpoint as the decoder's remat uses it; under
    no_grad it saves nothing."""
    from torch.utils.checkpoint import checkpoint

    from trace_tpu_torch.kernels.flash_attention import flash_attention_trainable, xla_attention

    q, k, v, bias, do, _ = _bwd_inputs(cuda, 2, 8, 2, 256, 256, 128, 30, "right")
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = checkpoint(lambda a, b, c: flash_attention_trainable(a, b, c, bias, True),
                     *leaves, use_reentrant=False)
    out.backward(do)
    refs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    xla_attention(*refs, bias, causal=True).backward(do)
    for a, b, name in zip(leaves, refs, ("dq", "dk", "dv")):
        _assert_grad_matches(a.grad, b.grad, name)
    with torch.no_grad():
        o = flash_attention_trainable(q, k, v, bias, True)
    assert o.grad_fn is None


@pytest.mark.cuda
def test_backward_wrappers_refuse_what_they_do_not_take(cuda):
    """All-fp32 operands take the fp32 forms (they launch); mixed dtypes
    and wrong shapes still raise."""
    from trace_tpu_torch.kernels import flash_backward as fb

    q = torch.zeros((1, 2, 64, 64), device=cuda)
    before = fb.flash_attention_fwd_res.launches_f32
    fb.flash_attention_fwd_res(q, q, q, None, causal=True)
    assert fb.flash_attention_fwd_res.launches_f32 == before + 1
    qb = q.to(torch.bfloat16)
    rows = torch.zeros((1, 2, 64, 1), device=cuda)
    with pytest.raises(TypeError):
        fb.flash_attention_bwd_dq(qb, qb, q, None, qb, rows, rows, causal=True)
    with pytest.raises(TypeError):
        fb.flash_attention_bwd_dq(qb, qb, qb, None, q, rows, rows, causal=True)  # fp32 do
    with pytest.raises(TypeError):
        fb.flash_attention_bwd_delta(q, qb)
    with pytest.raises(ValueError):
        fb.flash_attention_bwd_dkv(qb, qb, qb, None, qb, rows[:, :1], rows, causal=True)
    with pytest.raises(ValueError):
        fb.flash_attention_bwd_dkv(q, q, q, None, q, rows[:, :1], rows, causal=True)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_they_do_not_take(cuda):
    """fp32 q, k and v launch the fp32 forms; mixed dtypes raise."""
    q = torch.zeros((1, 2, 64, 64), device=cuda)
    before = flash_attention.launches_f32
    flash_attention(q, q, q, None, True)
    assert flash_attention.launches_f32 == before + 1
    with pytest.raises(TypeError):
        flash_attention(q, q.to(torch.bfloat16), q, None, True)
    with pytest.raises(ValueError):  # an fp32 q over a bf16 stripe
        decode_attention(q[:, :, :1], q.to(torch.bfloat16), q.to(torch.bfloat16),
                         torch.zeros((1, 64), device=cuda))
    with pytest.raises(ValueError):
        flash_attention(q, q, q, None, False, q_offset=3)  # an offset needs causal


# The fp32 forms (csrc/*_f32.cu and the decode kernels' fp32 instances; the
# attention rows and the tiled weight products as TF32 products of operands
# split into hi and lo, within ~2^-22 of each fp32 product) against their
# plain versions, which compute the same fp32 steps in another summation
# order: outputs within 1e-4 + 1e-4 |ref| and ||diff|| / ||ref|| <= 1e-4
# (the limits of chip_smoke.py); gradients and weight products in units of
# max |ref|.

F32_ATOL, F32_REL_NORM = 1e-4, 1e-4


def _assert_f32(got, want, unit=False, atol=F32_ATOL):
    assert got.dtype == torch.float32
    got, want = got.float(), want.float()
    scale = want.abs().max() if unit else 1.0
    torch.testing.assert_close(got / scale, want / scale, atol=atol if not unit else 1e-5,
                               rtol=F32_ATOL)
    assert ((got - want).norm() / want.norm()).item() <= F32_REL_NORM


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,T,hd,pad,side", FLASH_CASES)
def test_flash_f32_kernel_matches_plain(cuda, B, H, Hkv, T, hd, pad, side):
    q, k, v, bias = _flash_inputs(cuda, B, H, Hkv, T, hd, pad, side)
    q, k, v = q.float(), k.float(), v.float()
    before = flash_attention.launches_f32
    got = flash_attention(q, k, v, bias, True)
    assert flash_attention.launches_f32 == before + 1
    _assert_f32(got, flash_attention(q, k, v, bias, True, impl="plain"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,S,offset", [(64, 300, 100), (129, 2304, 1536), (37, 200, 163)])
def test_flash_query_offset_over_a_strided_stripe(cuda, dtype, T, S, offset):
    """A chunk of a chunked prefill: q at slots offset ... offset + T - 1
    over a layer's stripe of a stacked cache (a strided view, read in
    place), row 0 left-padded, against the plain chunked attention."""
    rng = np.random.default_rng(11)
    B, H, Hkv, hd = 2, 8, 2, 128
    cache = torch.from_numpy(_normal(rng, 2, 3, B, Hkv, S, hd)).to(cuda, dtype)
    k, v = cache[0, 1], cache[1, 1]
    q = torch.from_numpy(_normal(rng, B, H, T, hd)).to(cuda, dtype)
    vis = torch.zeros((B, S), dtype=torch.bool, device=cuda)
    vis[:, :offset + T] = True
    vis[0, :17] = False
    bias = torch.where(vis, 0.0, -1e30).float()
    got = flash_attention(q, k, v, bias, True, q_offset=offset)
    want = flash_attention(q, k, v, bias, True, q_offset=offset, impl="plain")
    if dtype == torch.float32:
        _assert_f32(got, want)
    else:
        _assert_matches(got, want, ATOL["flash"])


def _chunk_inputs(cuda, dtype, kv, marked, seed=16):
    """q of a 129-token chunk at slot 300 over a layer's stripe (dense, or
    the int8 dict) of 600 slots, and (old, new): row 0's cache mask marks
    slots before the chunk and, with ``marked``, slots inside and past it;
    row 1 is left-padded by 5 and marks none."""
    from trace_tpu_torch.model.mistral import _quantize_kv

    rng = np.random.default_rng(seed)
    B, H, Hkv, T, S, hd, at = 2, 8, 2, 129, 600, 128, 300
    q = torch.from_numpy(_normal(rng, B, H, T, hd)).to(cuda, dtype)
    k, v = (torch.from_numpy(_normal(rng, B, Hkv, S, hd)).to(cuda, dtype) for _ in range(2))
    if kv == "dense":
        stripe = (k, v)
    else:
        stripe = {}
        for vals, scales, x in (("kq", "ks", k), ("vq", "vs", v)):
            stripe[vals], stripe[scales] = _quantize_kv(x.to(torch.bfloat16))
    old = torch.zeros((B, S), dtype=torch.bool, device=cuda)
    old[0, 20:at] = True
    if marked:
        old[0, at + 50:at + 80] = True
        old[0, 500:520] = True
    new = torch.zeros((B, S), dtype=torch.bool, device=cuda)
    new[:, at:at + T] = True
    new[1, at:at + 5] = False
    return q, stripe, old, new, at


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["dense", "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_chunk_with_cache_slots_past_its_index_matches_plain(cuda, dtype, kv):
    """A chunk whose cache mask marks slots at and past ``cache_index`` (the
    causal offset of the one-launch route would hide them): on the card two
    launches of the row-8 forward merged by their logsumexp, against the
    plain route (the JAX package's chunk expression) within row 1's
    limits."""
    from trace_tpu_torch.kernels.flash_backward import flash_attention_fwd_res
    from trace_tpu_torch.model.mistral import _attend_chunk

    q, stripe, old, new, at = _chunk_inputs(cuda, dtype, kv, marked=True)
    counter = "launches_f32" if dtype == torch.float32 else "launches"
    n = getattr(flash_attention_fwd_res, counter)
    got = _attend_chunk(q, stripe, (old, new, True), at, "auto")
    assert getattr(flash_attention_fwd_res, counter) == n + 2
    want = _attend_chunk(q, stripe, (old, new, True), at, "plain")
    if dtype == torch.float32:
        _assert_f32(got, want)
    else:
        _assert_matches(got, want, ATOL["flash"])


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["dense", "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ordinary_chunk_is_one_launch_bit_for_bit(cuda, dtype, kv):
    """A chunk whose cache mask marks no slot at or past ``cache_index``
    (every caller in the package) stays one launch of row 1 with the query
    offset, bit-equal to that launch."""
    from trace_tpu_torch.model.mistral import _attend_chunk

    q, stripe, old, new, at = _chunk_inputs(cuda, dtype, kv, marked=False)
    counter = "launches_f32" if dtype == torch.float32 else "launches"
    n = getattr(flash_attention, counter)
    got = _attend_chunk(q, stripe, (old, new, False), at, "auto")
    assert getattr(flash_attention, counter) == n + 1
    if kv == "dense":
        k, v = stripe
    else:
        k = (stripe["kq"].float() * stripe["ks"].transpose(-1, -2).float()).to(dtype)
        v = (stripe["vq"].float() * stripe["vs"].transpose(-1, -2).float()).to(dtype)
    bias = torch.where(old | new, 0.0, -1e30).float()
    assert torch.equal(got, flash_attention(q, k, v, bias, True, q_offset=at))


@pytest.mark.cuda
@pytest.mark.parametrize("B,P,NH,HD,TQ", [(3, 80, 4, 64, 77), (2, 592, 16, 64, 577)])
def test_vit_f32_kernel_matches_plain_on_fused_slices(cuda, B, P, NH, HD, TQ):
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(_normal(rng, B, P, 3 * NH * HD)).to(cuda)
    q, k, v = qkv.split(NH * HD, dim=-1)
    got = vit_attention_btd(q, k, v, TQ, NH)
    _assert_f32(got[:, :TQ], vit_attention_btd(q, k, v, TQ, NH, impl="plain")[:, :TQ])


# The fp32 forward on the tensor cores (csrc/attention_f32.cu) takes blocks
# of 128 query rows, two warpgroups of 64, and tiles of 64 keys: T on both
# sides of 32, 64, 128 and past 160, hd 64 and 128, G 1, 4, 7 and 8, both
# paddings (left padding past a key tile: rows that see no key). The inputs
# are fp32 normals, not bf16 values, so that every operand has a lo part.
F32_FWD_EDGE_CASES = [  # B, H, Hkv, T, hd, pad, side
    (1, 4, 4, 31, 128, 0, "left"),
    (2, 8, 2, 32, 64, 3, "left"),
    (1, 8, 1, 33, 128, 5, "right"),
    (2, 4, 1, 63, 64, 0, "right"),
    (1, 7, 1, 64, 128, 10, "left"),
    (2, 16, 4, 65, 64, 7, "right"),
    (1, 8, 8, 127, 128, 0, "left"),
    (2, 8, 1, 128, 64, 20, "left"),
    (1, 28, 4, 129, 128, 33, "right"),
    (2, 8, 2, 161, 64, 70, "left"),
    (1, 4, 1, 161, 128, 0, "right"),
    (2, 7, 1, 300, 128, 130, "left"),
]


def _f32_inputs(cuda, B, H, Hkv, T, hd, pad, side, seed=24):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(_normal(rng, B, h, T, hd)).to(cuda) for h in (H, Hkv, Hkv))
    bias = torch.zeros((B, T), device=cuda)
    if pad:
        if side == "left":
            bias[0, :pad] = -1e30
        else:
            bias[0, T - pad:] = -1e30
    return q, k, v, bias


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,T,hd,pad,side", F32_FWD_EDGE_CASES)
def test_flash_f32_forward_at_its_tile_edges(cuda, B, H, Hkv, T, hd, pad, side):
    """Rows 1 and 8 in fp32 against the plain version (o within 1e-4 + 1e-4
    |ref|, the lse within 1e-4), rows that see no key included, and a repeat
    bit for bit."""
    from trace_tpu_torch.kernels.flash_backward import flash_attention_fwd_res

    q, k, v, bias = _f32_inputs(cuda, B, H, Hkv, T, hd, pad, side)
    before = flash_attention.launches_f32, flash_attention_fwd_res.launches_f32
    got = flash_attention(q, k, v, bias, True)
    o, lse = flash_attention_fwd_res(q, k, v, bias, causal=True)
    assert (flash_attention.launches_f32, flash_attention_fwd_res.launches_f32) == (
        before[0] + 1, before[1] + 1)
    want = flash_attention(q, k, v, bias, True, impl="plain")
    o_ref, lse_ref = flash_attention_fwd_res(q, k, v, bias, causal=True, impl="plain")
    _assert_f32(got, want)
    _assert_f32(o, o_ref)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0)
    again, (o2, lse2) = flash_attention(q, k, v, bias, True), flash_attention_fwd_res(
        q, k, v, bias, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_f32_forward_on_a_wholly_masked_row(cuda, hd, causal):
    """A batch row whose keys are all masked: every query row of it sees no
    key and gets the mean of v (the second launch); its lse is -1e30, as the
    plain version's."""
    from trace_tpu_torch.kernels.flash_backward import flash_attention_fwd_res

    q, k, v, bias = _f32_inputs(cuda, 2, 8, 2, 200, hd, 200, "left", seed=25)
    o, lse = flash_attention_fwd_res(q, k, v, bias, causal=causal)
    o_ref, lse_ref = flash_attention_fwd_res(q, k, v, bias, causal=causal, impl="plain")
    _assert_f32(o, o_ref)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0)
    assert (lse[0] == -1e30).all()


@pytest.mark.cuda
@pytest.mark.parametrize("T,S,offset,hd", [(65, 400, 200, 64), (161, 700, 500, 64),
                                           (63, 640, 577, 128), (128, 1000, 64, 128)])
def test_flash_f32_query_offset_at_tile_edges(cuda, T, S, offset, hd):
    """A chunk at slots offset ... offset + T - 1 over a strided stripe of a
    stacked cache, row 0 left-padded past a key tile, fp32 normals."""
    rng = np.random.default_rng(26)
    B, H, Hkv = 2, 8, 2
    cache = torch.from_numpy(_normal(rng, 2, 3, B, Hkv, S, hd)).to(cuda)
    k, v = cache[0, 2], cache[1, 2]
    q = torch.from_numpy(_normal(rng, B, H, T, hd)).to(cuda)
    vis = torch.zeros((B, S), dtype=torch.bool, device=cuda)
    vis[:, :offset + T] = True
    vis[0, :70] = False
    bias = torch.where(vis, 0.0, -1e30).float()
    got = flash_attention(q, k, v, bias, True, q_offset=offset)
    _assert_f32(got, flash_attention(q, k, v, bias, True, q_offset=offset, impl="plain"))
    assert torch.equal(got, flash_attention(q, k, v, bias, True, q_offset=offset))


@pytest.mark.cuda
@pytest.mark.parametrize("B,P,NH,HD,TQ", [(2, 65, 2, 64, 63), (3, 161, 4, 64, 97),
                                          (1, 130, 2, 128, 64), (2, 200, 3, 128, 129)])
def test_vit_f32_forward_at_its_tile_edges(cuda, B, P, NH, HD, TQ):
    """Row 2 in fp32 on column slices of a fused fp32 QKV with kv_len < Tk,
    against the plain version on the real rows, and a repeat bit for bit."""
    rng = np.random.default_rng(27)
    qkv = torch.from_numpy(_normal(rng, B, P, 3 * NH * HD)).to(cuda)
    q, k, v = qkv.split(NH * HD, dim=-1)
    before = vit_attention_btd.launches_f32
    got = vit_attention_btd(q, k, v, TQ, NH)
    assert vit_attention_btd.launches_f32 == before + 1
    _assert_f32(got[:, :TQ], vit_attention_btd(q, k, v, TQ, NH, impl="plain")[:, :TQ])
    assert torch.equal(got, vit_attention_btd(q, k, v, TQ, NH))


# the fp32 backward's tensor-core kernels take blocks of 32 query rows (dq)
# or keys (dk/dv) and stream tiles of 64 keys or rows: besides BWD_CASES,
# the training shape at hd 64, G = 8, Tq != Tk causal and not, and T ragged
# on both sides of 32 and 64
BWD_F32_CASES = BWD_CASES + [  # B, H, Hkv, Tq, Tk, hd, pad, side, causal
    (2, 32, 8, 2048, 2048, 64, 300, "right", True),
    (1, 8, 1, 200, 200, 128, 20, "right", True),
    (2, 16, 2, 97, 97, 64, 10, "left", False),
    (1, 4, 1, 95, 161, 128, 0, "right", False),
    (1, 8, 2, 161, 95, 64, 7, "left", True),
    (2, 8, 8, 161, 95, 128, 7, "right", True),
    (1, 4, 2, 31, 31, 128, 0, "right", True),
    (1, 4, 2, 32, 32, 64, 0, "right", True),
    (2, 4, 2, 33, 33, 64, 3, "left", True),
    (2, 4, 2, 65, 65, 128, 5, "right", False),
    (1, 4, 4, 96, 96, 128, 9, "left", True),
    (1, 4, 1, 97, 97, 64, 9, "right", True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,Tq,Tk,hd,pad,side,causal", BWD_F32_CASES)
def test_flash_backward_f32_kernels_match_plain(cuda, B, H, Hkv, Tq, Tk, hd, pad, side, causal):
    """Limits in units of max |ref|: 1e-5 + 1e-4 |ref|, ||diff|| / ||ref|| <=
    1e-4 (three TF32 products for each fp32 product); a repeat bit for bit."""
    from trace_tpu_torch.kernels import flash_backward as fb

    q, k, v, bias, do, _ = _bwd_inputs(cuda, B, H, Hkv, Tq, Tk, hd, pad, side)
    q, k, v, do = q.float(), k.float(), v.float(), do.float()
    o, lse = fb.flash_attention_fwd_res(q, k, v, bias, causal=causal)
    o_ref, lse_ref = fb.flash_attention_fwd_res(q, k, v, bias, causal=causal, impl="plain")
    _assert_f32(o, o_ref)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0)
    delta = fb.flash_attention_bwd_delta(o, do)
    torch.testing.assert_close(delta, fb.flash_attention_bwd_delta(o, do, impl="plain"),
                               atol=1e-5, rtol=1e-5)
    args = (q, k, v, bias, do, lse, delta)
    _assert_f32(fb.flash_attention_bwd_dq(*args, causal=causal),
                fb.flash_attention_bwd_dq(*args, causal=causal, impl="plain"), unit=True)
    for a, b in zip(fb.flash_attention_bwd_dkv(*args, causal=causal),
                    fb.flash_attention_bwd_dkv(*args, causal=causal, impl="plain")):
        _assert_f32(a, b, unit=True)
    again = fb.flash_attention_bwd(q, k, v, bias, o, lse, do, causal=causal)
    first = (fb.flash_attention_bwd_dq(*args, causal=causal),) + fb.flash_attention_bwd_dkv(
        *args, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("G,HD,S,B,NKV", [
    (1, 128, 333, 3, 2), (4, 128, 2304, 3, 2), (7, 128, 2304, 3, 2), (8, 64, 1100, 3, 2),
    (16, 128, 500, 3, 2),
    # the bench's decode batch: the host rule takes C = 2 blocks a (kv head, row)
    (4, 128, 2304, 32, 8),
    # there at S = 20000 (5.2 GB of fp32 stripe) a share of 2 would not fit a
    # block's shared memory, so the rule raises C to 3
    (4, 128, 20000, 32, 8)])
@pytest.mark.parametrize("cache", ["f32", "s8dot", "dequant"])
def test_decode_f32_kernels_match_plain(cuda, cache, G, HD, S, B, NKV):
    """fp32 q over an fp32 stripe (row 3) or the int8 one (row 3b, both
    modes), any group (more than 8 split by the wrapper), rows with no,
    one and many visible slots."""
    from trace_tpu_torch.model.mistral import _quantize_kv

    rng = np.random.default_rng(12)
    q = torch.from_numpy(_normal(rng, B, NKV * G, 1, HD)).to(cuda)
    if B * NKV * S * HD > 2 ** 26:  # the long stripe: made on the card
        gen = torch.Generator(device=cuda).manual_seed(12)
        kf, vf = (torch.randn((B, NKV, S, HD), generator=gen, device=cuda) for _ in range(2))
    else:
        kf = torch.from_numpy(_normal(rng, B, NKV, S, HD)).to(cuda)
        vf = torch.from_numpy(_normal(rng, B, NKV, S, HD)).to(cuda)
    vis = torch.from_numpy(rng.random((B, S)) < 0.5).to(cuda)
    vis[1] = False
    vis[2] = False
    vis[2, S // 3] = True
    bias = torch.where(vis, 0.0, -1e30).float()
    if cache == "f32":
        run = lambda impl: decode_attention(q, kf, vf, bias, impl=impl)
    else:
        stripe = {}
        for vals, scales, x in (("kq", "ks", kf), ("vq", "vs", vf)):
            stripe[vals], stripe[scales] = _quantize_kv(x.to(torch.bfloat16))
        run = lambda impl: decode_attention(q, stripe, None, bias, mode=cache, impl=impl)
    # dequant rounds p to bf16 as its plain version does; a p an ulp apart
    # may round to a neighbouring bf16 step there (the bf16 row's atol)
    _assert_f32(run("auto"), run("plain"), atol=2e-3 if cache == "dequant" else F32_ATOL)
    assert torch.equal(run("auto"), run("auto"))


F32_QMM_CASES = [  # form, M, K, N, out dtype
    ("i8", 2, 4096, 6144, torch.float32), ("i8", 7, 1000, 1100, torch.bfloat16),
    ("i8", 37, 1000, 1100, torch.float32), ("i8", 300, 512, 640, torch.float32),
    ("p4", 1, 4096, 4096, torch.float32), ("p4", 8, 14336, 4096, torch.bfloat16),
    ("p4", 200, 1000, 1100, torch.float32), ("p4", 129, 4096, 6144, torch.float32),
    ("p4g", 2, 4096, 28672, torch.float32), ("p4g", 5, 1024, 1100, torch.bfloat16),
    ("p4g", 65, 1024, 1100, torch.float32), ("p4g", 300, 4096, 4096, torch.float32),
    # the tensor-core form: K = 14336 (w_down: the promoted sums), both tile
    # heights ragged (37 rows of the 64-row tile, 3886 = 30 x 128 + 46), N
    # not a multiple of 128, and x or the weight through loads (K or K / 2
    # not a multiple of 4, N not of 16)
    ("i8", 3886, 14336, 1100, torch.float32), ("i8", 37, 14336, 4100, torch.bfloat16),
    ("i8", 20, 1001, 1104, torch.float32),
    ("p4", 3886, 14336, 1100, torch.float32), ("p4", 37, 14336, 4100, torch.float32),
    ("p4", 100, 1002, 1040, torch.bfloat16),
    ("p4g", 3886, 14336, 1100, torch.bfloat16), ("p4g", 37, 14336, 4100, torch.float32),
    ("p4g", 3886, 4096, 6144, torch.float32),
    # the split form's fp32 instances (M <= 8): K = 1000 (x by TMA) and 1002
    # (K or K / 2 no multiple of 4: x through loads), N = 520 and 1100 (no
    # multiple of 16: the weight through loads), w_down's K = 14336 (the
    # longest chain of stages), the lm_head
    ("i8", 1, 4096, 32000, torch.float32), ("i8", 3, 1000, 1100, torch.bfloat16),
    ("i8", 5, 1002, 520, torch.float32), ("i8", 8, 14336, 4096, torch.float32),
    ("p4", 3, 1000, 520, torch.float32), ("p4", 5, 1002, 1100, torch.bfloat16),
    ("p4", 8, 14336, 1100, torch.float32), ("p4", 1, 4096, 32000, torch.float32),
    ("p4g", 1, 14336, 4096, torch.float32), ("p4g", 3, 1024, 520, torch.float32),
    ("p4g", 8, 4096, 1100, torch.bfloat16), ("p4g", 5, 4096, 32000, torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("form,M,K,N,out_dtype", F32_QMM_CASES)
def test_quant_matmul_f32_forms_match_plain(cuda, form, M, K, N, out_dtype):
    """fp32 x through every weight product's fp32 form, split K (M <= 8) and
    tiled, 2-D and stacked (layer 1 of 2, read in place), in units of the
    largest output: 1e-5 (fp32 outputs), a bf16 step (bf16)."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(_normal(rng, M, K)).to(cuda)
    if form == "i8":
        w = torch.from_numpy(rng.integers(-127, 128, (2, K, N), dtype=np.int8)).to(cuda)
        s = torch.from_numpy(rng.random((2, N)) * 4e-4 + 1e-4).to(cuda, torch.bfloat16)
        flat, stacked = quant_matmul, quant_matmul_stacked
    else:
        w = torch.from_numpy(rng.integers(-128, 128, (2, K // 2, N), dtype=np.int8)).to(cuda)
        G = K // 128 if form == "p4g" else 1
        s = torch.from_numpy(rng.random((2, G, N)) * 4e-3 + 1e-3).to(cuda, torch.bfloat16)
        if form == "p4g":
            flat, stacked = quant_matmul_p4_grouped, quant_matmul_p4_grouped_stacked
        else:
            flat, stacked = quant_matmul_p4, quant_matmul_p4_stacked
            s = s.reshape(2, N)
    before = flat.launches_f32 if flat is not quant_matmul_stacked else 0
    got = stacked(x, w, s, 1, out_dtype=out_dtype)
    want = stacked(x, w, s, 1, out_dtype=out_dtype, impl="plain")
    assert torch.equal(got, flat(x, w[1], s[1], out_dtype=out_dtype))
    if form != "i8":
        assert flat.launches_f32 == before + 2
    unit = want.float().abs().max()
    tol = 1e-5 if out_dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float() / unit, want.float() / unit, atol=tol, rtol=0)
    if out_dtype == torch.float32:
        assert ((got - want).norm() / want.norm()).item() <= 1e-4  # FP32_REL_NORM_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["i8", "p4", "p4g"])
def test_quant_matmul_f32_tiled_form_repeats_bit_for_bit(cuda, form):
    """The tensor-core form sums in a fixed order: two calls, the same bits
    (3886 rows of x, a 7B layer's w_down)."""
    rng = np.random.default_rng(14)
    M, K, N = 3886, 14336, 4096
    x = torch.from_numpy(_normal(rng, M, K)).to(cuda)
    rows = K if form == "i8" else K // 2
    w = torch.from_numpy(rng.integers(-128, 128, (rows, N), dtype=np.int8)).to(cuda)
    G = K // 128 if form == "p4g" else 1
    s = torch.from_numpy(rng.random((G, N)) * 4e-3 + 1e-3).to(cuda, torch.bfloat16)
    fn = {"i8": quant_matmul, "p4": quant_matmul_p4, "p4g": quant_matmul_p4_grouped}[form]
    s = s if form == "p4g" else s.reshape(N)
    n = fn.launches_f32_by_form["tiled"]
    first = fn(x, w, s, out_dtype=torch.float32)
    assert torch.equal(first, fn(x, w, s, out_dtype=torch.float32))
    assert fn.launches_f32_by_form["tiled"] == n + 2


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,G", [(70, 1026, 18), (300, 2048, 2)])
def test_quant_matmul_f32_tiled_grouped_at_other_group_sizes(cuda, M, K, G):
    """The grouped tensor-core form at groups of 57 rows (a scale a row of
    the producer's 4-row chunks, x and the weight through loads) and of
    1024, against the plain version."""
    rng = np.random.default_rng(15)
    N = 1100
    x = torch.from_numpy(_normal(rng, M, K)).to(cuda)
    w = torch.from_numpy(rng.integers(-128, 128, (K // 2, N), dtype=np.int8)).to(cuda)
    s = torch.from_numpy(rng.random((G, N)) * 4e-3 + 1e-3).to(cuda, torch.bfloat16)
    got = quant_matmul_p4_grouped(x, w, s, out_dtype=torch.float32)
    want = quant_matmul_p4_grouped(x, w, s, out_dtype=torch.float32, impl="plain")
    unit = want.abs().max()
    torch.testing.assert_close(got / unit, want / unit, atol=1e-5, rtol=0)


def _f32_split_operands(rng, form, M, K, N, G, dev):
    """fp32 x [M, K], the weight and its scale for ``form`` (G groups, p4g)."""
    x = torch.from_numpy(_normal(rng, M, K)).to(dev)
    if form == "i8":
        w, s = _int8_weight(rng, (K, N), dev)
        return x, w, s, quant_matmul
    if form == "p4g":
        return (x, *_packed_weight(rng, (K // 2, N), G, dev), quant_matmul_p4_grouped)
    w, s = _packed_weight(rng, (K // 2, N), 1, dev)
    return x, w, s.reshape(N), quant_matmul_p4


def _assert_f32_split(fn, x, w, s, out_dtype=torch.float32):
    """One split-form launch, its plain version's limits (1e-5 of the
    largest output and a relative norm of 1e-4 for fp32 y, a bf16 step for
    bf16 y), and a repeat bit for bit."""
    n = fn.launches_f32_by_form["splitk"]
    got = fn(x, w, s, out_dtype=out_dtype)
    want = fn(x, w, s, out_dtype=out_dtype, impl="plain")
    assert fn.launches_f32_by_form["splitk"] == n + 1 and got.dtype == out_dtype
    unit = want.float().abs().max()
    tol = 1e-5 if out_dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float() / unit, want.float() / unit, atol=tol, rtol=0)
    if out_dtype == torch.float32:
        assert ((got - want).norm() / want.norm()).item() <= 1e-4
    assert torch.equal(got, fn(x, w, s, out_dtype=out_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["i8", "p4", "p4g"])
def test_quant_matmul_f32_split_form_repeats_bit_for_bit(cuda, form):
    """The split form's fp32 instance adds the ranks' sums in rank order and
    nothing atomically: two calls, the same bits (w_down at M = 8)."""
    x, w, s, fn = _f32_split_operands(np.random.default_rng(16), form, 8, 14336, 4096,
                                      14336 // 128, cuda)
    _assert_f32_split(fn, x, w, s)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,G", [(3, 1026, 18), (8, 2048, 2), (5, 1024, 512), (1, 4096, 32)])
def test_quant_matmul_f32_split_grouped_at_other_group_sizes(cuda, M, K, G):
    """The grouped split form's fp32 instance at any even G dividing K:
    groups of 57 rows (x through loads; each lane reads its scales), of
    1024 and of 128 (the scales in the ring), and of 2 (a group a row pair)."""
    x, w, s, fn = _f32_split_operands(np.random.default_rng(17), "p4g", M, K, 1100, G, cuda)
    _assert_f32_split(fn, x, w, s)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["i8", "p4", "p4g"])
@pytest.mark.parametrize("rows,N,cluster", [(128, 1100, 1), (4096, 256, 8)])
def test_quant_matmul_f32_split_at_clusters_of_1_and_8(cuda, form, rows, N, cluster):
    """A plan of one block along K (one rank, no exchange: 128 weight rows)
    and one of eight (the largest exchange through distributed shared
    memory); at M = 2 and 7 (one mma a k-step, and two)."""
    from trace_tpu_torch.kernels.quant_matmul import _plan

    K = rows if form == "i8" else 2 * rows
    for M in (2, 7):
        x, w, s, fn = _f32_split_operands(np.random.default_rng(18), form, M, K, N, K // 128,
                                          cuda)
        assert _plan(form + "f", M, K, N, cuda).cluster == cluster
        _assert_f32_split(fn, x, w, s)


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
# version: the int8 product's limits. Tensor-core form: wgmma adds each 16
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
    # the tensor-core form's tile edges: 64-row tiles up to M = 64, 128-row
    # tiles beyond; 128 columns a tile
    (64, 512, 136, torch.bfloat16),      # the last M of the 64-row tile, N = 128 + 8
    (65, 1024, 120, torch.float32),      # the first M of the 128-row tile, N = 128 - 8
    (128, 512, 120, torch.bfloat16),     # one whole 128-row tile
    (129, 1024, 136, torch.float32),     # a second row tile holding one row
    (256, 4096, 28672, torch.float32),   # w_gateup at full width
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
    (40, 200, 130, torch.bfloat16),      # the same in the tensor-core form: x and qp
                                         # loaded without tensor maps, 64-row tile
    (150, 200, 130, torch.float32),      # the same with 128-row tiles
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
@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("M", [40, 300])
def test_quant_matmul_p4_tensor_core_form_repeats_bit_for_bit(cuda, grouped, M):
    """The tensor-core form sums in a fixed order: two launches on the same
    inputs give the same bits, in both tile heights."""
    rng = np.random.default_rng(19)
    K, N = 4096, 1024
    x = _bf16(rng, (M, K), cuda)
    qp, s = _packed_weight(rng, (K // 2, N), K // 128 if grouped else 1, cuda)
    fn = quant_matmul_p4_grouped if grouped else quant_matmul_p4
    s = s if grouped else s.reshape(-1)
    n = fn.launches_by_form["mma"]
    first = fn(x, qp, s, out_dtype=torch.float32)
    second = fn(x, qp, s, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert fn.launches_by_form["mma"] == n + 2
    assert torch.equal(first, second)


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
    """fp32 x takes the fp32 form (it launches); the other misfits raise."""
    rng = np.random.default_rng(18)
    qp, s = _packed_weight(rng, (128, 32), 2, cuda)
    x = torch.zeros((2, 256), device=cuda)
    before = quant_matmul_p4_grouped.launches_f32
    quant_matmul_p4_grouped(x, qp, s)
    assert quant_matmul_p4_grouped.launches_f32 == before + 1
    with pytest.raises(TypeError):  # an fp32 scale
        quant_matmul_p4_grouped(x, qp, s.float())
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError):
        quant_matmul_p4_grouped(xb, qp, s.cpu())
    qp4, s4 = _packed_weight(rng, (128, 32), 4, cuda)  # groups of 64: plain only
    with pytest.raises(ValueError, match="128"):
        quant_matmul_p4_grouped(xb, qp4, s4)
    with pytest.raises(ValueError):
        quant_matmul_p4(xb, qp[:, ::2], s[0, ::2])  # strided qp


# The split-K forms (M <= 8) of the int8 ("i8") and packed products, per
# channel ("p4") and grouped ("p4g"): one cluster launch each, the weight
# read once for every M <= 8; the int8 product's wide form at M > 8, the
# weight read once for every M <= 32. Weights made once per (form, shape).
_SPLIT_WEIGHTS = {}


def _split_weight(form, K, N, dev, layers=1):
    """([layers,] K or K/2, N) weight and its scale for ``form``, from a seed."""
    key = (form, K, N, layers)
    if key not in _SPLIT_WEIGHTS:
        rng = np.random.default_rng(K + N + layers)
        if form == "i8":
            w = _int8_weight(rng, (layers, K, N), dev)
        else:
            w = _packed_weight(rng, (layers, K // 2, N), K // 128 if form == "p4g" else 1, dev)
        _SPLIT_WEIGHTS.clear()  # one at a time: the w_down weights are large
        _SPLIT_WEIGHTS[key] = w
    return _SPLIT_WEIGHTS[key]


_SPLIT_FLAT = {"i8": quant_matmul, "p4": quant_matmul_p4, "p4g": quant_matmul_p4_grouped}
_SPLIT_STACKED = {"i8": quant_matmul_stacked, "p4": quant_matmul_p4_stacked,
                  "p4g": quant_matmul_p4_grouped_stacked}


def _split_call(form, x, w, s, li=None, out_dtype=torch.bfloat16, impl="auto"):
    """The form's 2-D entry on layer 0 of the stacked leaf, or its stacked
    entry on layer li."""
    if li is not None:
        return _SPLIT_STACKED[form](x, w, s, li, out_dtype=out_dtype, impl=impl)
    s0 = s[0] if form == "p4g" else s[0].reshape(-1)
    return _SPLIT_FLAT[form](x, w[0], s0, out_dtype=out_dtype, impl=impl)


def _check_split(form, x, w, s, li=None, out_dtype=torch.bfloat16):
    """One launch (of the int8 product's wide form where M > 8), its plain
    version's limits, and a repeat bit for bit."""
    fn = (_SPLIT_STACKED if li is not None else _SPLIT_FLAT)[form]
    count = (quant_matmul_stacked if form == "i8" and li is not None
             else _SPLIT_FLAT[form])
    n = count.launches
    by_form = dict(count.launches_by_form)
    by_form["wide" if form == "i8" and x.shape[0] > 8 else "splitk"] += 1
    got = _split_call(form, x, w, s, li, out_dtype)
    torch.cuda.synchronize()
    assert count.launches == n + 1 and got.dtype == out_dtype, fn.__name__
    assert count.launches_by_form == by_form, fn.__name__
    assert torch.isfinite(got).all()
    want = _split_call(form, x, w, s, li, out_dtype, impl="plain")
    if form == "i8":
        _assert_qmm_matches(got, want, out_dtype)
    else:
        _assert_p4_matches(got, want, out_dtype, "splitk")
    assert torch.equal(got, _split_call(form, x, w, s, li, out_dtype))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(4096, 6144), (14336, 4096)])  # wqkv, w_down
@pytest.mark.parametrize("M", range(1, 9))
@pytest.mark.parametrize("form", ["i8", "p4", "p4g"])
def test_split_kernels_match_plain_at_every_m(cuda, form, M, K, N):
    w, s = _split_weight(form, K, N, cuda)
    x = _bf16(np.random.default_rng(M), (M, K), cuda)
    _check_split(form, x, w, s)


@pytest.mark.cuda
@pytest.mark.parametrize("form,M,K,N,out_dtype", [
    ("i8", 2, 512, 100, torch.bfloat16),    # N under one 128-column strip
    ("p4", 2, 512, 100, torch.float32),
    ("p4g", 2, 512, 100, torch.bfloat16),
    ("i8", 5, 2048, 1100, torch.float32),   # N % 16 != 0: the byte-wise loads
    ("p4", 5, 2048, 1100, torch.bfloat16),
    ("p4g", 5, 2048, 1100, torch.float32),
    ("i8", 3, 1000, 2048, torch.bfloat16),  # K no multiple of a rank's share
    ("p4", 3, 1000, 2048, torch.float32),   # K / 2 = 500: x read element by element
    ("p4g", 3, 1024, 2048, torch.bfloat16),  # G = 8: 4 groups a half, 64 rows a rank
    ("i8", 7, 1000, 1100, torch.bfloat16),  # ragged K and N together
    ("i8", 32, 512, 100, torch.float32),    # the wide form: N under one strip
    ("i8", 32, 2048, 1100, torch.bfloat16),  # N % 16 != 0: the byte-wise weight loads
    ("i8", 32, 1000, 1100, torch.float32),  # ragged K and N: x loaded element by element
    ("i8", 27, 1000, 2048, torch.bfloat16),  # ragged K, a tile of 27 rows
])
def test_split_kernels_at_ragged_shapes(cuda, form, M, K, N, out_dtype):
    w, s = _split_weight(form, K, N, cuda)
    x = _bf16(np.random.default_rng(N), (M, K), cuda)
    _check_split(form, x, w, s, out_dtype=out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["i8", "p4", "p4g"])
def test_split_stacked_entries_read_the_last_layer_in_place(cuda, form):
    L, K, N = 4, 4096, 1024
    w, s = _split_weight(form, K, N, cuda, layers=L)
    x = _bf16(np.random.default_rng(31), (2, K), cuda)
    got = _check_split(form, x, w, s, li=L - 1)
    last = s[L - 1] if form == "p4g" else s[L - 1].reshape(-1)
    assert torch.equal(got, _SPLIT_FLAT[form](x, w[L - 1], last, out_dtype=torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(4096, 6144), (14336, 4096)])  # wqkv, w_down
@pytest.mark.parametrize("M", [9, 16, 31, 32, 33, 64, 300])
def test_wide_int8_form_matches_plain(cuda, M, K, N):
    """The int8 product past 8 rows of x: tiles of 32 rows (a ragged last
    one where M is no multiple of 32), one launch of the wide form."""
    w, s = _split_weight("i8", K, N, cuda)
    x = _bf16(np.random.default_rng(M), (M, K), cuda)
    _check_split("i8", x, w, s)


# qwen2-7B's unfused layer products (its qkv biases keep the tree unfused):
# D 3584, wk / wv N = 4 x 128 = 512, I 18944. Group-128 scales give 28 and
# 148 groups, both even. Each weight-only form a decode step runs (int8 at
# M = 2 and its wide form at the decode batch of 32, packed int4 per channel
# and grouped at M = 2) and the tensor-core forms of a prefill (M = 300).
QWEN2_PRODUCTS = [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584)]


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", QWEN2_PRODUCTS)
@pytest.mark.parametrize("form,M", [("i8", 2), ("i8", 32), ("p4", 2), ("p4g", 2)])
def test_decode_step_products_at_qwen2_widths(cuda, form, M, K, N):
    w, s = _split_weight(form, K, N, cuda)
    x = _bf16(np.random.default_rng(M + N), (M, K), cuda)
    _check_split(form, x, w, s)


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", QWEN2_PRODUCTS)
@pytest.mark.parametrize("grouped", [False, True])
def test_prefill_products_at_qwen2_widths(cuda, grouped, K, N):
    fn = quant_matmul_p4_grouped if grouped else quant_matmul_p4
    rng = np.random.default_rng(K + N)
    x = _bf16(rng, (300, K), cuda)
    qp, s = _packed_weight(rng, (K // 2, N), K // 128 if grouped else 1, cuda)
    if not grouped:
        s = s.reshape(-1)
    n = fn.launches_by_form["mma"]
    got = fn(x, qp, s, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert fn.launches_by_form["mma"] == n + 1
    _assert_p4_matches(got, fn(x, qp, s, out_dtype=torch.bfloat16, impl="plain"),
                       torch.bfloat16, "mma")


@pytest.mark.cuda
def test_wide_form_stacked_entry_reads_the_last_layer_in_place(cuda):
    L, K, N = 4, 4096, 1024
    w, s = _split_weight("i8", K, N, cuda, layers=L)
    x = _bf16(np.random.default_rng(32), (32, K), cuda)
    got = _check_split("i8", x, w, s, li=L - 1)
    assert torch.equal(got, quant_matmul(x, w[L - 1], s[L - 1], out_dtype=torch.bfloat16))


@pytest.mark.cuda
def test_wide_form_allocates_only_its_output(cuda):
    K, N = 4096, 6144
    w, s = _split_weight("i8", K, N, cuda)
    x = _bf16(np.random.default_rng(36), (32, K), cuda)
    _split_call("i8", x, w, s)  # built, loaded and planned
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = _split_call("i8", x, w, s)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before == out.untyped_storage().nbytes()
    del out
    assert torch.cuda.memory_allocated() == before


@pytest.mark.cuda
def test_decode_batch_products_replay_in_a_cuda_graph(cuda):
    """The int8 products of a decode step at the bench's batch of 32 rows,
    at full width (the four stacked entries of a fused 7B layer and the
    lm_head), captured in a CUDA graph and replayed: equal to the eager
    calls."""
    g = torch.Generator(device=cuda).manual_seed(37)
    calls = []
    for K, N, out_dtype in ((4096, 6144, torch.bfloat16), (4096, 4096, torch.bfloat16),
                            (4096, 28672, torch.float32), (14336, 4096, torch.bfloat16)):
        q = torch.randint(-127, 128, (2, K, N), generator=g, device=cuda, dtype=torch.int8)
        s = (torch.rand((2, N), generator=g, device=cuda) * 4e-3 + 1e-3).to(torch.bfloat16)
        x = torch.randn((32, K), generator=g, device=cuda).to(torch.bfloat16)
        calls.append(lambda x=x, q=q, s=s, o=out_dtype: quant_matmul_stacked(x, q, s, 1,
                                                                            out_dtype=o))
    q = torch.randint(-127, 128, (4096, 32000), generator=g, device=cuda, dtype=torch.int8)
    s = (torch.rand((32000,), generator=g, device=cuda) * 4e-3 + 1e-3).to(torch.bfloat16)
    x = torch.randn((32, 4096), generator=g, device=cuda).to(torch.bfloat16)
    calls.append(lambda: quant_matmul(x, q, s, out_dtype=torch.float32))
    n = quant_matmul_stacked.launches_by_form["wide"] + quant_matmul.launches_by_form["wide"]
    eager = [f() for f in calls]  # built, loaded and planned outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [f() for f in calls]
    for out in outs:
        out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert (quant_matmul_stacked.launches_by_form["wide"]
            + quant_matmul.launches_by_form["wide"]) == n + 10
    for got, want in zip(outs, eager):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_split_products_replay_in_a_cuda_graph(cuda):
    """One call of each entry a decode step makes (the int8 lm_head and the
    three stacked entries), with bf16 and with fp32 x, captured in a CUDA
    graph and replayed: equal to the eager calls. Capture fails on an allocation outside the graph's pool
    or a synchronising call, so none is left in the wrappers."""
    rng = np.random.default_rng(33)
    K, N = 4096, 1024
    x = _bf16(rng, (2, K), cuda)
    q, sq = _int8_weight(rng, (3, K, N), cuda)
    calls = [lambda: quant_matmul(x, q[0], sq[0], out_dtype=torch.float32),
             lambda: quant_matmul_stacked(x, q, sq, 2)]
    for groups, fn in ((1, quant_matmul_p4_stacked), (K // 128, quant_matmul_p4_grouped_stacked)):
        qp, sp = _packed_weight(rng, (3, K // 2, N), groups, cuda)
        calls.append(lambda fn=fn, qp=qp, sp=sp: fn(x, qp, sp, 2))
    # the same entries with fp32 x: the split form's fp32 instances
    x32 = torch.from_numpy(_normal(rng, 2, K)).to(cuda)
    calls += [lambda: quant_matmul(x32, q[0], sq[0]), lambda: quant_matmul_stacked(x32, q, sq, 2)]
    for groups, fn in ((1, quant_matmul_p4_stacked), (K // 128, quant_matmul_p4_grouped_stacked)):
        qp, sp = _packed_weight(rng, (3, K // 2, N), groups, cuda)
        calls.append(lambda fn=fn, qp=qp, sp=sp: fn(x32, qp, sp, 1))
    eager = [f() for f in calls]  # built, loaded and planned outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [f() for f in calls]
    for out in outs:
        out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for got, want in zip(outs, eager):
        assert torch.equal(got, want)


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


def _edge_bias(rng, kind, B, S):
    """[B, S] decode masks that the kernel's slot skipping must keep: half
    the slots at random; a row that sees no slot (the plain version then
    weighs every slot alike); rows that see every slot; rows that see one
    slot (first, inside, last); and serving rows: left padding, the visible
    prefix, then masked future slots."""
    visible = rng.random((B, S)) < 0.5
    if kind == "no_visible":
        visible[0] = False
    elif kind == "all_visible":
        visible[:] = True
    elif kind == "one_visible":
        visible[:] = False
        for b, j in zip(range(B), (S // 2 + 3, 0, S - 1)):
            visible[b, j] = True
    elif kind == "serving":
        for b in range(B):
            pad = int(rng.integers(0, S // 4))
            end = int(rng.integers(S // 2, S))
            visible[b] = (np.arange(S) >= pad) & (np.arange(S) < end)
    return torch.from_numpy(np.where(visible, 0.0, -1e30).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["s8dot", "dequant"])
@pytest.mark.parametrize("kind", ["no_visible", "one_visible", "serving"])
@pytest.mark.parametrize("S", [40, 1100])
def test_int8_decode_kernel_on_edge_masks(cuda, mode, kind, S):
    B, NKV, G, HD = 3, 2, 4, 128
    rng = np.random.default_rng(24)
    q = _bf16(rng, (B, NKV * G, 1, HD), cuda)
    cache = _int8_stripe(rng, 1, B, NKV, S, HD, cuda)
    stripe = {name: leaf[0] for name, leaf in cache.items()}
    bias = _edge_bias(rng, kind, B, S).to(cuda)
    got = decode_attention(q, stripe, None, bias, mode=mode)
    want = decode_attention(q, stripe, None, bias, mode=mode, impl="plain")
    assert torch.isfinite(got).all()
    _assert_matches(got, want, ATOL["decode"])
    assert torch.equal(got, decode_attention(q, stripe, None, bias, mode=mode))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["s8dot", "dequant"])
def test_int8_decode_kernel_at_the_bench_decode_batch(cuda, mode):
    """B = 32 (the bench's decode batch), S = 2304, serving-shaped masks."""
    B, NKV, G, S, HD = 32, 8, 4, 2304, 128
    rng = np.random.default_rng(25)
    q = _bf16(rng, (B, NKV * G, 1, HD), cuda)
    cache = _int8_stripe(rng, 1, B, NKV, S, HD, cuda)
    stripe = {name: leaf[0] for name, leaf in cache.items()}
    bias = _edge_bias(rng, "serving", B, S).to(cuda)
    got = decode_attention(q, stripe, None, bias, mode=mode)
    want = decode_attention(q, stripe, None, bias, mode=mode, impl="plain")
    _assert_matches(got, want, ATOL["decode"])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["s8dot", "dequant"])
def test_int8_decode_kernel_on_a_large_grid_at_a_long_length(cuda, mode):
    """B x NKV = 512 (row, kv head) pairs at S = 8192: the grid alone would
    leave one block per pair, whose share of the slots would not fit its
    shared memory, so the cluster keeps more blocks."""
    from trace_tpu_torch.model.mistral import _quantize_kv

    B, NKV, G, S, HD = 64, 8, 4, 8192, 128
    gen = torch.Generator(device=cuda).manual_seed(27)
    stripe = {}
    for vals, scales in (("kq", "ks"), ("vq", "vs")):
        x = torch.randn((B, NKV, S, HD), generator=gen, device=cuda).to(torch.bfloat16)
        stripe[vals], stripe[scales] = (t.contiguous() for t in _quantize_kv(x))
        del x
    q = torch.randn((B, NKV * G, 1, HD), generator=gen, device=cuda).to(torch.bfloat16)
    bias = torch.where(torch.rand((B, S), generator=gen, device=cuda) < 0.5,
                       0.0, -1e30).float()
    got = decode_attention(q, stripe, None, bias, mode=mode)
    want = decode_attention(q, stripe, None, bias, mode=mode, impl="plain")
    _assert_matches(got, want, ATOL["decode"])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["s8dot", "dequant"])
def test_int8_decode_is_one_launch_that_allocates_only_its_output(cuda, mode):
    from torch.profiler import ProfilerActivity, profile

    B, NKV, G, S, HD = 4, 8, 4, 2304, 128
    rng = np.random.default_rng(26)
    q = _bf16(rng, (B, NKV * G, 1, HD), cuda)
    cache = _int8_stripe(rng, 1, B, NKV, S, HD, cuda)
    stripe = {name: leaf[0] for name, leaf in cache.items()}
    bias = _edge_bias(rng, "serving", B, S).to(cuda)
    decode_attention(q, stripe, None, bias, mode=mode)  # built and loaded
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decode_attention(q, stripe, None, bias, mode=mode)
        torch.cuda.synchronize()
    on_device = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(on_device) == 1 and "decode_int8_kernel" in on_device[0], on_device
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = decode_attention(q, stripe, None, bias, mode=mode)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before == out.untyped_storage().nbytes()
    del out
    assert torch.cuda.memory_allocated() == before


@pytest.mark.cuda
def test_decode_is_one_launch_that_allocates_only_its_output(cuda):
    # after the int8 decode tests: a profiler session in this process may miss
    # the kernels of a library first launched after an earlier session ended
    from torch.profiler import ProfilerActivity, profile

    q, k, v = _bf16_stripe(cuda, 4, 8, 4, 2304, 128, seed=34)
    bias = _edge_bias(np.random.default_rng(34), "serving", 4, 2304).to(cuda)
    decode_attention(q, k, v, bias)  # built and loaded
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decode_attention(q, k, v, bias)
        torch.cuda.synchronize()
    on_device = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(on_device) == 1 and "decode_kernel" in on_device[0], on_device
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = decode_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before == out.untyped_storage().nbytes()
    del out
    assert torch.cuda.memory_allocated() == before


# Decode attention at any group G = H / NKV (qwen2-7B's 28 / 4 heads give 7):
# one launch takes 1 ... 8 query rows a kv head at hd 128, a larger group is
# split into launches of at most 8. The limits are those above (the fp32
# forms': those of test_decode_f32_kernels_match_plain); every call repeats
# bit for bit and launches once a split. The forms: a bf16 cache, the int8
# one in either mode, and their fp32 instances (fp32 q; "f32": an fp32 cache).
ANY_GROUPS = [3, 5, 6, 7, 8, 16]
DECODE_KERNELS = ["bf16", "s8dot", "dequant", "f32", "s8dot_f32", "dequant_f32"]


def _group_stripe(cuda, kernel, B, NKV, G, S, seed):
    """q [B, NKV * G, 1, 128] and one layer's stripe, bf16, fp32 or int8."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    dtype = torch.float32 if kernel.endswith("f32") else torch.bfloat16
    q = torch.randn((B, NKV * G, 1, 128), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((B, NKV, S, 128), generator=gen, device=cuda) for _ in range(2))
    if kernel in ("bf16", "f32"):
        return q, (k.to(dtype), v.to(dtype))
    from trace_tpu_torch.model.mistral import _quantize_kv

    (kq, ks), (vq, vs) = _quantize_kv(k.to(torch.bfloat16)), _quantize_kv(v.to(torch.bfloat16))
    return q, ({"kq": kq, "ks": ks.contiguous(), "vq": vq, "vs": vs.contiguous()}, None)


def _group_call(kernel, q, kv, bias, impl="auto"):
    mode = kernel.removesuffix("_f32") if kernel.startswith(("s8dot", "dequant")) else "s8dot"
    return decode_attention(q, kv[0], kv[1], bias, mode=mode, impl=impl)


def _launch_count(kernel):
    if kernel in ("bf16", "f32"):
        return decode_attention.launches_f32 if kernel == "f32" else decode_attention.launches
    if kernel.endswith("_f32"):
        return decode_attention.launches_int8_f32[kernel.removesuffix("_f32")]
    return decode_attention.launches_int8[kernel]


def _check_group_decode(kernel, q, kv, bias, G):
    n = _launch_count(kernel)
    got = _group_call(kernel, q, kv, bias)
    torch.cuda.synchronize()
    assert _launch_count(kernel) == n + (G + 7) // 8
    want = _group_call(kernel, q, kv, bias, impl="plain")
    assert torch.isfinite(got).all()
    if kernel.endswith("f32"):
        _assert_f32(got, want, atol=2e-3 if kernel == "dequant_f32" else F32_ATOL)
    else:
        _assert_matches(got, want, ATOL["decode"])
    assert torch.equal(got, _group_call(kernel, q, kv, bias))  # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("G", ANY_GROUPS)
@pytest.mark.parametrize("kernel", DECODE_KERNELS)
@pytest.mark.parametrize("kind", ["no_visible", "one_visible", "all_visible", "serving"])
def test_decode_kernels_at_any_group_on_edge_masks(cuda, G, kernel, kind):
    B, NKV, S = 3, 2, 1100
    q, kv = _group_stripe(cuda, kernel, B, NKV, G, S, seed=40 + G)
    bias = _edge_bias(np.random.default_rng(40 + G), kind, B, S).to(cuda)
    _check_group_decode(kernel, q, kv, bias, G)


@pytest.mark.cuda
@pytest.mark.parametrize("G", ANY_GROUPS)
@pytest.mark.parametrize("kernel", DECODE_KERNELS)
def test_decode_kernels_at_any_group_on_a_large_grid(cuda, G, kernel):
    """B x NKV = 256 (row, kv head) pairs at S = 8192, qwen2's 4 kv heads:
    one block a pair would not hold its share, so the cluster keeps more."""
    B, NKV, S = 64, 4, 8192
    q, kv = _group_stripe(cuda, kernel, B, NKV, G, S, seed=50 + G)
    bias = _edge_bias(np.random.default_rng(50 + G), "random", B, S).to(cuda)
    _check_group_decode(kernel, q, kv, bias, G)


@pytest.mark.cuda
@pytest.mark.parametrize("G", ANY_GROUPS)
@pytest.mark.parametrize("kernel", DECODE_KERNELS)
def test_decode_kernels_at_any_group_launch_once_a_split(cuda, G, kernel):
    """qwen2's decode stripe at B = 4, S = 2304: one kernel on the device a
    split of at most 8 rows (G = 16: two), and a call that one launch takes
    allocates only its output."""
    from torch.profiler import ProfilerActivity, profile

    q, kv = _group_stripe(cuda, kernel, 4, 4, G, 2304, seed=60 + G)
    bias = _edge_bias(np.random.default_rng(60 + G), "serving", 4, 2304).to(cuda)
    _group_call(kernel, q, kv, bias)  # built and loaded
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _group_call(kernel, q, kv, bias)
        torch.cuda.synchronize()
    name = "decode_kernel" if kernel in ("bf16", "f32") else "decode_int8_kernel"
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
    assert len(kernels) == (G + 7) // 8, kernels
    if G <= 8:
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = _group_call(kernel, q, kv, bias)
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated() - before == out.untyped_storage().nbytes()


@pytest.mark.cuda
@pytest.mark.parametrize("G", ANY_GROUPS)
@pytest.mark.parametrize("kernel", DECODE_KERNELS)
def test_decode_kernels_at_any_group_replay_in_a_cuda_graph(cuda, G, kernel):
    """A decode call (G = 16: its two launches, the copies of q's rows and
    the writes of the output's) captured in a CUDA graph and replayed: equal
    to the eager call."""
    q, kv = _group_stripe(cuda, kernel, 4, 4, G, 2304, seed=70 + G)
    bias = _edge_bias(np.random.default_rng(70 + G), "serving", 4, 2304).to(cuda)
    eager = _group_call(kernel, q, kv, bias)  # built and loaded outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _group_call(kernel, q, kv, bias)
    out.zero_()
    n = _launch_count(kernel)
    graph.replay()
    torch.cuda.synchronize()
    assert _launch_count(kernel) == n  # counted at capture, not at replay
    assert torch.equal(out, eager)


@pytest.mark.cuda
def test_int8_product_on_the_card_is_exact_or_refused(cuda):
    """Exact integer sums past 2^24, also at shapes ``torch._int_mm`` does
    not take (16 rows or fewer; N no multiple of 8), which the wrapper
    zero-pads."""
    rng = np.random.default_rng(12)
    a = torch.from_numpy(rng.integers(100, 128, (32, 1600), dtype=np.int8)).to(cuda)
    b = torch.from_numpy(rng.integers(100, 128, (1600, 24), dtype=np.int8)).to(cuda)
    exact = (a.cpu().long() @ b.cpu().long())
    assert exact.max() > 2 ** 24
    for impl in ("auto", "plain"):
        assert torch.equal(int8_matmul(a, b, impl=impl).cpu(), exact.float())
    assert torch.equal(int8_matmul(a[:16], b).cpu(), exact[:16].float())
    assert torch.equal(int8_matmul(a, b[:, :20]).cpu(), exact[:, :20].float())


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(2, 4096, 4096), (16, 4096, 4096), (2, 200, 100),
                                   (16, 200, 100), (40, 200, 100)])
def test_int8_product_on_the_card_takes_any_shape(cuda, M, K, N):
    """W8A8 at few rows or ragged K, N: ``torch._int_mm`` on zero-padded
    operands, bit for bit the plain product, also through the W8A8 epilogue."""
    rng = np.random.default_rng(22)
    a = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8)).to(cuda)
    q, s = _int8_weight(rng, (K, N), cuda)
    assert torch.equal(int8_matmul(a, q), int8_matmul(a, q, impl="plain"))
    xq, xs = quantize_acts(torch.from_numpy(_normal(rng, M, K)).to(cuda))
    got = quant_apply_w8a8(xq, xs, {"q": q, "s": s}, (N,))
    assert torch.equal(got, quant_apply_w8a8(xq, xs, {"q": q, "s": s}, (N,), impl="plain"))


@pytest.mark.cuda
def test_w8a8_decoder_forward_without_cache_at_few_rows(cuda):
    """A cache-less W8A8 ``decoder_forward`` with B * T = 10 rows and an MLP
    width no multiple of 8 runs on the card and agrees with the plain path
    (the same integer sums; the attention kernel's rounding)."""
    import dataclasses

    from trace_tpu_torch.model.config import DecoderConfig
    from trace_tpu_torch.model.mistral import decoder_forward
    from trace_tpu_torch.model.quantize import quantize_decoder_params
    from trace_tpu_torch.params import _decoder, _Init

    cfg = dataclasses.replace(DecoderConfig.tiny(), hidden_size=256, intermediate_size=100,
                              num_heads=4, num_kv_heads=2, head_dim=64, act_quant=True)
    gen = torch.Generator(device=cuda).manual_seed(23)
    params = quantize_decoder_params(_decoder(cfg, _Init(gen, cuda, torch.bfloat16)))
    B, T = 2, 5
    rng = np.random.default_rng(23)
    x = torch.from_numpy(_normal(rng, B, T, cfg.hidden_size)).to(cuda, torch.bfloat16)
    mask = torch.ones((B, T), dtype=torch.bool, device=cuda)
    pos = torch.arange(T, device=cuda)[None].expand(B, T)
    got, _ = decoder_forward(params, cfg, x, mask, pos)
    want, _ = decoder_forward(params, cfg, x, mask, pos, impl="plain")
    assert got.shape == (B, T, cfg.hidden_size) and torch.isfinite(got).all()
    assert ((got.float() - want.float()).norm() / want.float().norm()).item() <= REL_NORM


@pytest.mark.cuda
def test_int8_wrappers_refuse_what_they_do_not_take(cuda):
    """fp32 x takes the fp32 form (it launches); the other misfits raise."""
    x = torch.zeros((2, 64), device=cuda)
    q = torch.zeros((64, 32), dtype=torch.int8, device=cuda)
    s = torch.ones((32,), dtype=torch.bfloat16, device=cuda)
    before = quant_matmul.launches_f32
    quant_matmul(x, q, s)
    assert quant_matmul.launches_f32 == before + 1
    with pytest.raises(TypeError):  # a bf16 weight
        quant_matmul(x, q.to(torch.bfloat16), s)
    with pytest.raises(ValueError):  # a strided fp32 x
        quant_matmul(torch.zeros((2, 128), device=cuda)[:, ::2], q, s)
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


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["i8", "p4", "p4g"])
def test_split_product_allocates_only_its_output(cuda, form):
    """No workspace: a call's peak allocation is its output, and nothing stays
    allocated but the output (the graph-capture test covers the launch)."""
    K, N = 4096, 6144
    w, s = _split_weight(form, K, N, cuda)
    x = _bf16(np.random.default_rng(35), (2, K), cuda)
    _split_call(form, x, w, s)  # built, loaded and planned
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = _split_call(form, x, w, s)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before == out.untyped_storage().nbytes()
    del out
    assert torch.cuda.memory_allocated() == before


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["i8", "p4", "p4g"])
def test_split_product_f32_allocates_only_its_output(cuda, form):
    """fp32 x up to 8 rows: no workspace either."""
    x, w, s, fn = _f32_split_operands(np.random.default_rng(36), form, 2, 4096, 6144, 32, cuda)
    fn(x, w, s)  # built, loaded and planned
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn(x, w, s)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before == out.untyped_storage().nbytes()
    del out
    assert torch.cuda.memory_allocated() == before


# ---------------------------------------------------------------------------
# The bench's serving path: yuv420 preprocessing on the card, the prefill /
# decode split over an int8 cache, and corpus inference across threads.
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_to_patches_on_the_card_matches_cpu(cuda, dtype):
    """i420_band_to_patches on the card against the same function on the
    CPU, at the serving shape of one 640x360 video's band (T = 16). The
    limits are those of tests/test_torch_yuv.py: fp32 within 2e-6 (a few
    ulps: the card divides by a scalar through its reciprocal); bf16 within
    one step, in at most 1e-3 of the elements."""
    from trace_tpu_torch.video import preprocess as pre

    frames = np.random.default_rng(40).integers(0, 256, (16, 360, 640, 3), dtype=np.uint8)
    band, top, left = pre.host_downscale_band(frames, 336)
    yuv = torch.from_numpy(pre.rgb_to_i420_np(band))
    fill = torch.from_numpy(pre.i420_fill_rgb01(pre.pad_fill_u8()))
    want = pre.i420_band_to_patches(yuv, top, left, fill, 336, 14, dtype).float()
    got = pre.i420_band_to_patches(yuv.to(cuda), top, left, fill.to(cuda), 336, 14, dtype)
    assert got.is_cuda and got.dtype == dtype and got.shape == (16, 576, 588)
    diff = (got.float().cpu() - want).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= 2e-6
    else:
        assert (diff <= 2 ** -7 * want.abs() + 2e-6).all()
        assert (diff != 0).float().mean().item() <= 1e-3


def _int8_model(cuda, layers: int, frames: int):
    """Full-width TRACE-7B at ``layers`` decoder layers (and the full ViT),
    random weights, in the int8 serving configuration."""
    import dataclasses

    from trace_tpu_torch.model.config import TraceConfig
    from trace_tpu_torch.model.quantize import int8_serving
    from trace_tpu_torch.params import init_trace_params

    cfg = TraceConfig()
    cfg = dataclasses.replace(cfg, num_frames=frames, upload_format="yuv420",
                              decoder=dataclasses.replace(cfg.decoder, num_layers=layers))
    params = init_trace_params(cfg, torch.Generator(device=cuda).manual_seed(7))
    return int8_serving(params, cfg)


# generate_split at two full-width int8 layers, kernels against plain. With
# random weights the greedy streams of two computations that differ by
# rounding part at the first near-tie (the smoke records kernel and plain
# streams agreeing for 0 to 13 tokens at 32 layers), and int8 rounding
# amplifies such differences (the largest logit of the two paths differs by
# ~0.2 of the logits' RMS here). So the test steps the kernel path, the plain
# path and an fp32 model of the dequantized weights on the kernel path's
# tokens (teacher forcing) and holds, as chip_smoke.py does: the kernel
# path's logits no further from the fp32 model's than REF_RATIO_TOL x the
# plain path's (over all steps); the greedy token the same as the plain
# path's wherever the plain top-two margin exceeds twice the step's largest
# kernel-plain difference; and generate_split's tokens those of the stepped
# kernel path.
REF_RATIO_TOL = 1.5


def _fp32_decoder(dec: dict) -> dict:
    """A fused int8 decoder tree as dense fp32 weights, q * s exactly."""
    from trace_tpu_torch.model.quantize import is_quantized, unfuse_decoder_serving

    def dense(leaf):
        if is_quantized(leaf):
            q, sc = leaf["q"], leaf["s"]
            if q.ndim == 2:
                return q.float() * sc.float()
            return torch.stack([q[li].float() * sc[li].float() for li in range(q.shape[0])])
        if isinstance(leaf, dict):
            return {k: dense(v) for k, v in leaf.items()}
        return leaf.float()

    return dense(unfuse_decoder_serving(dec))


@pytest.mark.cuda
def test_generate_split_int8_kernels_match_plain(cuda):
    """W8A8 prefill in sub-batches of 2 into one arena, int8 cache,
    weight-only steps, against plain and fp32 (see above); a second call on
    the returned arena repeats the tokens bit for bit."""
    import dataclasses

    from trace_tpu_torch.kernels.decode_attention import decode_attention
    from trace_tpu_torch.model.mistral import compute_logits, decoder_forward, init_kv_cache
    from trace_tpu_torch.model.quantize import fuse_decoder_serving
    from trace_tpu_torch.model.trace_model import combined_embedding
    from trace_tpu_torch.runtime import generate as gen

    params, cfg = _int8_model(cuda, layers=2, frames=4)
    c = cfg.decoder
    table = combined_embedding(params)
    dec = dict(params["decoder"])
    dec.pop("embed")
    dec = fuse_decoder_serving(dec)
    B, P, new, budget = 4, 384, 24, 32
    rng = np.random.default_rng(41)
    prefix = torch.from_numpy(_normal(rng, B, P, c.hidden_size)).to(cuda, torch.bfloat16)
    mask = torch.ones((B, P), dtype=torch.bool, device=cuda)
    mask[1, :40] = False
    kw = dict(prefill_batch=2, max_new_tokens=new, token_budget=budget, eos_id=-5)
    before = decode_attention.launches_int8["s8dot"]
    got = gen.generate_split(dec, c, prefix, mask, table, **kw)
    assert decode_attention.launches_int8["s8dot"] - before == c.num_layers * got.decode_steps
    assert got.decode_steps == new - 1 and (got.tokens[:, new:] == gen.PAD_OUTPUT_ID).all()
    again = gen.generate_split(dec, c, prefix, mask, table, cache=got.cache, **kw)
    assert again.cache is got.cache
    np.testing.assert_array_equal(again.tokens, got.tokens)

    S = P + budget
    fcfg = dataclasses.replace(c, kv_cache_dtype="bf16", act_quant=False)
    paths = {"kernel": (dec, c, "auto", torch.bfloat16),
             "plain": (dec, c, "plain", torch.bfloat16),
             "fp32": (_fp32_decoder(dec), fcfg, "plain", torch.float32)}
    state = {}
    for name, (p, cc, impl, dt) in paths.items():
        cache = init_kv_cache(cc, B, S, dtype=dt, device=cuda)
        cm, last, npos = gen._prefill_into(p, cc, cache, prefix.to(dt), mask, prefill_batch=2,
                                           cache_len=S, impl=impl)
        state[name] = [cache, cm, last]
    heads = torch.full((B,), 1, dtype=torch.long, device=cuda)
    masks = gen.head_mask_table(c, cuda)
    ones = torch.ones((B, 1), dtype=torch.bool, device=cuda)
    sq = {"kernel": 0.0, "plain": 0.0}
    for step in range(new):
        raw = {name: compute_logits(paths[name][0], st[2], impl=paths[name][2])
               for name, st in state.items()}
        for name in sq:
            sq[name] += (raw[name] - raw["fp32"]).square().sum().item()
        diff = (raw["kernel"] - raw["plain"]).abs().max().item()
        tok = (raw["kernel"] + masks[heads]).argmax(-1)
        plain = raw["plain"] + masks[heads]
        top2 = plain.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * diff
        assert (tok == plain.argmax(-1))[clear].all(), step
        np.testing.assert_array_equal(tok.cpu().numpy(), got.tokens[:, step])
        heads = gen.swap_heads(c, heads, tok)
        if step == new - 1:
            break
        slot = P + step
        for name, st in state.items():
            p, cc, impl, dt = paths[name]
            h, _ = decoder_forward(p, cc, table[tok][:, None].to(dt), ones,
                                   (npos + step)[:, None], cache=st[0], cache_index=slot,
                                   cache_mask=st[1], impl=impl)
            st[1][:, slot] = True
            st[2] = h[:, -1]
    assert sq["kernel"] ** 0.5 <= REF_RATIO_TOL * sq["plain"] ** 0.5, sq


@pytest.mark.cuda
def test_streamed_corpus_matches_two_phase_on_the_card(cuda):
    """infer_events_corpus streamed (a decode thread prefills and decodes
    each chunk while the producer threads upload and the calling thread
    encodes the next) against two-phase, at two full-width int8 layers with
    the full W8A8 ViT and 640x360 yuv420 videos: the same tokens, row for
    row, and every path's kernels launched. Run on a side stream, which the
    corpus's threads must follow."""
    from trace_tpu_torch.runtime import generate as gen
    from trace_tpu_torch.runtime.pipeline import TracePipeline
    from trace_tpu_torch.tokenizers.text import SpmLikeTokenizer

    params, cfg = _int8_model(cuda, layers=2, frames=8)
    pipe = TracePipeline(params, cfg, SpmLikeTokenizer())
    rng = np.random.default_rng(42)
    ts = [[float(i)] for i in range(cfg.num_frames)]
    pool = [pipe.prepare_sample_host_np(
        rng.integers(0, 256, (cfg.num_frames, 360, 640, 3), dtype=np.uint8), ts,
        "Localize the visual events in the video and describe each one.") for _ in range(3)]
    assert pool[0].frames_spec[0] == "yuv_band_p"
    tokens = {}
    orig = gen.generate_split

    def keep(*a, **k):
        out = orig(*a, **k)
        tokens.setdefault(run, []).append(out.tokens)
        return out

    gen.generate_split = keep
    try:
        kw = dict(encode_batch=2, decode_batch=4, prefill_batch=2, max_new_tokens=16,
                  token_budget=24)
        side = torch.cuda.Stream()
        for run in ("streamed", "two_phase"):
            with torch.cuda.stream(side):
                pipe.infer_events_corpus(lambda i: pool[i % 3], 12,
                                         streamed=run == "streamed", **kw)
            assert pipe.last_corpus_stats["streamed"] is (run == "streamed")
    finally:
        gen.generate_split = orig
    assert len(tokens["streamed"]) == len(tokens["two_phase"]) == 3
    for a, b in zip(tokens["streamed"], tokens["two_phase"]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Checkpoints on the card: model_init of a small merged checkpoint written
# here (chip_smoke.py's safetensors writer, the released layout's key names
# at small widths), and host quantization against quantization on the card.
# ---------------------------------------------------------------------------

def _small_checkpoint(path, layers=2):
    """A merged TRACE checkpoint of a 256-wide decoder (head_dim 128) and a
    128-wide 2-layer ViT (head_dim 64), the widths the attention kernels
    take: the keys the converters read, bf16, from chip_smoke.py's writer
    and value rule. Returns its config and config.json."""
    import dataclasses
    import json
    from pathlib import Path

    import chip_smoke
    from trace_tpu_torch.model.config import DecoderConfig, TraceConfig, VisionConfig

    dec = dataclasses.replace(DecoderConfig.tiny(), num_layers=layers, num_heads=2,
                              num_kv_heads=1, head_dim=128, hidden_size=256,
                              intermediate_size=256)
    vision = dataclasses.replace(VisionConfig.tiny(), hidden_size=128, intermediate_size=256,
                                 num_layers=2, num_heads=2)
    cfg = TraceConfig(decoder=dec, vision=vision, num_slots=4, num_frames=4,
                      dtype=torch.bfloat16)
    D, I, V, H = dec.hidden_size, dec.intermediate_size, dec.vocab_size, dec.num_heads
    vis, P = cfg.vision, cfg.vision.patch_size
    keys = [("model.embed_tokens.weight", (V, D)), ("model.norm.weight", (D,)),
            ("lm_head.weight", (V, D)), ("sync_head.weight", (1, D)),
            ("time_head.weight", (13, D)), ("score_head.weight", (13, D))]
    for i in range(layers):
        lyr = f"model.layers.{i}."
        keys += [(lyr + "input_layernorm.weight", (D,)),
                 (lyr + "post_attention_layernorm.weight", (D,)),
                 (lyr + "self_attn.q_proj.weight", (H * 128, D)),
                 (lyr + "self_attn.k_proj.weight", (128, D)),
                 (lyr + "self_attn.v_proj.weight", (128, D)),
                 (lyr + "self_attn.o_proj.weight", (D, H * 128)),
                 (lyr + "mlp.gate_proj.weight", (I, D)), (lyr + "mlp.up_proj.weight", (I, D)),
                 (lyr + "mlp.down_proj.weight", (D, I))]
    keys += [("model.mm_projector.slots", (vis.hidden_size, cfg.num_slots)),
             ("model.mm_projector.ln_vision.weight", (vis.hidden_size,)),
             ("model.mm_projector.ln_vision.bias", (vis.hidden_size,)),
             ("model.mm_projector.readout.weight", (D, vis.hidden_size))]
    keys += [(f"model.{t}_tower.embed_tokens.weight", (n, D))
             for t, n in (("time", 13), ("score", 13), ("sync", 1))]
    pre = "model.vision_tower.vision_tower.vision_model."
    Dv, Iv = vis.hidden_size, vis.intermediate_size
    keys += [(pre + "embeddings.class_embedding", (Dv,)),
             (pre + "embeddings.patch_embedding.weight", (Dv, 3, P, P)),
             (pre + "embeddings.position_embedding.weight", (vis.num_patches + 1, Dv)),
             (pre + "pre_layrnorm.weight", (Dv,)), (pre + "pre_layrnorm.bias", (Dv,))]
    for i in range(vis.num_layers):
        lyr = pre + f"encoder.layers.{i}."
        for ln in ("layer_norm1", "layer_norm2"):
            keys += [(lyr + ln + ".weight", (Dv,)), (lyr + ln + ".bias", (Dv,))]
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            keys += [(lyr + f"self_attn.{proj}.weight", (Dv, Dv)),
                     (lyr + f"self_attn.{proj}.bias", (Dv,))]
        keys += [(lyr + "mlp.fc1.weight", (Iv, Dv)), (lyr + "mlp.fc1.bias", (Iv,)),
                 (lyr + "mlp.fc2.weight", (Dv, Iv)), (lyr + "mlp.fc2.bias", (Dv,))]
    chip_smoke.write_checkpoint(torch, Path(path), keys, cfg)
    hf = json.loads((Path(path) / "config.json").read_text())
    return cfg, hf


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["bf16", "int8", "int4p"])
def test_model_init_puts_every_leaf_on_the_card(cuda, tmp_path, monkeypatch, quant):
    """model_init of a checkpoint dir (no device given): every leaf of the
    pipeline's tree and its combined table on the card, and a request from an
    ``.npy`` video gives EventPredictions."""
    from trace_tpu_torch import EventPredictions, infer_events
    from trace_tpu_torch.checkpoint import convert
    from trace_tpu_torch.runtime.pipeline import model_init
    from trace_tpu_torch.tokenizers.text import ByteTokenizer

    cfg, hf = _small_checkpoint(tmp_path / "ckpt")
    assert hf["num_hidden_layers"] == cfg.decoder.num_layers
    orig = convert.trace_config_from_hf
    monkeypatch.setattr(convert, "trace_config_from_hf",  # the checkpoint's small ViT
                        lambda h, **kw: orig(h, **{"vision": cfg.vision, **kw}))
    pipe = model_init(str(tmp_path / "ckpt"), quant=quant, tokenizer=ByteTokenizer())
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        else:
            leaves.append(t)
    walk(pipe.params)
    leaves.append(pipe._combined)
    assert leaves and all(t.is_cuda for t in leaves)
    video = tmp_path / "v.npy"
    np.save(video, np.random.default_rng(0).integers(0, 256, (12, 90, 160, 3), dtype=np.uint8))
    out = infer_events(pipe, str(video), "Find the events.", max_new_tokens=12)
    assert isinstance(out, EventPredictions)
    assert pipe.last_stats["decode_steps"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("bits, pack, group", [(8, False, 128), (4, True, 128), (4, True, 0),
                                               (4, False, 0)])
def test_host_quantization_equals_the_card(cuda, bits, pack, group):
    """quantize_decoder_params on CPU tensors (model_init's host route) and on
    the card (int8_serving's device route): q and s bit for bit."""
    from trace_tpu_torch.model.config import DecoderConfig
    from trace_tpu_torch.model.quantize import quantize_decoder_params
    from trace_tpu_torch.params import _decoder, _Init

    c = DecoderConfig(num_layers=2, hidden_size=512, intermediate_size=1024, num_heads=4,
                      num_kv_heads=2, head_dim=128, vocab_size=1000)
    host = _decoder(c, _Init(torch.Generator().manual_seed(3), "cpu", torch.bfloat16))
    card = {k: ({n: v.cuda() for n, v in t.items()} if isinstance(t, dict) else t.cuda())
            for k, t in host.items()}
    a = quantize_decoder_params(host, bits, pack, group)
    b = quantize_decoder_params(card, bits, pack, group)
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        for part, leaf in a["layers"][name].items():
            other = b["layers"][name][part].cpu()
            view = torch.int16 if leaf.dtype == torch.bfloat16 else leaf.dtype
            assert torch.equal(leaf.view(view), other.view(view)), (name, part)
    for part in ("q", "s"):
        view = torch.int16 if part == "s" else torch.int8
        assert torch.equal(a["lm_head"][part].view(view), b["lm_head"][part].cpu().view(view))


@pytest.mark.cuda
def test_int4_serving_host_quantization_equals_the_card(cuda):
    """``model_init(quant="int4")``'s decoder, quantized on the host by
    ``int4_serving``, against ``quantize_decoder_params(bits=4, pack=True,
    group=0)`` + ``fuse_decoder_serving`` on the card: qp and s bit for bit,
    the int8 ``lm_head`` too."""
    from trace_tpu_torch.model.config import DecoderConfig, TraceConfig
    from trace_tpu_torch.model.quantize import (
        fuse_decoder_serving,
        int4_serving,
        quantize_decoder_params,
    )
    from trace_tpu_torch.params import _decoder, _Init

    c = DecoderConfig(num_layers=2, hidden_size=512, intermediate_size=1024, num_heads=4,
                      num_kv_heads=2, head_dim=128, vocab_size=1000)
    host = _decoder(c, _Init(torch.Generator().manual_seed(5), "cpu", torch.bfloat16))
    card = {k: ({n: v.cuda() for n, v in t.items()} if isinstance(t, dict) else t.cuda())
            for k, t in host.items()}
    got, cfg = int4_serving({"decoder": host, "vision": {}}, TraceConfig.tiny())
    want = fuse_decoder_serving(quantize_decoder_params(card, bits=4, pack=True, group=0))
    assert not cfg.decoder.act_quant and cfg.decoder.kv_cache_dtype == "int8"
    leaves = {**got["decoder"]["layers"], "lm_head": got["decoder"]["lm_head"]}
    assert {"wqkv", "w_gateup", "wo", "w_down"} <= set(leaves)
    for name, leaf in leaves.items():
        if not isinstance(leaf, dict):  # the norms
            continue
        other = want["lm_head"] if name == "lm_head" else want["layers"][name]
        for part, t in leaf.items():
            view = torch.int16 if t.dtype == torch.bfloat16 else t.dtype
            assert torch.equal(t.view(view), other[part].cpu().view(view)), (name, part)


def _collectives_rank(rank: int, port: int) -> None:
    """One of two ranks of a gloo group on one card (NCCL refuses two ranks
    on one device): every operator of parallel/collectives.py on CUDA
    tensors, forward and backward."""
    import torch.distributed as dist

    from trace_tpu_torch.parallel.collectives import (
        copy_to_group,
        gather,
        hop,
        reduce_from_group,
    )

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    group = dist.new_group([0, 1])
    dev = torch.device("cuda", 0)
    base = torch.arange(6, dtype=torch.float32, device=dev).reshape(2, 3)
    k = float(rank + 1)

    x = base.clone().requires_grad_(True)
    (copy_to_group(x, group) * k).sum().backward()  # partial gradients add up
    assert torch.equal(x.grad, torch.full_like(base, 3.0))

    x = base.clone().requires_grad_(True)
    y = reduce_from_group(x * k, group)
    assert torch.equal(y, base * 3.0)
    y.sum().backward()  # the gradient passes as it is
    assert torch.equal(x.grad, torch.full_like(base, k))

    x = (base + 10 * rank).requires_grad_(True)
    y = gather(x, -1, group)
    assert torch.equal(y, torch.cat([base, base + 10], dim=-1))
    w = torch.arange(12, dtype=torch.float32, device=dev).reshape(2, 6)
    (y * w).sum().backward()  # this rank's slice of the whole gradient
    assert torch.equal(x.grad, w[:, 3 * rank:3 * rank + 3])

    got = hop(base * 7 if rank == 0 else None, 0, 1, group, shape=base.shape,
              dtype=base.dtype, device=dev)
    assert torch.equal(got, base * 7)
    torch.cuda.synchronize()
    dist.destroy_process_group()


@pytest.mark.cuda
def test_collectives_on_cuda_tensors_in_a_gloo_group(cuda):
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_collectives_rank, args=(port,), nprocs=2, join=True)


# Head dims other than the kernels' widths 64 and 128 (open_llama_3b's 100;
# 40, 72, 80, 96, 112): the attention rows (1, 2, 8, 9, 10) run at the next
# width on zero-padded copies with the real hd's scale, the decode rows (3,
# 3b) read the stripe in place with rows zero-filled in shared memory. Each
# form against its plain version at the real hd, within the limits above;
# a repeat bit for bit; launches counted per form.
OTHER_HEAD_DIMS = [40, 72, 80, 96, 100, 112]
HD_FLASH_CASES = [  # B, H, Hkv, T, pad, side: G 1, 4 and 7, padded rows
    (1, 4, 4, 129, 5, "right"), (2, 8, 2, 257, 20, "left"), (2, 28, 4, 300, 37, "left")]


def _hd_check(got, want, dtype, atol):
    if dtype == torch.float32:
        _assert_f32(got, want)
    else:
        _assert_matches(got, want, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,T,pad,side", HD_FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", OTHER_HEAD_DIMS)
def test_flash_forward_at_other_head_dims(cuda, hd, dtype, B, H, Hkv, T, pad, side):
    """Rows 1 and 8: o (and lse) on every row, one launch a call, a repeat
    bit for bit."""
    from trace_tpu_torch.kernels import flash_backward as fb

    q, k, v, bias = (x.to(dtype) if x.dtype == torch.bfloat16 else x
                     for x in _flash_inputs(cuda, B, H, Hkv, T, hd, pad, side, seed=hd))
    table = "launches_f32" if dtype == torch.float32 else "launches"
    n = getattr(flash_attention, table)
    got = flash_attention(q, k, v, bias, True)
    torch.cuda.synchronize()
    assert getattr(flash_attention, table) == n + 1
    assert got.shape == q.shape and got.is_contiguous() and torch.isfinite(got).all()
    _hd_check(got, flash_attention(q, k, v, bias, True, impl="plain"), dtype, ATOL["flash"])
    assert torch.equal(got, flash_attention(q, k, v, bias, True))
    o, lse = fb.flash_attention_fwd_res(q, k, v, bias, causal=True)
    o_ref, lse_ref = fb.flash_attention_fwd_res(q, k, v, bias, causal=True, impl="plain")
    _hd_check(o, o_ref, dtype, ATOL["flash"])
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [72, 100])
def test_flash_query_offset_at_other_head_dims(cuda, hd, dtype):
    """A chunk of a chunked prefill over a layer's cache stripe (a strided
    view, copied padded once) at a query offset."""
    from trace_tpu_torch.kernels.flash_attention import NEG_INF

    B, H, Hkv, T, S, offset = 2, 8, 2, 129, 600, 300
    rng = np.random.default_rng(hd)
    q = _bf16(rng, (B, H, T, hd), cuda).to(dtype)
    cache = _bf16(rng, (2, 3, B, Hkv, S, hd), cuda).to(dtype)  # [kv, layer, ...]
    k, v = cache[0, 1], cache[1, 1]
    vis = torch.arange(S, device=cuda)[None, :] < torch.tensor([[offset + T], [offset - 40]],
                                                               device=cuda)
    bias = torch.where(vis, 0.0, NEG_INF).float().contiguous()
    got = flash_attention(q, k, v, bias, True, q_offset=offset)
    want = flash_attention(q, k, v, bias, True, q_offset=offset, impl="plain")
    _hd_check(got, want, dtype, ATOL["flash"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", OTHER_HEAD_DIMS)
def test_vit_attention_at_other_head_dims(cuda, hd, dtype):
    """Row 2 on column slices of a fused QKV, each head padded."""
    B, P, NH, TQ = 2, 150, 4, 141
    rng = np.random.default_rng(hd)
    qkv = _bf16(rng, (B, P, 3 * NH * hd), cuda).to(dtype)
    q, k, v = qkv.split(NH * hd, dim=-1)
    table = "launches_f32" if dtype == torch.float32 else "launches"
    n = getattr(vit_attention_btd, table)
    got = vit_attention_btd(q, k, v, TQ, NH)
    torch.cuda.synchronize()
    assert getattr(vit_attention_btd, table) == n + 1
    assert got.shape == (B, P, NH * hd) and got.is_contiguous()
    _hd_check(got[:, :TQ], vit_attention_btd(q, k, v, TQ, NH, impl="plain")[:, :TQ], dtype,
              ATOL["vit"])
    assert torch.equal(got, vit_attention_btd(q, k, v, TQ, NH))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,T,pad,causal", [(1, 4, 4, 129, 5, True),
                                                   (2, 8, 2, 200, 25, True),
                                                   (2, 28, 4, 130, 9, False)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", OTHER_HEAD_DIMS)
def test_flash_backward_at_other_head_dims(cuda, hd, dtype, B, H, Hkv, T, pad, causal):
    """Rows 9 and 10 from the kernel's own residuals: dq, dk and dv within
    the backward's limits (fp32: the fp32 forms'), one launch each, the
    separate entries equal to the joint call, a repeat bit for bit."""
    from trace_tpu_torch.kernels import flash_backward as fb

    q, k, v, bias, do, _ = _bwd_inputs(cuda, B, H, Hkv, T, T, hd, pad, "right")
    q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
    o, lse = fb.flash_attention_fwd_res(q, k, v, bias, causal=causal)
    table = "launches_f32" if dtype == torch.float32 else "launches"
    counts = [getattr(f, table) for f in (fb.flash_attention_bwd_dq, fb.flash_attention_bwd_dkv)]
    got = fb.flash_attention_bwd(q, k, v, bias, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert [getattr(f, table) for f in (fb.flash_attention_bwd_dq,
                                        fb.flash_attention_bwd_dkv)] == [c + 1 for c in counts]
    want = fb.flash_attention_bwd(q, k, v, bias, o, lse, do, causal=causal, impl="plain")
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape and g.is_contiguous() and torch.isfinite(g).all(), name
        if dtype == torch.float32:
            _assert_f32(g, w, unit=True)
        else:
            _assert_grad_matches(g, w, name)
    delta = fb.flash_attention_bwd_delta(o, do)
    args = (q, k, v, bias, do, lse, delta)
    parts = (fb.flash_attention_bwd_dq(*args, causal=causal),) + fb.flash_attention_bwd_dkv(
        *args, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(parts, got))
    again = fb.flash_attention_bwd(q, k, v, bias, o, lse, do, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _hd_stripe(cuda, kernel, B, NKV, G, S, hd, seed):
    """q [B, NKV * G, 1, hd] and layer 1's stripe of a 2-layer cache (a view
    read in place), bf16, fp32 or int8."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    dtype = torch.float32 if kernel.endswith("f32") else torch.bfloat16
    q = torch.randn((B, NKV * G, 1, hd), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((2, B, NKV, S, hd), generator=gen, device=cuda) for _ in range(2))
    if kernel in ("bf16", "f32"):
        return q, (k.to(dtype)[1], v.to(dtype)[1])
    from trace_tpu_torch.model.mistral import _quantize_kv

    stripe = {}
    for vals, scales, x in (("kq", "ks", k), ("vq", "vs", v)):
        layers = [_quantize_kv(x[li].to(torch.bfloat16)) for li in range(2)]
        stripe[vals] = torch.stack([t for t, _ in layers])[1]
        stripe[scales] = torch.stack([s.contiguous() for _, s in layers])[1]
    return q, (stripe, None)


def _hd_bias(rng, B, S):
    """Half the slots masked at random; row 1 sees no slot, row 2 one."""
    vis = torch.from_numpy(rng.random((B, S)) < 0.5)
    vis[1] = False
    vis[2] = False
    vis[2, S // 3] = True
    return torch.where(vis, 0.0, -1e30).float()


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 4, 7])
@pytest.mark.parametrize("kernel", DECODE_KERNELS)
@pytest.mark.parametrize("hd", OTHER_HEAD_DIMS)
def test_decode_rows_at_other_head_dims(cuda, hd, kernel, G):
    """Rows 3 and 3b (both bodies), bf16 and fp32, over a stripe read in
    place: one launch a group split (hd <= 64: 4, 2, 1 rows), the limits of
    the hd-128 forms, a repeat bit for bit."""
    from trace_tpu_torch.kernels.decode_attention import group_splits

    B, NKV, S = 3, 2, 333
    q, kv = _hd_stripe(cuda, kernel, B, NKV, G, S, hd, seed=hd + G)
    bias = _hd_bias(np.random.default_rng(hd + G), B, S).to(cuda)
    n = _launch_count(kernel)
    got = _group_call(kernel, q, kv, bias)
    torch.cuda.synchronize()
    assert _launch_count(kernel) == n + len(group_splits(G, hd))
    assert got.shape == q.shape and torch.isfinite(got).all()
    want = _group_call(kernel, q, kv, bias, impl="plain")
    if kernel.endswith("f32"):
        _assert_f32(got, want, atol=2e-3 if kernel == "dequant_f32" else F32_ATOL)
    else:
        _assert_matches(got, want, ATOL["decode"])
    assert torch.equal(got, _group_call(kernel, q, kv, bias))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", DECODE_KERNELS)
def test_hd100_decode_step_allocates_only_its_output_and_replays_in_a_graph(cuda, kernel):
    """open_llama_3b's decode attention (32 / 32 heads, hd 100) at B = 4,
    S = 2304, serving masks: one launch, no allocation beside the output (no
    copy of the stripe), and the call captured in a CUDA graph replays equal
    to the eager call. (Which kernels ran is read from the launch count: a
    profiler session after this file's graph captures sees no kernel.)"""
    q, kv = _hd_stripe(cuda, kernel, 4, 32, 1, 2304, 100, seed=80)
    bias = _edge_bias(np.random.default_rng(80), "serving", 4, 2304).to(cuda)
    n = _launch_count(kernel)
    eager = _group_call(kernel, q, kv, bias)  # built and loaded outside the capture
    torch.cuda.synchronize()
    assert _launch_count(kernel) == n + 1
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = _group_call(kernel, q, kv, bias)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before == out.untyped_storage().nbytes()
    assert torch.equal(out, eager)
    del out
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _group_call(kernel, q, kv, bias)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.cuda
def test_head_dims_past_the_kernels_limits_raise(cuda):
    """Each wrapper past its own limit, and hd 102 (no multiple of 4) in the
    decode rows: a ValueError that names the limit, no launch, no plain
    route. The bf16 forward (rows 1, 2, 8), the bf16 backward (rows 9-10,
    also at a training step's forward, before it runs) and the bf16-query
    decode (rows 3, 3b) stop at 256; every fp32 form at 128."""
    from trace_tpu_torch.kernels import flash_backward as fb
    from trace_tpu_torch.kernels.flash_attention import flash_attention_trainable

    for hd, dtype, limit in ((257, torch.bfloat16, 256), (264, torch.bfloat16, 256),
                             (136, torch.float32, 128), (256, torch.float32, 128)):
        q = torch.zeros((1, 2, 64, hd), dtype=dtype, device=cuda)
        launches = flash_attention.launches + flash_attention.launches_f32
        for call in (lambda: flash_attention(q, q, q, None, True),
                     lambda: fb.flash_attention_fwd_res(q, q, q, None, causal=True),
                     lambda: vit_attention_btd(q[0], q[0], q[0], 64, 1)):
            with pytest.raises(ValueError, match=f"take 1 ... {limit}"):
                call()
        assert flash_attention.launches + flash_attention.launches_f32 == launches
    for hd, dtype, limit in ((136, torch.float32, 128), (256, torch.float32, 128),
                             (257, torch.bfloat16, 256), (264, torch.bfloat16, 256)):
        q = torch.zeros((1, 2, 64, hd), dtype=dtype, device=cuda)
        rows = torch.zeros((1, 2, 64, 1), device=cuda)
        with pytest.raises(ValueError, match=f"backward kernels .* take 1 ... {limit}"):
            fb.flash_attention_bwd(q, q, q, None, q, rows, q, causal=True)
        with pytest.raises(ValueError, match=f"backward kernels .* take 1 ... {limit}"):
            fb.flash_attention_bwd_delta(q, q)
        n = fb.flash_attention_fwd_res.launches + fb.flash_attention_fwd_res.launches_f32
        leaf = q.clone().requires_grad_(True)
        with pytest.raises(ValueError, match=f"backward kernels .* take 1 ... {limit}"):
            flash_attention_trainable(leaf, q, q, None, True)
        assert fb.flash_attention_fwd_res.launches + \
            fb.flash_attention_fwd_res.launches_f32 == n
    for hd in (260, 102):
        for kernel in ("bf16", "s8dot", "dequant"):
            q, kv = _hd_stripe(cuda, kernel, 1, 2, 1, 64, hd, seed=hd)
            with pytest.raises(ValueError, match="up to 256" if hd > 256 else "multiples of 4"):
                _group_call(kernel, q, kv, torch.zeros((1, 64), device=cuda))
    for hd in (136, 256, 102):
        for kernel in ("f32", "s8dot_f32", "dequant_f32"):
            q, kv = _hd_stripe(cuda, kernel, 1, 2, 1, 64, hd, seed=hd)
            with pytest.raises(ValueError, match="fp32-query .* up to 128"):
                _group_call(kernel, q, kv, torch.zeros((1, 64), device=cuda))


# Head dims above 128 (Falcon3's 256; 132, 160, 192, 252 on padded copies):
# the bf16 forward (rows 1, 2, 8) at its width-256 instance (64-key tiles,
# P V as wgmma m64n256k16), the operands zero-padded to 256 below it; the
# bf16-query decode rows (3, 3b) at their width-256 instances, the stripe
# read in place. Each against its plain version at the real hd within the
# limits above, one launch a call, a repeat bit for bit.
WIDE_HEAD_DIMS = [256, 132, 160, 192, 252]
WIDE_FLASH_CASES = [  # B, H, Hkv, T, pad, side: G 1, 3, 4 and 8, the tile edges
    (1, 3, 3, 65, 5, "right"),     # G = 1, a second 64-key tile holding one key
    (2, 12, 4, 300, 37, "left"),   # Falcon3's 12 / 4 heads, left-padded rows
    (2, 8, 2, 129, 0, "left"),     # G = 4, a second query tile holding one row
    (1, 8, 1, 257, 20, "right"),   # G = 8
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,T,pad,side", WIDE_FLASH_CASES)
@pytest.mark.parametrize("hd", WIDE_HEAD_DIMS)
def test_flash_forward_at_wide_head_dims(cuda, hd, B, H, Hkv, T, pad, side):
    """Rows 1 and 8 at hd 129-256: o on every row (left-padded rows see no
    key and get the mean of v) and lse, one launch a call, a repeat bit for
    bit."""
    from trace_tpu_torch.kernels import flash_backward as fb

    q, k, v, bias = _flash_inputs(cuda, B, H, Hkv, T, hd, pad, side, seed=hd + T)
    n = flash_attention.launches
    got = flash_attention(q, k, v, bias, True)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    assert got.shape == q.shape and got.is_contiguous() and torch.isfinite(got).all()
    _assert_matches(got, flash_attention(q, k, v, bias, True, impl="plain"), ATOL["flash"])
    assert torch.equal(got, flash_attention(q, k, v, bias, True))
    n = fb.flash_attention_fwd_res.launches
    o, lse = fb.flash_attention_fwd_res(q, k, v, bias, causal=True)
    assert fb.flash_attention_fwd_res.launches == n + 1
    o_ref, lse_ref = fb.flash_attention_fwd_res(q, k, v, bias, causal=True, impl="plain")
    _assert_matches(o, o_ref, ATOL["flash"])
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    assert torch.equal(o, got)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,masked", [(True, (0, 300)), (False, (0, 300)),
                                           (True, (0, 70))])
@pytest.mark.parametrize("hd", [256, 192])
def test_flash_rows_that_see_no_key_at_wide_head_dims(cuda, hd, causal, masked):
    """Rows 1 at hd 256 and 192, Falcon3's heads: wholly masked rows (and,
    causal, rows past one 64-key tile of left padding) get the mean of v."""
    B, H, Hkv, T = 2, 12, 4, 300
    q, k, v, _ = _flash_inputs(cuda, B, H, Hkv, T, hd, 0, "left", seed=hd)
    bias = torch.zeros((B, T), device=cuda)
    bias[0, masked[0]:masked[1]] = -1e30
    got = flash_attention(q, k, v, bias, causal)
    _assert_matches(got, flash_attention(q, k, v, bias, causal, impl="plain"), ATOL["flash"])
    unseen = masked[1] if causal or masked[1] == T else 0
    mean = v[0].float().mean(dim=1).repeat_interleave(H // Hkv, dim=0)
    rows = got[0, :, :unseen].float()
    torch.testing.assert_close(rows, mean[:, None].expand_as(rows), atol=1e-6, rtol=2 ** -8)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [256, 192])
def test_flash_query_offset_at_wide_head_dims(cuda, hd):
    """A chunk of a chunked prefill over a layer's cache stripe (a strided
    view; at 256 read in place, at 192 copied padded once) at a query
    offset, and the chunk's two ``flash_attention_fwd_res`` parts merged by
    their lse against the one call."""
    from trace_tpu_torch.kernels.flash_attention import NEG_INF
    from trace_tpu_torch.kernels.flash_backward import flash_attention_fwd_res, merge_attention

    B, H, Hkv, T, S, offset = 2, 12, 4, 129, 600, 300
    rng = np.random.default_rng(hd)
    q = _bf16(rng, (B, H, T, hd), cuda)
    cache = _bf16(rng, (2, 3, B, Hkv, S, hd), cuda)  # [kv, layer, ...]
    k, v = cache[0, 1], cache[1, 1]
    vis = torch.arange(S, device=cuda)[None, :] < torch.tensor([[offset + T], [offset - 40]],
                                                               device=cuda)
    bias = torch.where(vis, 0.0, NEG_INF).float().contiguous()
    got = flash_attention(q, k, v, bias, True, q_offset=offset)
    want = flash_attention(q, k, v, bias, True, q_offset=offset, impl="plain")
    _assert_matches(got, want, ATOL["flash"])
    old = (torch.arange(S, device=cuda) < offset)[None, :]
    parts = [flash_attention_fwd_res(q, k, v, torch.where(sel & vis, 0.0, NEG_INF).float()
                                     .contiguous(), causal=True, q_offset=offset)
             for sel in (old, ~old)]
    merged = merge_attention(*parts[0], *parts[1], torch.bfloat16)
    _assert_matches(merged, want, ATOL["flash"])


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [256, 160])
def test_vit_attention_at_wide_head_dims(cuda, hd):
    """Row 2 through the width-256 instance: column slices of a fused QKV,
    read in place at 256 (a 3-D map over 256-column heads), padded at 160."""
    B, P, NH, TQ = 2, 150, 4, 141
    rng = np.random.default_rng(hd)
    q, k, v = _bf16(rng, (B, P, 3 * NH * hd), cuda).split(NH * hd, dim=-1)
    n = vit_attention_btd.launches
    got = vit_attention_btd(q, k, v, TQ, NH)
    torch.cuda.synchronize()
    assert vit_attention_btd.launches == n + 1
    _assert_matches(got[:, :TQ], vit_attention_btd(q, k, v, TQ, NH, impl="plain")[:, :TQ],
                    ATOL["vit"])
    assert torch.equal(got, vit_attention_btd(q, k, v, TQ, NH))


# Rows 9 and 10 at hd 129-256: csrc/attention_bwd_256.cu (dq over 32-key
# tiles; dk / dv in blocks of 64 keys whose two consumer warpgroups own half
# of the columns each), the operands zero-padded to 256 below it.
WIDE_BWD_CASES = [  # B, H, Hkv, Tq, Tk, pad, side, causal: G 1, 3, 4 and 8, the tile edges
    (1, 3, 3, 65, 65, 5, "right", True),      # G = 1, a second 64-key block holding one key
    (2, 12, 4, 300, 300, 37, "left", True),   # Falcon3's heads; rows that see no key, do = 0
    (2, 8, 2, 129, 129, 0, "left", False),    # G = 4, a second 128-row dq block holding one row
    (1, 8, 1, 257, 257, 20, "right", False),  # G = 8
    (1, 6, 2, 200, 97, 25, "right", True),    # Tq > Tk: rows past Tk see every key
    (2, 6, 2, 97, 200, 25, "left", False),    # Tq < Tk, left padding, bidirectional
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,Tq,Tk,pad,side,causal", WIDE_BWD_CASES)
@pytest.mark.parametrize("hd", WIDE_HEAD_DIMS)
def test_flash_backward_at_wide_head_dims(cuda, hd, B, H, Hkv, Tq, Tk, pad, side, causal):
    """Rows 9 and 10 from the kernel's own residuals at hd 129-256: dq, dk
    and dv within the backward's limits, one launch each, the separate
    entries equal to the joint call, a repeat bit for bit."""
    from trace_tpu_torch.kernels import flash_backward as fb

    q, k, v, bias, do, _ = _bwd_inputs(cuda, B, H, Hkv, Tq, Tk, hd, pad, side)
    o, lse = fb.flash_attention_fwd_res(q, k, v, bias, causal=causal)
    counts = [f.launches for f in (fb.flash_attention_bwd_dq, fb.flash_attention_bwd_dkv)]
    got = fb.flash_attention_bwd(q, k, v, bias, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert [f.launches for f in (fb.flash_attention_bwd_dq,
                                 fb.flash_attention_bwd_dkv)] == [c + 1 for c in counts]
    want = fb.flash_attention_bwd(q, k, v, bias, o, lse, do, causal=causal, impl="plain")
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape and g.is_contiguous() and torch.isfinite(g).all(), name
        _assert_grad_matches(g, w, name)
    delta = fb.flash_attention_bwd_delta(o, do)
    args = (q, k, v, bias, do, lse, delta)
    parts = (fb.flash_attention_bwd_dq(*args, causal=causal),) + fb.flash_attention_bwd_dkv(
        *args, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(parts, got))
    again = fb.flash_attention_bwd(q, k, v, bias, o, lse, do, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_hd256_backward_allocates_only_its_outputs(cuda):
    """Falcon3's backward at hd 256 (12 / 4 heads, T = 1000, causal): the dq
    and dk/dv wrappers launch once each and allocate nothing beside their
    outputs (no copy at the tile width), and ``flash_attention_trainable``
    under autograd gives the gradients of the plain attention."""
    from trace_tpu_torch.kernels import flash_backward as fb
    from trace_tpu_torch.kernels.flash_attention import flash_attention_trainable, xla_attention

    q, k, v, bias, do, _ = _bwd_inputs(cuda, 2, 12, 4, 1000, 1000, 256, 100, "right")
    o, lse = fb.flash_attention_fwd_res(q, k, v, bias, causal=True)
    delta = fb.flash_attention_bwd_delta(o, do)
    args = (q, k, v, bias, do, lse, delta)
    # allocations and the bytes asked for (a multi-MB output may take a
    # larger block the caching allocator holds, so its block size says less)
    counted = ("allocation.all.allocated", "requested_bytes.all.allocated")
    for fn in (fb.flash_attention_bwd_dq, fb.flash_attention_bwd_dkv):
        fn(*args, causal=True)  # built and loaded before the count
        torch.cuda.synchronize()
        n, before = fn.launches, torch.cuda.memory_stats()
        out = fn(*args, causal=True)
        torch.cuda.synchronize()
        after = torch.cuda.memory_stats()
        outs = out if isinstance(out, tuple) else (out,)
        assert fn.launches == n + 1
        assert [after[c] - before[c] for c in counted] == [
            len(outs), sum(x.untyped_storage().nbytes() for x in outs)]
        del out, outs
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    flash_attention_trainable(*leaves, bias, True).backward(do)
    refs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    xla_attention(*refs, bias, causal=True).backward(do)
    for a, b, name in zip(leaves, refs, ("dq", "dk", "dv")):
        _assert_grad_matches(a.grad, b.grad, name)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 3, 4, 8])
@pytest.mark.parametrize("kernel", ["bf16", "s8dot", "dequant"])
@pytest.mark.parametrize("hd", WIDE_HEAD_DIMS)
def test_decode_rows_at_wide_head_dims(cuda, hd, kernel, G):
    """Rows 3 and 3b (both bodies) at hd 129-256 over a stripe read in
    place, rows that see no slot or one: one launch a call, the limits of
    the hd-128 forms, a repeat bit for bit."""
    B, NKV, S = 3, 2, 333
    q, kv = _hd_stripe(cuda, kernel, B, NKV, G, S, hd, seed=hd + G)
    bias = _hd_bias(np.random.default_rng(hd + G), B, S).to(cuda)
    n = _launch_count(kernel)
    got = _group_call(kernel, q, kv, bias)
    torch.cuda.synchronize()
    assert _launch_count(kernel) == n + 1
    assert got.shape == q.shape and torch.isfinite(got).all()
    _assert_matches(got, _group_call(kernel, q, kv, bias, impl="plain"), ATOL["decode"])
    assert torch.equal(got, _group_call(kernel, q, kv, bias))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["serving", "one_visible", "all_visible"])
@pytest.mark.parametrize("kernel", ["bf16", "s8dot", "dequant"])
def test_decode_rows_at_hd256_on_edge_masks_and_a_long_row(cuda, kernel, kind):
    """Falcon3's decode (12 / 4 heads, G = 3) at hd 256 over serving and
    edge masks at S = 1100, and at B = 32 over a 4096-slot arena (eight
    blocks a row, then four blocks an SM)."""
    for B, S in ((3, 1100), (32, 4096)):
        q, kv = _hd_stripe(cuda, kernel, B, 4, 3, S, 256, seed=S)
        bias = _edge_bias(np.random.default_rng(S), kind, B, S).to(cuda)
        got = _group_call(kernel, q, kv, bias)
        _assert_matches(got, _group_call(kernel, q, kv, bias, impl="plain"), ATOL["decode"])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["bf16", "s8dot", "dequant"])
def test_hd256_decode_step_allocates_only_its_output_and_replays_in_a_graph(cuda, kernel):
    """Falcon3's decode attention (12 / 4 heads, hd 256) at B = 4, S = 2304,
    serving masks: one launch, no allocation beside the output, and the call
    captured in a CUDA graph replays equal to the eager call."""
    q, kv = _hd_stripe(cuda, kernel, 4, 4, 3, 2304, 256, seed=81)
    bias = _edge_bias(np.random.default_rng(81), "serving", 4, 2304).to(cuda)
    n = _launch_count(kernel)
    eager = _group_call(kernel, q, kv, bias)
    torch.cuda.synchronize()
    assert _launch_count(kernel) == n + 1
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = _group_call(kernel, q, kv, bias)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before == out.untyped_storage().nbytes()
    assert torch.equal(out, eager)
    del out
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _group_call(kernel, q, kv, bias)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
