"""The port's int8 and nibble-packed int4 weight products (plain versions,
which the CPU runs) against the JAX package's Pallas kernels in interpret
mode, and the W8A8 / W4A8 product against the JAX package's.

Tolerances:
- weight-only product, fp32 ``x``: both sides sum the same exact products
  (fp32 x int8) in fp32, in another order (the Pallas kernel in K tiles of
  ``bk``): 2e-5 of the largest output, absolute and relative.
- weight-only product, bf16 ``x``: as above, then a bf16 output may round
  to the neighbouring value: two bf16 steps (2^-7) relative.
- packed int4 products: as the int8 ones (nibbles are exact in either dtype;
  grouped, both sides round ``nibble * s`` to x's dtype, an exact fp32
  product rounded once, before the same fp32-sum product). With bf16 x the
  Pallas kernel in interpret mode rounds nothing else, so the limits are
  the int8 product's.
- ``quantize_acts``: elementwise IEEE operations and a max: exact.
- W8A8: the integer sum is exact; the fp32 epilogue ``(acc * xs) * s`` is
  elementwise in the same order: 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trace_tpu.kernels import quant_matmul as jqmm
from trace_tpu_torch.kernels import quant_matmul as tqmm

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _weight(rng, *shape):
    """int8 values and a bf16 per-column scale (reduced axis kept as 1)."""
    q = rng.integers(-127, 128, shape, dtype=np.int8)
    s = (rng.random(shape[:-2] + (1, shape[-1])) * 4e-3 + 1e-3).astype(np.float32)
    return q, s


def _to_torch(a, dtype=None):
    t = torch.from_numpy(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _assert_close(got, want, x_dtype, out_dtype):
    got, want = _f32(got), _f32(want)
    unit = np.abs(want).max()
    rtol = 2 ** -7 if "bfloat16" in (x_dtype, out_dtype) else 2e-5
    np.testing.assert_allclose(got / unit, want / unit, rtol=rtol, atol=2e-5)


@pytest.mark.parametrize("x_dtype,out_dtype", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                               ("bfloat16", "float32"), ("float32", "bfloat16")])
# M = 32: the bench's decode batch, the card kernel's wide tile
@pytest.mark.parametrize("M,K,N", [(2, 128, 256), (5, 200, 130), (37, 96, 72), (32, 160, 136)])
def test_quant_matmul_plain_matches_pallas(M, K, N, x_dtype, out_dtype):
    rng = np.random.default_rng(M + K)
    x = rng.standard_normal((M, K)).astype(np.float32)
    q, s = _weight(rng, K, N)
    want = jqmm.quant_matmul(
        jnp.asarray(x).astype(JDT[x_dtype]), jnp.asarray(q),
        jnp.asarray(s).astype(jnp.bfloat16), out_dtype=JDT[out_dtype],
        bm=64, bn=128, bk=128, interpret=True)
    got = tqmm.quant_matmul(
        _to_torch(x, TDT[x_dtype]), _to_torch(q), _to_torch(s, torch.bfloat16),
        out_dtype=TDT[out_dtype])
    assert got.dtype == TDT[out_dtype] and tuple(got.shape) == (M, N)
    _assert_close(got, want, x_dtype, out_dtype)


@pytest.mark.parametrize("li", [0, 1, 2])
@pytest.mark.parametrize("x_dtype,out_dtype", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                               ("bfloat16", "float32")])
def test_quant_matmul_stacked_plain_matches_pallas(li, x_dtype, out_dtype):
    L, M, K, N = 3, 3, 200, 136
    rng = np.random.default_rng(10 + li)
    x = rng.standard_normal((M, K)).astype(np.float32)
    q, s = _weight(rng, L, K, N)
    want = jqmm.quant_matmul_stacked(
        jnp.asarray(x).astype(JDT[x_dtype]), jnp.asarray(q),
        jnp.asarray(s).astype(jnp.bfloat16).reshape(L, N), jnp.int32(li),
        out_dtype=JDT[out_dtype], bn=128, bk=128, interpret=True)
    got = tqmm.quant_matmul_stacked(
        _to_torch(x, TDT[x_dtype]), _to_torch(q), _to_torch(s, torch.bfloat16), li,
        out_dtype=TDT[out_dtype])
    assert got.dtype == TDT[out_dtype]
    _assert_close(got, want, x_dtype, out_dtype)
    # the stacked call reads exactly the layer a slice would
    per_layer = tqmm.quant_matmul(
        _to_torch(x, TDT[x_dtype]), _to_torch(q)[li], _to_torch(s, torch.bfloat16)[li],
        out_dtype=TDT[out_dtype])
    torch.testing.assert_close(got, per_layer, atol=0, rtol=0)


def test_quant_apply_and_stacked_reshape_like_jax():
    """Multi-dimensional outputs ([NH, hd]) and a strided x (the last
    position of a step) through the leaf-level wrappers."""
    L, B, T, D, NH, HD = 2, 2, 3, 64, 4, 16
    rng = np.random.default_rng(20)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    q, s = _weight(rng, L, D, NH * HD)
    q, s = q.reshape(L, D, NH, HD), s.reshape(L, 1, NH, HD)
    jleaf = {"q": jnp.asarray(q), "s": jnp.asarray(s).astype(jnp.bfloat16)}
    tleaf = {"q": _to_torch(q), "s": _to_torch(s, torch.bfloat16)}
    last = _to_torch(x)[:, -1]  # [B, D], not contiguous
    assert not last.is_contiguous()
    want = jqmm.quant_apply_stacked(jnp.asarray(x)[:, -1], jleaf, jnp.int32(1), (NH, HD),
                                    interpret=True)
    got = tqmm.quant_apply_stacked(last, tleaf, 1, (NH, HD))
    assert tuple(got.shape) == (B, NH, HD)
    _assert_close(got, want, "float32", "float32")
    one = lambda leaf: {"q": leaf["q"][0], "s": leaf["s"][0]}
    want = jqmm.quant_apply(jnp.asarray(x), one(jleaf), (NH, HD), out_dtype=jnp.float32)
    got = tqmm.quant_apply(_to_torch(x), one(tleaf), (NH, HD), out_dtype=torch.float32)
    assert tuple(got.shape) == (B, T, NH, HD)
    _assert_close(got, want, "float32", "float32")


@pytest.mark.parametrize("x_dtype,out_dtype", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                               ("bfloat16", "float32")])
def test_quant_apply_dense_weight_matches_jax(x_dtype, out_dtype):
    """The plain-array branch: one product with an fp32 sum, rounded once."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 3, 8)) * 0.1).astype(np.float32)
    want = jqmm.quant_apply(jnp.asarray(x).astype(JDT[x_dtype]),
                            jnp.asarray(w).astype(JDT[x_dtype]), (3, 8),
                            out_dtype=JDT[out_dtype])
    got = tqmm.quant_apply(_to_torch(x, TDT[x_dtype]), _to_torch(w, TDT[x_dtype]), (3, 8),
                           out_dtype=TDT[out_dtype])
    assert got.dtype == TDT[out_dtype] and tuple(got.shape) == (2, 5, 3, 8)
    _assert_close(got, want, x_dtype, out_dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_acts_is_exact(dtype):
    rng = np.random.default_rng(22)
    x = (rng.standard_normal((3, 7, 96)) * 3).astype(np.float32)
    x[1, 2] = 0.0  # an all-zero token takes the 1e-8 floor
    jq, js = jqmm.quantize_acts(jnp.asarray(x).astype(JDT[dtype]))
    tq, ts = tqmm.quantize_acts(_to_torch(x, TDT[dtype]))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == (3, 7, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("N", [100, 4096])
@pytest.mark.parametrize("K", [200, 4100])
@pytest.mark.parametrize("M", [1, 2, 16, 17])
def test_int8_operands_padded_for_int_mm_keep_the_product(M, K, N):
    """The zero padding that lets ``torch._int_mm`` take any shape on the
    card (more than 16 rows, K and N multiples of 8) leaves the integer
    product, sliced back to [M, N], bit for bit what it was."""
    rng = np.random.default_rng(M * 7 + K + N)
    a = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8))
    ap, bp = tqmm.pad_for_int_mm(a, b)
    assert ap.shape[0] > 16 and ap.shape[1] % 8 == 0 and bp.shape[1] % 8 == 0
    assert ap.shape[1] == bp.shape[0] and ap.dtype == bp.dtype == torch.int8
    got = (ap.to(torch.int32) @ bp.to(torch.int32))[:M, :N]
    assert torch.equal(got, a.to(torch.int32) @ b.to(torch.int32))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_quant_apply_w8a8_matches_jax(out_dtype):
    rng = np.random.default_rng(23)
    B, T, K, N = 2, 9, 1600, 40  # sums pass 2^24: they must be taken in integers
    x = (rng.random((B, T, K)) * 0.2 + 1.8).astype(np.float32)  # same sign, near the max
    q = rng.integers(100, 128, (K, N), dtype=np.int8)  # large same-sign weights
    s = (rng.random((1, N)) * 4e-3 + 1e-3).astype(np.float32)
    jxq, jxs = jqmm.quantize_acts(jnp.asarray(x))
    txq, txs = tqmm.quantize_acts(_to_torch(x))
    # the integer sums themselves, against int64 numpy
    acc = tqmm.int8_matmul(txq.reshape(-1, K), _to_torch(q))
    exact = np.asarray(jxq, np.int64).reshape(-1, K) @ q.astype(np.int64)
    assert np.abs(exact).max() > 2 ** 24
    np.testing.assert_array_equal(acc.numpy(), exact.astype(np.float32))
    want = jqmm.quant_apply_w8a8(
        jxq, jxs, {"q": jnp.asarray(q), "s": jnp.asarray(s).astype(jnp.bfloat16)}, (N,),
        out_dtype=JDT[out_dtype])
    got = tqmm.quant_apply_w8a8(
        txq, txs, {"q": _to_torch(q), "s": _to_torch(s, torch.bfloat16)}, (N,),
        out_dtype=TDT[out_dtype])
    assert got.dtype == TDT[out_dtype] and tuple(got.shape) == (B, T, N)
    if out_dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6, atol=0)
    else:  # the same fp32 value rounded to bf16 on both sides
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=2 ** -7, atol=0)


def _packed(rng, *shape, groups=1):
    """Random packed bytes (every nibble value, -8 too) [.., K/2, N] and bf16
    scales [.., groups, N] that differ by up to 5x between groups."""
    qp = rng.integers(-128, 128, shape, dtype=np.int8)
    s = (rng.random(shape[:-2] + (groups, shape[-1])) * 4e-3 + 1e-3).astype(np.float32)
    return qp, s


@pytest.mark.parametrize("x_dtype,out_dtype", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                               ("bfloat16", "float32"), ("float32", "bfloat16")])
# M = 65 and 129: one row past the card kernel's 64- and 128-row tiles
@pytest.mark.parametrize("M,K,N", [(2, 128, 256), (10, 64, 48), (37, 200, 130),
                                   (65, 64, 32), (129, 64, 16)])
def test_quant_matmul_p4_plain_matches_pallas(M, K, N, x_dtype, out_dtype):
    rng = np.random.default_rng(M + K)
    x = rng.standard_normal((M, K)).astype(np.float32)
    qp, s = _packed(rng, K // 2, N)
    want = jqmm.quant_matmul_p4(
        jnp.asarray(x).astype(JDT[x_dtype]), jnp.asarray(qp),
        jnp.asarray(s[0]).astype(jnp.bfloat16), out_dtype=JDT[out_dtype],
        bm=8, bn=16, bk=16, interpret=True)
    got = tqmm.quant_matmul_p4(
        _to_torch(x, TDT[x_dtype]), _to_torch(qp), _to_torch(s[0], torch.bfloat16),
        out_dtype=TDT[out_dtype])
    assert got.dtype == TDT[out_dtype] and tuple(got.shape) == (M, N)
    _assert_close(got, want, x_dtype, out_dtype)


@pytest.mark.parametrize("x_dtype,out_dtype", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                               ("bfloat16", "float32")])
@pytest.mark.parametrize("M,K,N", [(2, 256, 96), (10, 512, 96), (37, 1024, 40),
                                   (65, 256, 32), (129, 256, 32)])
def test_quant_matmul_p4_grouped_plain_matches_pallas(M, K, N, x_dtype, out_dtype):
    rng = np.random.default_rng(M + K + 1)
    x = rng.standard_normal((M, K)).astype(np.float32)
    qp, s = _packed(rng, K // 2, N, groups=K // 128)
    want = jqmm.quant_matmul_p4_grouped(
        jnp.asarray(x).astype(JDT[x_dtype]), jnp.asarray(qp),
        jnp.asarray(s).astype(jnp.bfloat16), out_dtype=JDT[out_dtype],
        bm=8, bn=32, bk=128, interpret=True)
    got = tqmm.quant_matmul_p4_grouped(
        _to_torch(x, TDT[x_dtype]), _to_torch(qp), _to_torch(s, torch.bfloat16),
        out_dtype=TDT[out_dtype])
    assert got.dtype == TDT[out_dtype] and tuple(got.shape) == (M, N)
    _assert_close(got, want, x_dtype, out_dtype)


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_quant_apply_packed_matches_jax_cpu_route(groups, x_dtype):
    """``quant_apply`` on a packed leaf, multi-dimensional output and lead
    axes, against the plain route the JAX package's ``quant_apply`` takes on
    the CPU; and the stacked wrapper against the 2-D one on the layer's slice."""
    L, B, T, K, NH, HD = 3, 2, 3, 512, 4, 16
    rng = np.random.default_rng(25 + groups)
    x = rng.standard_normal((B, T, K)).astype(np.float32)
    qp, s = _packed(rng, L, K // 2, NH * HD, groups=groups)
    jleaf = {"qp": jnp.asarray(qp[1]), "s": jnp.asarray(s[1]).astype(jnp.bfloat16)}
    tleaf = {"qp": _to_torch(qp), "s": _to_torch(s, torch.bfloat16)}
    want = jqmm.quant_apply(jnp.asarray(x).astype(JDT[x_dtype]), jleaf, (NH, HD),
                            out_dtype=jnp.float32)
    xt = _to_torch(x, TDT[x_dtype])
    got = tqmm.quant_apply(xt, {k: v[1] for k, v in tleaf.items()}, (NH, HD),
                           out_dtype=torch.float32)
    assert tuple(got.shape) == (B, T, NH, HD) and got.dtype == torch.float32
    _assert_close(got, want, x_dtype, "float32")
    stacked = tqmm.quant_apply_stacked(xt, tleaf, 1, (NH, HD), out_dtype=torch.float32)
    torch.testing.assert_close(stacked, got, atol=0, rtol=0)
    last = xt[:, -1]  # a step's last position: a strided slice
    assert not last.is_contiguous()
    step = tqmm.quant_apply_stacked(last, tleaf, 1, (NH, HD))
    assert tuple(step.shape) == (B, NH, HD) and step.dtype == xt.dtype
    _assert_close(step, np.asarray(want.astype(jnp.float32))[:, -1], x_dtype, x_dtype)


def test_grouped_product_rounds_the_scaled_weight_to_x_dtype():
    """With bf16 x the scaled weight is rounded to bf16 before the product:
    the plain version then differs from the unrounded fp32 product, and agrees
    with a product over the explicitly rounded weight."""
    from trace_tpu_torch.model.quantize import unpack4

    rng = np.random.default_rng(27)
    K, N = 256, 24
    x = _to_torch(rng.standard_normal((4, K)).astype(np.float32), torch.bfloat16)
    qp, s = _packed(rng, K // 2, N, groups=2)
    qp, s = _to_torch(qp), _to_torch(s, torch.bfloat16)
    w = unpack4(qp).float().reshape(2, K // 2, N) * s.float()[:, None, :]
    rounded = x.float() @ w.to(torch.bfloat16).float().reshape(K, N)
    exact = x.float() @ w.reshape(K, N)
    got = tqmm.quant_matmul_p4_grouped(x, qp, s, out_dtype=torch.float32)
    torch.testing.assert_close(got, rounded, atol=0, rtol=0)
    assert (got != exact).float().mean() > 0.9


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_quant_apply_w4a8_matches_jax(out_dtype):
    """Per-channel packed leaf: two s8 x s8 products over the nibble halves,
    summed as integers; then the W8A8 epilogue."""
    rng = np.random.default_rng(28)
    B, T, K, N = 2, 9, 1600, 40
    x = (rng.standard_normal((B, T, K)) * 2).astype(np.float32)
    qp, s = _packed(rng, K // 2, N)
    jxq, jxs = jqmm.quantize_acts(jnp.asarray(x))
    txq, txs = tqmm.quantize_acts(_to_torch(x))
    want = jqmm.quant_apply_w8a8(
        jxq, jxs, {"qp": jnp.asarray(qp), "s": jnp.asarray(s).astype(jnp.bfloat16)}, (N,),
        out_dtype=JDT[out_dtype])
    got = tqmm.quant_apply_w8a8(
        txq, txs, {"qp": _to_torch(qp), "s": _to_torch(s, torch.bfloat16)}, (N,),
        out_dtype=TDT[out_dtype])
    assert got.dtype == TDT[out_dtype] and tuple(got.shape) == (B, T, N)
    rtol = 1e-6 if out_dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol, atol=0)


def test_quant_apply_w8a8_refuses_group_scaled_leaves():
    """A group-scaled packed leaf has no s8 x s8 form: ``ValueError`` on both
    sides, and the weight-only route takes it."""
    rng = np.random.default_rng(29)
    K, N = 256, 16
    qp, s = _packed(rng, K // 2, N, groups=2)
    x = rng.standard_normal((3, K)).astype(np.float32)
    with pytest.raises(ValueError, match="group"):
        jqmm.quant_apply_w8a8(*jqmm.quantize_acts(jnp.asarray(x)),
                              {"qp": jnp.asarray(qp), "s": jnp.asarray(s)}, (N,))
    tleaf = {"qp": _to_torch(qp), "s": _to_torch(s, torch.bfloat16)}
    with pytest.raises(ValueError, match="group"):
        tqmm.quant_apply_w8a8(*tqmm.quantize_acts(_to_torch(x)), tleaf, (N,))
    assert tuple(tqmm.quant_apply(_to_torch(x), tleaf, (N,)).shape) == (3, N)


def test_packed_cpu_wrappers_run_plain_and_count_no_launch():
    rng = np.random.default_rng(30)
    K, N = 256, 24
    x = _to_torch(rng.standard_normal((2, K)).astype(np.float32))
    counts = lambda: (tqmm.quant_matmul_p4.launches, tqmm.quant_matmul_p4_grouped.launches,
                      dict(tqmm.quant_matmul_p4.launches_by_form),
                      dict(tqmm.quant_matmul_p4_grouped.launches_by_form))
    before = counts()
    for groups, flat, stacked, plain in (
            (1, tqmm.quant_matmul_p4, tqmm.quant_matmul_p4_stacked, tqmm.quant_matmul_p4_plain),
            (2, tqmm.quant_matmul_p4_grouped, tqmm.quant_matmul_p4_grouped_stacked,
             tqmm.quant_matmul_p4_grouped_plain)):
        qp, s = _packed(rng, 3, K // 2, N, groups=groups)
        qp, s = _to_torch(qp), _to_torch(s, torch.bfloat16)
        s2 = s[2] if groups > 1 else s[2].reshape(-1)
        torch.testing.assert_close(flat(x, qp[2], s2), plain(x, qp[2], s2), atol=0, rtol=0)
        torch.testing.assert_close(stacked(x, qp, s, 2), plain(x, qp[2], s2), atol=0, rtol=0)
        torch.testing.assert_close(flat(x, qp[2], s2, impl="plain"), plain(x, qp[2], s2),
                                   atol=0, rtol=0)
    assert counts() == before


def test_packed_wrappers_refuse_bad_arguments():
    x = torch.zeros((2, 256))
    qp = torch.zeros((3, 128, 24), dtype=torch.int8)
    s1 = torch.ones((3, 1, 24), dtype=torch.bfloat16)
    s2 = torch.ones((3, 2, 24), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tqmm.quant_matmul_p4(x, qp[0], s1[0], impl="fast")
    with pytest.raises(ValueError):
        tqmm.quant_matmul_p4(x, qp[0, :64], s1[0])          # K mismatch
    with pytest.raises(ValueError):
        tqmm.quant_matmul_p4(x, qp[0], s2[0])                # one scale per column wanted
    with pytest.raises(ValueError):
        tqmm.quant_matmul_p4_grouped(x, qp[0], s1[0])        # fewer than two groups
    with pytest.raises(ValueError):
        tqmm.quant_matmul_p4_grouped(x, qp[0], torch.ones((3, 24)))  # odd group count
    with pytest.raises(IndexError):
        tqmm.quant_matmul_p4_stacked(x, qp, s1, 3)
    with pytest.raises(IndexError):
        tqmm.quant_matmul_p4_grouped_stacked(x, qp, s2, -1)
    with pytest.raises(ValueError):
        tqmm.quant_matmul_p4_grouped_stacked(x, qp, s2[:2], 0)


def test_cpu_wrappers_run_plain_and_count_no_launch():
    rng = np.random.default_rng(24)
    x = _to_torch(rng.standard_normal((2, 32)).astype(np.float32))
    q, s = _weight(rng, 3, 32, 24)
    q, s = _to_torch(q), _to_torch(s, torch.bfloat16)
    counts = lambda: (tqmm.quant_matmul.launches, tqmm.quant_matmul_stacked.launches,
                      dict(tqmm.quant_matmul.launches_by_form),
                      dict(tqmm.quant_matmul_stacked.launches_by_form))
    before = counts()
    torch.testing.assert_close(tqmm.quant_matmul(x, q[0], s[0]),
                               tqmm.quant_matmul_plain(x, q[0], s[0]))
    torch.testing.assert_close(tqmm.quant_matmul_stacked(x, q, s, 2),
                               tqmm.quant_matmul_plain(x, q[2], s[2]))
    x32 = _to_torch(rng.standard_normal((32, 32)).astype(np.float32))  # the wide form's M
    torch.testing.assert_close(tqmm.quant_matmul_stacked(x32, q, s, 1),
                               tqmm.quant_matmul_plain(x32, q[1], s[1]))
    assert counts() == before


def test_wrappers_refuse_bad_arguments():
    x = torch.zeros((2, 32))
    q = torch.zeros((3, 32, 24), dtype=torch.int8)
    s = torch.ones((3, 24), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tqmm.quant_matmul(x, q[0], s[0], impl="fast")
    with pytest.raises(ValueError):
        tqmm.quant_matmul(x, q[0, :16], s[0])  # K mismatch
    with pytest.raises(IndexError):
        tqmm.quant_matmul_stacked(x, q, s, 3)
    with pytest.raises(ValueError):
        tqmm.quant_matmul_stacked(x, q, s[:, :12], 0)


# The split-K products' launch plan (host code the card's launch relies on),
# with an H100's 132 SMs holding two blocks of the kernel each: a cluster of
# c blocks fits 264 // c times at once.
def _fits(c):
    return 2 * 132 // c


def _check_plan(plan, M, K, N, rows, step):
    """The grid covers N and the rows of x (tiles of 8 rows, or the wide
    form's 32); the cluster's shares (whole k-steps) cover the weight rows,
    none of them empty; the cluster is portable; two blocks fit an SM's
    shared memory."""
    assert plan.tile in (tqmm.SPLIT_ROWS, tqmm.SPLIT_WIDE_ROWS)
    assert plan.strips * tqmm.SPLIT_STRIP >= N > (plan.strips - 1) * tqmm.SPLIT_STRIP
    assert plan.row_tiles * plan.tile >= M > (plan.row_tiles - 1) * plan.tile
    assert 1 <= plan.cluster <= 8
    assert plan.share % step == 0
    assert plan.cluster * plan.share >= rows > (plan.cluster - 1) * plan.share
    assert plan.smem <= 232448 and 2 * (plan.smem + 1024) <= 233472
    if plan.cluster > 1:  # every cluster of the launch runs at once
        assert plan.strips * plan.row_tiles <= _fits(plan.cluster)


@pytest.mark.parametrize("M,K,N", [(2, 4096, 6144), (2, 4096, 4096), (2, 4096, 28672),
                                   (2, 14336, 4096), (2, 4096, 32000), (37, 1000, 1100),
                                   (4096, 4096, 4096), (1, 40, 8)])
def test_split_k_covers_k_within_the_kernels_tile(M, K, N):
    """The int8 product's plan: one cluster of up to 8 blocks along K per
    128-column strip and tile of rows of x (8, or 32 where M > 8), every
    cluster resident at once; a decode-shaped call (the four layer shapes
    and the lm_head) puts at least one block on each of 132 SMs in that one
    wave. Up to 8 rows, fp32 x's instance ("i8f", shares of 8-row k-steps)
    plans the same grid."""
    plan = tqmm.split_plan(M, K, N, tqmm.int8_split_form(M), _fits)
    _check_plan(plan, M, K, N, K, 16)
    if M <= 8 and K >= 4096:
        assert 132 <= plan.blocks <= 2 * 132
    if M <= 8:
        f32 = tqmm.split_plan(M, K, N, "i8f", _fits)
        _check_plan(f32, M, K, N, K, 8)
        assert (f32.cluster, f32.strips, f32.row_tiles) == (plan.cluster, plan.strips,
                                                            plan.row_tiles)


@pytest.mark.parametrize("M,K,N", [(2, 4096, 6144), (2, 4096, 4096), (2, 4096, 28672),
                                   (2, 14336, 4096), (8, 1024, 520), (1, 256, 16)])
def test_split_k_of_the_packed_product_covers_the_packed_rows(M, K, N):
    """The packed products split their K / 2 packed rows with the same plan,
    per channel and grouped (a larger block: its scales ride in the ring),
    with bf16 x and with fp32 x ("p4f", "p4gf")."""
    for form in ("p4", "p4g", "p4f", "p4gf"):
        plan = tqmm.split_plan(M, K, N, form, _fits)
        _check_plan(plan, M, K, N, K // 2, 8)
        if K >= 4096:
            assert 132 <= plan.blocks <= 2 * 132


DECODE_SHAPES = ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),  # wqkv .. w_down
                 (4096, 32000))                                              # the lm_head


@pytest.mark.parametrize("K,N", DECODE_SHAPES)
@pytest.mark.parametrize("M", [9, 16, 32, 33, 64, 3886])
def test_wide_int8_plan_reads_the_weight_once_up_to_32_rows(M, K, N):
    """Past 8 rows of x the int8 product takes the wide tile: up to 32 rows
    one row tile, so the weight is read once, and the launch is the one the
    same shape has at M = 2, the whole grid resident in one wave; past 32
    rows tiles of 32, each cluster of a launch still resident at once."""
    assert tqmm.int8_split_form(M) == "i8w" and tqmm.int8_split_form(8) == "i8"
    plan = tqmm.split_plan(M, K, N, "i8w", _fits)
    _check_plan(plan, M, K, N, K, 16)
    assert plan.tile == 32 and plan.row_tiles == -(-M // 32)
    if M <= 32:
        narrow = tqmm.split_plan(2, K, N, "i8", _fits)
        assert plan.row_tiles == 1 and plan.blocks == narrow.blocks <= 2 * 132
        assert (plan.cluster, plan.share) == (narrow.cluster, narrow.share)


def _layout_smem(form):
    """Layout<F, MT, X>::SMEM of csrc/qmm_split.cuh: the weight, x and scale
    rings, the receive buffer, the stages' barriers and counters, and 1024
    bytes for the alignment. fp32 x ("i8f", "p4f", "p4gf") takes boxes of 32
    k, twice a bf16 stage's x; its packed forms a ring of 4 stages."""
    f32, packed = form.endswith("f"), form.startswith("p4")
    mt = 32 if form == "i8w" else 8
    nstage = 3 if form == "i8w" else 4 if f32 and packed else 5
    halves = 2 if packed else 1
    x_stage = halves * (128 // (32 if f32 else 64)) * mt * 128
    s_stage = 4 * 128 * 2 if form.startswith("p4g") else 0
    rx = max(c * mt * -(-128 // c) for c in range(1, 9))
    rx = -(-rx // 4) * 4
    return nstage * (128 * 128 + x_stage + s_stage + 8 + 4) + rx * 4 + 1024


@pytest.mark.parametrize("form", ["i8", "i8w", "p4", "p4g", "i8f", "p4f", "p4gf"])
def test_split_smem_is_the_kernels_layout(form):
    """The shared memory the plan counts on is the kernel's: two blocks an
    SM fit (232,448 bytes a block at most, 233,472 an SM with 1 KB each
    reserved)."""
    assert tqmm.SPLIT_SMEM[form] == _layout_smem(form)
    assert 2 * (tqmm.SPLIT_SMEM[form] + 1024) <= 233472


@pytest.mark.parametrize("fits,cluster", [(lambda c: 31 if c == 8 else 264 // c, 7),
                                          (lambda c: 0, 1)])
def test_split_plan_takes_a_smaller_cluster_where_the_card_holds_fewer(fits, cluster):
    """Clusters are placed within a GPC, so a card may hold fewer of the
    largest than its SM count says: the plan then takes the largest cluster
    that still runs in one wave (wo at M = 2: 32 strips), and a cluster of 1
    where none does."""
    plan = tqmm.split_plan(2, 4096, 4096, "i8", fits)
    assert plan.cluster == cluster
    _check_plan(plan, 2, 4096, 4096, 4096, 16)
