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
@pytest.mark.parametrize("M,K,N", [(2, 128, 256), (5, 200, 130), (37, 96, 72)])
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
@pytest.mark.parametrize("M,K,N", [(2, 128, 256), (10, 64, 48), (37, 200, 130)])
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
@pytest.mark.parametrize("M,K,N", [(2, 256, 96), (10, 512, 96), (37, 1024, 40)])
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
    before = (tqmm.quant_matmul.launches, tqmm.quant_matmul_stacked.launches)
    torch.testing.assert_close(tqmm.quant_matmul(x, q[0], s[0]),
                               tqmm.quant_matmul_plain(x, q[0], s[0]))
    torch.testing.assert_close(tqmm.quant_matmul_stacked(x, q, s, 2),
                               tqmm.quant_matmul_plain(x, q[2], s[2]))
    assert (tqmm.quant_matmul.launches, tqmm.quant_matmul_stacked.launches) == before


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


@pytest.mark.parametrize("M,K,N", [(2, 4096, 6144), (2, 4096, 4096), (2, 4096, 28672),
                                   (2, 14336, 4096), (2, 4096, 32000), (37, 1000, 1100),
                                   (4096, 4096, 4096), (1, 40, 8)])
def test_split_k_covers_k_within_the_kernels_tile(M, K, N):
    """The wrapper's choice of K chunk (host code the card's launch relies
    on): chunks cover K, none is longer than the kernel's x tile, and a
    decode-shaped call is split into enough blocks to fill 132 SMs."""
    strip, kmax = 512, 1024
    kchunk = tqmm.split_k(M, K, N, strip, kmax)
    assert 1 <= kchunk <= kmax
    ksplit = -(-K // kchunk)
    assert ksplit * kchunk >= K and (ksplit - 1) * kchunk < K
    blocks = -(-N // strip) * -(-M // 4) * ksplit
    if M <= 4 and K >= 4096:
        assert blocks >= 132


@pytest.mark.parametrize("M,K,N", [(2, 4096, 6144), (2, 4096, 4096), (2, 4096, 28672),
                                   (2, 14336, 4096), (8, 1024, 520), (1, 256, 16)])
def test_split_k_of_the_packed_product_covers_the_packed_rows(M, K, N):
    """The packed kernels split their K / 2 packed rows with the same host
    function, a chunk no longer than their x tile of 512 packed rows."""
    strip, kmax = 512, 512
    kchunk = tqmm.split_k(M, K // 2, N, strip, kmax)
    assert 1 <= kchunk <= kmax
    ksplit = -(-(K // 2) // kchunk)
    assert ksplit * kchunk >= K // 2 and (ksplit - 1) * kchunk < K // 2
    if K >= 4096:
        assert -(-N // strip) * -(-M // 4) * ksplit >= 132
