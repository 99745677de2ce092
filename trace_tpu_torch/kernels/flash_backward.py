"""Attention forward with residuals and attention backward: wrappers of the
CUDA kernels in csrc/attention.cu and csrc/attention_bwd.cu (at head dim 256
csrc/attention_bwd_256.cu), and their plain PyTorch versions.

``flash_attention_fwd_res`` replaces trace_tpu/kernels/flash_backward.py
``flash_attention_fwd_res`` (``_fwd_res_kernel``): the attention forward that
also returns ``lse = m + log(sum exp(s - m))`` per query row. It is the
forward kernel of ``flash_attention`` with one more output.
``flash_attention_bwd`` replaces ``flash_attention_bwd`` (``_dq_kernel``,
``_dkv_kernel``): from the residuals ``o`` and ``lse``,

    p = exp(s - lse)        delta = rowsum(do * o)
    dv = p^T do             ds = p * (do v^T - delta)
    dq = ds k * scale       dk = ds^T q * scale

with dk and dv summed over the G query heads of a kv head. It runs three
launches, each a wrapper of its own with a launch count:
``flash_attention_bwd_delta`` (a pre-pass), ``flash_attention_bwd_dq`` and
``flash_attention_bwd_dkv``.

Bound on an H100: operations. At the training shape (B=2, 32/8 heads,
T=2048, hd=128, causal, one row right-padded by 300) a product over the
visible pairs is ~29.7 GFLOP; the forward needs two, the backward five, over
~100 MB of operands: 0.150 ms for a backward at the bf16 peak. The two
kernels take the forward's Hopper design: a producer warp copies tiles by
TMA into a ring of shared memory, and two consumer warpgroups run every
product as wgmma with the accumulators in registers. The dq kernel keeps
128 query rows of Q and dO and streams 64-key tiles of K and V; the dk/dv
kernel keeps 128 keys of K and V and streams 64-row tiles of Q and dO (with
their lse and delta) over the G query heads of its kv head in a fixed
order, so the group sum needs no atomics and no per-query-head copy, and a
step repeats bit for bit. Each recomputes its tiles of p from ``lse``: 3
products for dq and 4 for dk/dv, 7 where a fused backward would need 5.
See csrc/attention_bwd.cu for what sets their pace.

On a CUDA tensor a wrapper launches its kernel or raises; the plain version
runs for CPU tensors, or when the caller passes ``impl="plain"``.

fp32 operands take the fp32 forms, chosen by dtype and counted in
``<wrapper>.launches_f32``: the forward of csrc/attention_f32.cu and the
three launches of csrc/attention_bwd_f32.cu (the pre-pass, then dq and dk/dv),
all on the tensor cores, each fp32 product as three TF32 products of the
operands split into hi and lo parts.

Head dims: ``flash_attention_fwd_res`` and the backward
(``flash_attention_bwd`` and its three launches) take what the forward
takes: 1 to 256 in bf16, 1 to 128 in fp32 (``head_dim_limit``); past it
they raise a ``ValueError`` that names that limit
(``flash_attention_trainable`` raises it at the forward of a step whose q,
k or v takes a gradient). The bf16 dq and dk/dv kernels are built at tile
widths 64 and 128 (csrc/attention_bwd.cu) and 256
(csrc/attention_bwd_256.cu: 32-key tiles for dq, and for dk/dv blocks of
64 keys whose two consumer warpgroups each own half of hd's columns). At an
hd other than 64, 128 or 256 the dq and dk/dv wrappers copy q, k, v and do
zero-padded to the tile width (``kernel_width``), pass the real hd's scale,
and slice dq, dk and dv back (the padded columns of a gradient are products
with zero columns; lse is unchanged). The ``delta`` pre-pass reads o and do
at any even hd in place (an odd hd takes one zero column): zero columns add
nothing to its sums.

A query row that sees no key (left padding under the causal mask) has
``lse = -1e30``; its ``p`` is 1 on every key the backward visits. The plain
version visits all keys, the kernels skip causally masked tiles, so the two
(and the JAX package's kernels) differ on such rows unless ``do`` is zero
there, which it is in training: padding carries no label.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from trace_tpu_torch.kernels.flash_attention import (
    NEG_INF,
    _check_causal_operands,
    _count,
    _forward,
    _use_kernel,
    kernel_width,
    pad_head_dim,
)

_SOURCE = "attention_bwd.cu"
_SOURCE_256 = "attention_bwd_256.cu"  # the bf16 dq and dk/dv kernels at width 256
_SOURCE_F32 = "attention_bwd_f32.cu"


def _scale(hd: int, scale):
    return hd ** -0.5 if scale is None else scale


def _scores(q, k, mask_bias, causal, q_offset=0, scale=None):
    """fp32 scores [B, Hkv, G, Tq, Tk] with the bias and the causal mask
    (query row r at key position ``q_offset`` + r); ``scale`` defaults to
    hd^-0.5."""
    B, H, Tq, hd = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, Tq, hd)
    s = torch.einsum("bngth,bnsh->bngts", qg.float(), k.float()) * _scale(hd, scale)
    if mask_bias is not None:
        s = s + mask_bias.float()[:, None, None, None, :]
    if causal:
        qpos = torch.arange(Tq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(Tk, device=q.device)[None, :]
        s = torch.where(kpos <= qpos, s, torch.full_like(s, NEG_INF))
    return s


def flash_attention_fwd_res_plain(q, k, v, mask_bias=None, *, causal=False, q_offset=0,
                                  scale=None):
    """Plain version of ``flash_attention_fwd_res``: ``xla_attention`` with
    its fp32 logsumexp written out."""
    B, H, Tq, hd = q.shape
    s = _scores(q, k, mask_bias, causal, q_offset, scale)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    p = (e / l.clamp_min(1e-30)).to(v.dtype)
    o = torch.einsum("bngts,bnsh->bngth", p.float(), v.float())
    lse = m + torch.log(l.clamp_min(1e-30))
    return o.reshape(B, H, Tq, hd).to(q.dtype), lse.reshape(B, H, Tq, 1)


def flash_attention_fwd_res(
    q: torch.Tensor,                 # [B, H, Tq, hd]
    k: torch.Tensor,                 # [B, Hkv, Tk, hd]
    v: torch.Tensor,
    mask_bias: Optional[torch.Tensor] = None,  # [B, Tk] fp32 additive
    *,
    causal: bool = False,
    q_offset: int = 0,
    impl: str = "auto",
):
    """Attention forward returning (o, lse): o [B, H, Tq, hd] in q's dtype,
    lse [B, H, Tq, 1] fp32, the residuals ``flash_attention_bwd`` needs.
    Causal, query row r sees the keys j <= ``q_offset`` + r."""
    if not _use_kernel(q, impl):
        return flash_attention_fwd_res_plain(q, k, v, mask_bias, causal=causal,
                                             q_offset=q_offset)
    o, lse = _forward(q, k, v, mask_bias, causal=causal, q_offset=q_offset, lse=True)
    _count(flash_attention_fwd_res, q)
    return o, lse


flash_attention_fwd_res.launches = 0
flash_attention_fwd_res.launches_f32 = 0


def merge_attention(o1, lse1, o2, lse2, dtype):
    """One attention from two over disjoint key sets, each with its fp32
    logsumexp (``flash_attention_fwd_res``): the outputs weighed by
    exp(lse - max) in fp32, cast once to ``dtype``. A row that sees no key in
    one part (lse = -1e30) takes the other's output; a row that sees none in
    either the mean of the two (each then the mean of v)."""
    m = torch.maximum(lse1, lse2)
    w1, w2 = torch.exp(lse1 - m), torch.exp(lse2 - m)
    return ((w1 * o1.float() + w2 * o2.float()) / (w1 + w2)).to(dtype)


def _entry(x, name: str, width: int = 0):
    """The C entry ``name`` in the form for x's dtype: ``{name}_bf16`` of
    attention_bwd.cu (of attention_bwd_256.cu at tile ``width`` 256) or
    ``{name}_f32`` of attention_bwd_f32.cu."""
    from trace_tpu_torch.kernels.build import load

    if x.dtype == torch.float32:
        source, full = _SOURCE_F32, f"{name}_f32"
    else:
        source, full = _SOURCE_256 if width == 256 else _SOURCE, f"{name}_bf16"
    return getattr(load(source), full), full


def _check_bwd_operands(q, k, v, mask_bias, do, lse, delta):
    _check_causal_operands(q, k, v, mask_bias)
    if do.dtype != q.dtype:
        raise TypeError(f"do: the CUDA kernels take do in q's dtype {q.dtype}, got {do.dtype}")
    if do.shape != q.shape or not do.is_contiguous():
        raise ValueError("do must be a contiguous tensor of q's shape")
    if do.data_ptr() % 16:
        raise ValueError("do: data pointer not 16-byte aligned")
    rows = q.shape[:3] + (1,)
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != rows or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous fp32 {tuple(rows)}")


def flash_attention_bwd_delta(o, do, *, impl: str = "auto"):
    """delta [B, H, Tq, 1] fp32 = rowsum(do * o)."""
    if not _use_kernel(o, impl):
        return (do.float() * o.float()).sum(dim=-1, keepdim=True)
    from trace_tpu_torch.kernels.build import check

    for name, x in (("o", o), ("do", do)):
        if x.dtype not in (torch.bfloat16, torch.float32) or x.dtype != o.dtype:
            raise TypeError(f"{name}: the CUDA kernels take bfloat16 or float32 o and do "
                            f"of one dtype, got {x.dtype}")
        if not x.is_contiguous() or x.shape != o.shape:
            raise ValueError(f"{name} must be contiguous and of o's shape")
    hd = o.shape[-1]
    kernel_width(hd, o.dtype, backward=True)  # the backward's limit
    if hd % 2:  # the bf16 kernel reads pairs
        o, do, hd = pad_head_dim(o, hd + 1), pad_head_dim(do, hd + 1), hd + 1
    delta = torch.empty(o.shape[:-1] + (1,), dtype=torch.float32, device=o.device)
    fn, name = _entry(o, "attn_bwd_delta")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    check(fn(o.data_ptr(), do.data_ptr(), delta.data_ptr(), delta.numel(), hd,
             torch.cuda.current_stream(o.device).cuda_stream), name)
    _count(flash_attention_bwd_delta, o)
    return delta


flash_attention_bwd_delta.launches = 0
flash_attention_bwd_delta.launches_f32 = 0


def _p_and_ds(q, k, v, mask_bias, do, lse, delta, causal, scale=None):
    """fp32 p and ds, [B, Hkv, G, Tq, Tk], and do grouped alike."""
    B, H, Tq, hd = q.shape
    Hkv = k.shape[1]
    shape = (B, Hkv, H // Hkv, Tq)
    p = torch.exp(_scores(q, k, mask_bias, causal, scale=scale) - lse.reshape(shape + (1,)))
    dog = do.reshape(shape + (hd,)).float()
    dp = torch.einsum("bngth,bnsh->bngts", dog, v.float())
    return p, p * (dp - delta.reshape(shape + (1,))), dog


def flash_attention_bwd_dq_plain(q, k, v, mask_bias, do, lse, delta, *, causal=False,
                                 scale=None):
    """Plain version of ``flash_attention_bwd_dq``: materialised scores."""
    _, ds, _ = _p_and_ds(q, k, v, mask_bias, do, lse, delta, causal, scale)
    dq = torch.einsum("bngts,bnsh->bngth", ds, k.float()) * _scale(q.shape[-1], scale)
    return dq.reshape(q.shape).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, mask_bias, do, lse, delta, *, causal=False,
                                  scale=None):
    """Plain version of ``flash_attention_bwd_dkv``: materialised scores, the
    sum over a kv head's query heads inside the contraction."""
    B, H, Tq, hd = q.shape
    Hkv = k.shape[1]
    p, ds, dog = _p_and_ds(q, k, v, mask_bias, do, lse, delta, causal, scale)
    qg = q.reshape(B, Hkv, H // Hkv, Tq, hd).float()
    dv = torch.einsum("bngts,bngth->bnsh", p, dog)
    dk = torch.einsum("bngts,bngth->bnsh", ds, qg) * _scale(hd, scale)
    return dk.to(k.dtype), dv.to(v.dtype)


def _padded(*xs):
    """The operands zero-padded to the backward kernels' tile width for their
    head dim (themselves at 64, 128 and 256), and the real head dim's scale."""
    hd = xs[0].shape[-1]
    width = kernel_width(hd, xs[0].dtype, backward=True)
    return [pad_head_dim(x, width) for x in xs], hd ** -0.5


def _unpadded(x, hd: int):
    return x if x.shape[-1] == hd else x[..., :hd].contiguous()


def _bwd_args(q, k, v, mask_bias, do, lse, delta, outs, causal, scale):
    B, H, Tq, hd = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    argtypes = ([ctypes.c_void_p] * (7 + len(outs)) + [ctypes.c_int] * 7
                + [ctypes.c_float, ctypes.c_void_p])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask_bias.data_ptr() if mask_bias is not None else None,
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(x.data_ptr() for x in outs),
            B, H, H // Hkv, Tq, Tk, hd, int(causal), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    return argtypes, args


def flash_attention_bwd_dq(q, k, v, mask_bias, do, lse, delta, *, causal=False,
                           impl: str = "auto"):
    """dq [B, H, Tq, hd] in q's dtype."""
    if not _use_kernel(q, impl):
        return flash_attention_bwd_dq_plain(q, k, v, mask_bias, do, lse, delta,
                                            causal=causal)
    (qp, kp, vp, dop), scale = _padded(q, k, v, do)
    return _unpadded(_dq(qp, kp, vp, mask_bias, dop, lse, delta, causal, scale), q.shape[-1])


def _dq(q, k, v, mask_bias, do, lse, delta, causal, scale):
    """One launch of the dq kernel on operands at the tile width."""
    from trace_tpu_torch.kernels.build import check

    _check_bwd_operands(q, k, v, mask_bias, do, lse, delta)
    dq = torch.empty_like(q)
    fn, name = _entry(q, "attn_bwd_dq", q.shape[-1])
    fn.restype = ctypes.c_int
    fn.argtypes, args = _bwd_args(q, k, v, mask_bias, do, lse, delta, (dq,), causal, scale)
    check(fn(*args), name)
    _count(flash_attention_bwd_dq, q)
    return dq


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.launches_f32 = 0


def flash_attention_bwd_dkv(q, k, v, mask_bias, do, lse, delta, *, causal=False,
                            impl: str = "auto"):
    """(dk, dv), each [B, Hkv, Tk, hd], summed over the query heads of each
    kv head."""
    if not _use_kernel(q, impl):
        return flash_attention_bwd_dkv_plain(q, k, v, mask_bias, do, lse, delta,
                                             causal=causal)
    (qp, kp, vp, dop), scale = _padded(q, k, v, do)
    dk, dv = _dkv(qp, kp, vp, mask_bias, dop, lse, delta, causal, scale)
    return _unpadded(dk, q.shape[-1]), _unpadded(dv, q.shape[-1])


def _dkv(q, k, v, mask_bias, do, lse, delta, causal, scale):
    """One launch of the dk/dv kernel on operands at the tile width."""
    from trace_tpu_torch.kernels.build import check

    _check_bwd_operands(q, k, v, mask_bias, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn, name = _entry(q, "attn_bwd_dkv", q.shape[-1])
    fn.restype = ctypes.c_int
    fn.argtypes, args = _bwd_args(q, k, v, mask_bias, do, lse, delta, (dk, dv), causal,
                                  scale)
    check(fn(*args), name)
    _count(flash_attention_bwd_dkv, q)
    return dk, dv


flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.launches_f32 = 0


def flash_attention_bwd(q, k, v, mask_bias, o, lse, do, *, causal=False,
                        impl: str = "auto"):
    """(dq, dk, dv) in the input dtypes from the forward's residuals ``o``
    and ``lse``; the scores are recomputed tile by tile (on the card, at an
    hd other than the tile width, over operands padded once for both
    kernels)."""
    if not _use_kernel(q, impl):
        delta = flash_attention_bwd_delta(o, do, impl=impl)
        dq = flash_attention_bwd_dq(q, k, v, mask_bias, do, lse, delta, causal=causal,
                                    impl=impl)
        dk, dv = flash_attention_bwd_dkv(q, k, v, mask_bias, do, lse, delta,
                                         causal=causal, impl=impl)
        return dq, dk, dv
    hd = q.shape[-1]
    (qp, kp, vp, dop), scale = _padded(q, k, v, do)
    delta = flash_attention_bwd_delta(o, do, impl=impl)
    dq = _dq(qp, kp, vp, mask_bias, dop, lse, delta, causal, scale)
    dk, dv = _dkv(qp, kp, vp, mask_bias, dop, lse, delta, causal, scale)
    return _unpadded(dq, hd), _unpadded(dk, hd), _unpadded(dv, hd)
