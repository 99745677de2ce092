"""Prefill and ViT attention: wrappers of the CUDA kernel in
csrc/attention.cu, and their plain PyTorch versions.

``flash_attention`` replaces trace_tpu/kernels/flash_attention.py
``flash_attention`` (``_attn_kernel``): causal GQA attention for prefill with
an additive fp32 [B, Tk] padding bias. ``vit_attention_btd`` replaces
``vit_attention_btd`` (``_btd_kernel``): bidirectional attention read and
written in the ViT's [B, P, D] layout, keys >= tq masked.

Bound on an H100: operations. At the prefill shape (B=2, 32/8 heads,
T=2048, hd=128, causal, one row left-padded by 300) the visible causal
pairs take ~59 GFLOP over ~80 MB of q/k/v/o, ~700 flops per byte, far
above the card's ~295 bf16 flops per byte (the ViT chunk sits near the
ridge: ~22 GFLOP over ~76 MB, where one exponential per score costs as
much as the products). The design keeps the scores out of device memory
and feeds Hopper's tensor cores the way they run fastest: a block owns 128
query rows of one head; a producer thread copies Q and a ring of 128-key
K/V tiles by TMA; two consumer warpgroups of 64 rows each run both products
as wgmma (fp32 accumulate) and an online softmax in registers between them.
What sets the pace is the softmax between a warpgroup's two products, which
only the other warpgroup's products hide. See csrc/attention.cu. A query row
that sees no key (a left-padded prefill's pad rows) gets the mean of v over
the keys from both: the plain version's scores of such a row are all the same
-1e30, so its softmax is uniform; the kernel leaves those rows to a second,
small launch that writes that mean. The kernel
reads q, k and v through TMA tensor maps, so the wrapper's operands need
16-byte aligned pointers and row strides (not contiguity: a chunk of a
chunked prefill attends a layer's cache stripe in place).

With ``q_offset`` (``flash_attention``, causal) query row r sits at position
``q_offset + r`` of the keys and sees the keys j <= q_offset + r: a chunk of
a chunked prefill over the cache stripe it was just written into.

fp32 operands take the fp32 form of the same functions, csrc/attention_f32.cu,
chosen by dtype; all operands share q's dtype. It keeps the design above on
Hopper's tensor cores, and each fp32 product runs as three TF32 products of
the operands split into hi and lo parts, a_hi b_hi + a_hi b_lo + a_lo b_hi,
within ~2^-22 of the fp32 product (one TF32 product would round the operands
to 10 mantissa bits, and exactness is what an fp32 model is served for); each
key tile's P V is summed apart and added into O rounding to nearest. Bound by
operations: three TF32 products at 495 TFLOP/s.

On a CUDA tensor a wrapper launches its kernel or raises; the plain version
runs for CPU tensors, or when the caller passes ``impl="plain"``. Each
wrapper counts its launches in ``<wrapper>.launches`` (bf16) and
``<wrapper>.launches_f32`` (fp32).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from trace_tpu_torch.kernels.build import count_launch

NEG_INF = -1e30
_SOURCE = "attention.cu"
_SOURCE_F32 = "attention_f32.cu"
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _use_kernel(x: torch.Tensor, impl: str) -> bool:
    if impl == "plain":
        return False
    if impl != "auto":
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    return x.is_cuda


def xla_attention(q, k, v, mask_bias=None, *, causal=False, q_offset=0):
    """Plain version of ``flash_attention`` (port of the JAX package's
    ``xla_attention``): materialises the fp32 scores. Causal, query row r
    sees the keys j <= q_offset + r."""
    B, H, Tq, hd = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, Tq, hd)
    s = torch.einsum("bngth,bnsh->bngts", qg.float(), k.float())
    s = s * (hd ** -0.5)
    if mask_bias is not None:
        s = s + mask_bias.float()[:, None, None, None, :]
    if causal:
        qpos = torch.arange(Tq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(Tk, device=q.device)[None, :]
        s = torch.where(kpos <= qpos, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bngts,bnsh->bngth", p.float(), v.float())
    return o.reshape(B, H, Tq, hd).to(q.dtype)


def _count(fn, x) -> None:
    """One launch of ``fn``'s kernel in the form for x's dtype."""
    count_launch(fn, "launches_f32") if x.dtype == torch.float32 else count_launch(fn)


def _check_operand(name, x, hd, dtype):
    if x.dtype != dtype or dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: the CUDA kernels take bfloat16 or float32 operands of "
                        f"one dtype, got {x.dtype} beside q's {dtype}")
    if x.stride(-1) != 1 or any(s % (16 // x.element_size()) for s in x.stride()[:-1]):
        raise ValueError(f"{name}: needs unit stride on the last dim and "
                         f"16-byte aligned rows, got strides {x.stride()}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")
    if hd not in (64, 128):
        raise ValueError(f"{name}: head dim {hd} not in (64, 128)")


def _launch(q, k, v, bias, o, *, B, H, group, tq, tk, hd, kv_len, causal,
            q_strides, k_strides, v_strides, o_strides, bias_stride, lse=None, q_offset=0):
    """One launch of the forward kernel in the form for q's dtype; ``lse``
    (fp32 [B, H, Tq], contiguous) also receives each query row's
    logsumexp."""
    from trace_tpu_torch.kernels.build import check, load

    name = "attn_fwd_f32" if q.dtype == torch.float32 else "attn_fwd_bf16"
    fn = getattr(load(_SOURCE_F32 if q.dtype == torch.float32 else _SOURCE), name)
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_float]
        + [ctypes.c_longlong] * 13 + [ctypes.c_void_p]
    )
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if bias is not None else None, o.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        B, H, group, tq, tk, hd, kv_len, int(causal), int(q_offset), float(hd ** -0.5),
        *q_strides, *k_strides, *v_strides, *o_strides, bias_stride,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(err, name)


def _check_causal_operands(q, k, v, mask_bias, *, contiguous: bool = True):
    """Shapes, types and layout the [B, H, T, hd] kernels take (the forward
    reads through strides, the backward wants ``contiguous`` operands)."""
    B, H, Tq, hd = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if k.shape != (B, Hkv, Tk, hd) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if contiguous and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        _check_operand(name, x, hd, q.dtype)
    if mask_bias is not None:
        if (mask_bias.shape != (B, Tk) or mask_bias.dtype != torch.float32
                or not mask_bias.is_contiguous()):
            raise ValueError("mask_bias must be a contiguous fp32 [B, Tk]")


def flash_attention(
    q: torch.Tensor,                 # [B, H, Tq, hd]
    k: torch.Tensor,                 # [B, Hkv, Tk, hd]
    v: torch.Tensor,                 # [B, Hkv, Tk, hd]
    mask_bias: Optional[torch.Tensor] = None,  # [B, Tk] fp32 additive
    causal: bool = False,
    *,
    q_offset: int = 0,
    impl: str = "auto",
) -> torch.Tensor:
    """Attention with the scores kept on chip. Returns [B, H, Tq, hd] in q's
    dtype. GQA: query head h reads kv head h // (H // Hkv). Causal, query
    row r sees the keys j <= ``q_offset`` + r. q, k and v need unit stride on
    hd and 16-byte aligned rows, not contiguity."""
    if not _use_kernel(q, impl):
        return xla_attention(q, k, v, mask_bias, causal=causal, q_offset=q_offset)
    _check_causal_operands(q, k, v, mask_bias, contiguous=False)
    if q_offset < 0 or (q_offset and not causal):
        raise ValueError(f"q_offset={q_offset}: a causal offset >= 0")
    B, H, Tq, hd = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(
        q, k, v, mask_bias, o, B=B, H=H, group=H // Hkv, tq=Tq, tk=Tk, hd=hd,
        kv_len=Tk, causal=causal,
        q_strides=q.stride()[:3], k_strides=k.stride()[:3],
        v_strides=v.stride()[:3], o_strides=o.stride()[:3],
        bias_stride=Tk, q_offset=q_offset,
    )
    _count(flash_attention, q)
    return o


flash_attention.launches = 0
flash_attention.launches_f32 = 0


def vit_attention_btd_reference(q, k, v, *, tq, num_heads):
    """Plain version of ``vit_attention_btd``."""
    B, P, D = q.shape
    hd = D // num_heads
    qh = q.reshape(B, P, num_heads, hd).transpose(1, 2)
    kh = k.reshape(B, P, num_heads, hd).transpose(1, 2)
    vh = v.reshape(B, P, num_heads, hd).transpose(1, 2)
    bias = torch.where(
        torch.arange(P, device=q.device) < tq, 0.0, NEG_INF
    ).to(torch.float32)[None, :]
    o = xla_attention(qh, kh, vh, bias.expand(B, P))
    return o.transpose(1, 2).reshape(B, P, D)


def vit_attention_btd(
    q: torch.Tensor,   # [B, P, D]
    k: torch.Tensor,
    v: torch.Tensor,
    tq: int,           # real sequence length (<= P); keys >= tq are masked
    num_heads: int,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """Bidirectional attention in [B, P, D] layout. q, k and v may be column
    slices of one fused [B, P, 3D] projection (unit stride on D is all the
    kernel needs). Returns a contiguous [B, P, D]; rows >= tq are padding."""
    if not _use_kernel(q, impl):
        return vit_attention_btd_reference(q, k, v, tq=tq, num_heads=num_heads)
    B, P, D = q.shape
    if k.shape != q.shape or v.shape != q.shape or D % num_heads:
        raise ValueError("q, k, v must share one [B, P, D] shape")
    if k.stride() != v.stride():
        raise ValueError("k and v must share strides")
    hd = D // num_heads
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, hd, q.dtype)
    if not 0 < tq <= P:
        raise ValueError(f"tq={tq} outside (0, {P}]")
    o = torch.empty((B, P, D), dtype=q.dtype, device=q.device)

    def bht(x):  # (batch, head, token) element strides of the [B, P, D] view
        return (x.stride(0), hd, x.stride(1))

    _launch(
        q, k, v, None, o, B=B, H=num_heads, group=1, tq=P, tk=P, hd=hd,
        kv_len=tq, causal=False,
        q_strides=bht(q), k_strides=bht(k), v_strides=bht(v),
        o_strides=bht(o), bias_stride=0,
    )
    _count(vit_attention_btd, q)
    return o


vit_attention_btd.launches = 0
vit_attention_btd.launches_f32 = 0


class _FlashAttentionTrainable(torch.autograd.Function):
    """Forward ``flash_attention_fwd_res``, backward ``flash_attention_bwd``
    (kernels/flash_backward.py): nothing [B, H, Tq, Tk]-shaped reaches device
    memory in either direction."""

    @staticmethod
    def forward(ctx, q, k, v, mask_bias, causal, impl):
        from trace_tpu_torch.kernels.flash_backward import flash_attention_fwd_res

        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_attention_fwd_res(q, k, v, mask_bias, causal=causal, impl=impl)
        # under no_grad nothing is saved: autograd drops these references
        ctx.save_for_backward(q, k, v, mask_bias, o, lse)
        ctx.causal, ctx.impl = causal, impl
        return o

    @staticmethod
    def backward(ctx, do):
        from trace_tpu_torch.kernels.flash_backward import flash_attention_bwd

        q, k, v, mask_bias, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, mask_bias, o, lse, do.contiguous(),
                                         causal=ctx.causal, impl=ctx.impl)
        return dq, dk, dv, None, None, None


def flash_attention_trainable(q, k, v, mask_bias=None, causal: bool = False, *,
                              impl: str = "auto") -> torch.Tensor:
    """Differentiable ``flash_attention``: the forward keeps each query row's
    logsumexp, the backward recomputes the score tiles from it inside the
    dq and dk/dv kernels. No gradient reaches ``mask_bias``."""
    return _FlashAttentionTrainable.apply(q, k, v, mask_bias, causal, impl)
