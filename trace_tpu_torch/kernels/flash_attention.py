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

Head dims: the bf16 kernel is built at a tile width HD of 64, 128 or 256
and takes any hd from 1 to 256 (``MAX_HEAD_DIM``): hd <= 64 runs at 64,
64 < hd <= 128 at 128, 128 < hd <= 256 at 256 (``kernel_width``); so does
the bf16 backward (kernels/flash_backward.py: csrc/attention_bwd.cu at 64
and 128, csrc/attention_bwd_256.cu at 256). The fp32 forms, forward and
backward, are built at 64 and 128 and take 1 to 128
(``MAX_HEAD_DIM_NARROW``). Past its limit a wrapper raises a ``ValueError``
that names it (``head_dim_limit``). At an hd other than the tile width the
wrapper copies q, k and v zero-padded to HD (``pad_head_dim``), as the JAX
package pads to a multiple of 128, passes the real hd's scale hd^-0.5 apart
from the width, and slices the output back: zero columns add nothing to
q . k and give zero output columns. At 64, 128 and 256 nothing is copied.
At hd 256 the kernel streams 64-key K / V tiles (Q alone fills 64 KB of
shared memory there) and its P V runs as wgmma m64n256k16.

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
MAX_HEAD_DIM = 256  # the widest tile the bf16 kernels (rows 1, 2, 8-10) are built at
MAX_HEAD_DIM_NARROW = 128  # the widest tile of every fp32 form
_SOURCE = "attention.cu"
_SOURCE_F32 = "attention_f32.cu"
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _use_kernel(x: torch.Tensor, impl: str) -> bool:
    if impl == "plain":
        return False
    if impl != "auto":
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    return x.is_cuda


def head_dim_limit(dtype=torch.bfloat16) -> int:
    """The largest head dim the attention kernels, forward and backward,
    take for operands of ``dtype``: ``MAX_HEAD_DIM`` in bf16,
    ``MAX_HEAD_DIM_NARROW`` in every fp32 form."""
    return MAX_HEAD_DIM if dtype == torch.bfloat16 else MAX_HEAD_DIM_NARROW


def kernel_width(hd: int, dtype=torch.bfloat16, *, backward: bool = False) -> int:
    """The tile width HD the kernels run head dim ``hd`` at: 64 for hd <= 64,
    128 up to 128, 256 up to 256; a ``ValueError`` past the limit of the
    kernels for ``dtype``, which it names (the backward's, with
    ``backward``)."""
    limit = head_dim_limit(dtype)
    if not 1 <= hd <= limit:
        kind = "fp32" if dtype == torch.float32 else "bf16"
        what = (f"{kind} attention backward kernels (rows 9-10)" if backward
                else "fp32 attention kernels" if dtype == torch.float32
                else "bf16 attention forward kernels")
        raise ValueError(f"head dim {hd}: the {what} take 1 ... {limit}")
    return 64 if hd <= 64 else 128 if hd <= 128 else 256


def pad_head_dim(x: torch.Tensor, width: int) -> torch.Tensor:
    """x with its last dim zero-padded to ``width`` (a contiguous copy, one
    pass over x), or x itself where the last dim is ``width``."""
    hd = x.shape[-1]
    return x if hd == width else torch.nn.functional.pad(x, (0, width - hd)).contiguous()


def pad_heads(x: torch.Tensor, num_heads: int, width: int) -> torch.Tensor:
    """[B, P, heads x hd] -> [B, P, heads x width]: each head's columns
    zero-padded to ``width`` (a contiguous copy; x itself at hd = width)."""
    hd = x.shape[-1] // num_heads
    if hd == width:
        return x
    return pad_head_dim(x.unflatten(-1, (num_heads, hd)), width).flatten(-2)


def unpad_heads(x: torch.Tensor, num_heads: int, hd: int) -> torch.Tensor:
    """The inverse of ``pad_heads``: each head's first ``hd`` columns, as a
    contiguous [B, P, heads x hd]."""
    width = x.shape[-1] // num_heads
    if hd == width:
        return x
    return x.unflatten(-1, (num_heads, width))[..., :hd].flatten(-2).contiguous()


def xla_attention(q, k, v, mask_bias=None, *, causal=False, q_offset=0, scale=None):
    """Plain version of ``flash_attention`` (port of the JAX package's
    ``xla_attention``): materialises the fp32 scores. Causal, query row r
    sees the keys j <= q_offset + r. ``scale`` defaults to hd^-0.5."""
    B, H, Tq, hd = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, Tq, hd)
    s = torch.einsum("bngth,bnsh->bngts", qg.float(), k.float())
    s = s * (hd ** -0.5 if scale is None else scale)
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
    """An operand the kernels read at tile width ``hd`` (64, 128 or 256; the
    wrappers pad other head dims first)."""
    if x.dtype != dtype or dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: the CUDA kernels take bfloat16 or float32 operands of "
                        f"one dtype, got {x.dtype} beside q's {dtype}")
    if x.stride(-1) != 1 or any(s % (16 // x.element_size()) for s in x.stride()[:-1]):
        raise ValueError(f"{name}: needs unit stride on the last dim and "
                         f"16-byte aligned rows, got strides {x.stride()}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")
    if hd not in (64, 128, 256):
        raise ValueError(f"{name}: tile width {hd} not in (64, 128, 256)")


def _launch(q, k, v, bias, o, *, B, H, group, tq, tk, hd, kv_len, causal,
            q_strides, k_strides, v_strides, o_strides, bias_stride, scale, lse=None,
            q_offset=0):
    """One launch of the forward kernel in the form for q's dtype, at tile
    width ``hd`` (64, 128 or 256) with the softmax scale ``scale`` (hd^-0.5 of
    the real head dim); ``lse`` (fp32 [B, H, Tq], contiguous) also
    receives each query row's logsumexp."""
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
        B, H, group, tq, tk, hd, kv_len, int(causal), int(q_offset), float(scale),
        *q_strides, *k_strides, *v_strides, *o_strides, bias_stride,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(err, name)


def _check_causal_operands(q, k, v, mask_bias, *, contiguous: bool = True):
    """Shapes, types and layout the [B, H, T, hd] kernels take (the forward
    reads through strides, the backward wants ``contiguous`` operands), at
    tile width hd: the operands as the wrappers pass them, padded."""
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
    row r sees the keys j <= ``q_offset`` + r. At hd 64, 128 and 256, q, k
    and v need unit stride on hd and 16-byte aligned rows, not contiguity;
    any other hd up to the limit (``head_dim_limit``: 256 in bf16, 128 in
    fp32) runs on zero-padded copies."""
    if not _use_kernel(q, impl):
        return xla_attention(q, k, v, mask_bias, causal=causal, q_offset=q_offset)
    o, _ = _forward(q, k, v, mask_bias, causal=causal, q_offset=q_offset)
    _count(flash_attention, q)
    return o


def _forward(q, k, v, mask_bias, *, causal, q_offset, lse: bool = False):
    """One launch of the forward kernel over [B, H, T, hd] operands of any
    hd up to the limit for q's dtype: (o [B, H, Tq, hd] contiguous, lse [B,
    H, Tq, 1] fp32 or None). At an hd other than the tile width, on
    zero-padded copies, the output sliced back."""
    hd = q.shape[-1]
    width = kernel_width(hd, q.dtype)
    if k.shape[-1] != hd or v.shape[-1] != hd:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match")
    if q_offset < 0 or (q_offset and not causal):
        raise ValueError(f"q_offset={q_offset}: a causal offset >= 0")
    qp, kp, vp = (pad_head_dim(x, width) for x in (q, k, v))
    _check_causal_operands(qp, kp, vp, mask_bias, contiguous=False)
    B, H, Tq, _ = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    o = torch.empty(qp.shape, dtype=q.dtype, device=q.device)
    res = torch.empty((B, H, Tq, 1), dtype=torch.float32, device=q.device) if lse else None
    _launch(
        qp, kp, vp, mask_bias, o, B=B, H=H, group=H // Hkv, tq=Tq, tk=Tk, hd=width,
        kv_len=Tk, causal=causal,
        q_strides=qp.stride()[:3], k_strides=kp.stride()[:3],
        v_strides=vp.stride()[:3], o_strides=o.stride()[:3],
        bias_stride=Tk, lse=res, q_offset=q_offset, scale=hd ** -0.5,
    )
    return (o if width == hd else o[..., :hd].contiguous()), res


flash_attention.launches = 0
flash_attention.launches_f32 = 0


def vit_attention_btd_reference(q, k, v, *, tq, num_heads, scale=None):
    """Plain version of ``vit_attention_btd``; ``scale`` defaults to
    hd^-0.5."""
    B, P, D = q.shape
    hd = D // num_heads
    qh = q.reshape(B, P, num_heads, hd).transpose(1, 2)
    kh = k.reshape(B, P, num_heads, hd).transpose(1, 2)
    vh = v.reshape(B, P, num_heads, hd).transpose(1, 2)
    bias = torch.where(
        torch.arange(P, device=q.device) < tq, 0.0, NEG_INF
    ).to(torch.float32)[None, :]
    o = xla_attention(qh, kh, vh, bias.expand(B, P), scale=scale)
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
    kernel needs at head dims 64, 128 and 256; any other up to the limit runs
    on zero-padded [B, P, heads, HD] copies). Returns a contiguous [B, P, D];
    rows >= tq are padding."""
    if not _use_kernel(q, impl):
        return vit_attention_btd_reference(q, k, v, tq=tq, num_heads=num_heads)
    B, P, D = q.shape
    if k.shape != q.shape or v.shape != q.shape or D % num_heads:
        raise ValueError("q, k, v must share one [B, P, D] shape")
    hd = D // num_heads
    width = kernel_width(hd, q.dtype)
    q, k, v = (pad_heads(x, num_heads, width) for x in (q, k, v))
    if k.stride() != v.stride():
        raise ValueError("k and v must share strides")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, width, q.dtype)
    if not 0 < tq <= P:
        raise ValueError(f"tq={tq} outside (0, {P}]")
    o = torch.empty((B, P, num_heads * width), dtype=q.dtype, device=q.device)

    def bht(x):  # (batch, head, token) element strides of the [B, P, heads x HD] view
        return (x.stride(0), width, x.stride(1))

    _launch(
        q, k, v, None, o, B=B, H=num_heads, group=1, tq=P, tk=P, hd=width,
        kv_len=tq, causal=False,
        q_strides=bht(q), k_strides=bht(k), v_strides=bht(v),
        o_strides=bht(o), bias_stride=0, scale=hd ** -0.5,
    )
    _count(vit_attention_btd, q)
    return unpad_heads(o, num_heads, hd)


vit_attention_btd.launches = 0
vit_attention_btd.launches_f32 = 0


class _FlashAttentionTrainable(torch.autograd.Function):
    """Forward ``flash_attention_fwd_res``, backward ``flash_attention_bwd``
    (kernels/flash_backward.py): nothing [B, H, Tq, Tk]-shaped reaches device
    memory in either direction."""

    @staticmethod
    def forward(ctx, q, k, v, mask_bias, causal, impl):
        from trace_tpu_torch.kernels.flash_backward import flash_attention_fwd_res

        if _use_kernel(q, impl) and any(ctx.needs_input_grad[:3]):
            # past the backward's head-dim limit (256 in bf16, 128 in fp32) a
            # step raises here, before its forward, not after it
            kernel_width(q.shape[-1], q.dtype, backward=True)
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
