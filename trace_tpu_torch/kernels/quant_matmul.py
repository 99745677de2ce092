"""Quantized weight products of the int8 and int4p serving paths: wrappers
of the CUDA kernels in csrc/quant_matmul.cu and csrc/quant_matmul_p4.cu,
their plain PyTorch versions, and the W8A8 / W4A8 product
(trace_tpu/kernels/quant_matmul.py).

``quant_matmul`` / ``quant_matmul_stacked`` compute ``y = (x @ q) * s`` with
int8 ``q`` and a per-column scale: the weight-only product of every decoder
projection of a T = 1 step (stacked: layer ``li`` of the whole ``[L, K, N]``
leaf, read in place) and of the quantized ``lm_head`` (2-D). Bound on an
H100: bytes, one streaming read of K x N int8; see the source for the
design. On a CUDA tensor a wrapper launches its kernel or raises; the plain
version runs for CPU tensors, or when the caller passes ``impl="plain"``.
Launches are counted in ``quant_matmul.launches`` and
``quant_matmul_stacked.launches``.

``quant_matmul_p4`` / ``quant_matmul_p4_grouped`` (and their ``_stacked``
entries) are the weight-only products of nibble-packed int4 leaves ``{'qp',
's'}``: byte ``qp[k, n]`` holds weight rows ``k`` (low nibble) and ``k + K/2``
(high nibble). Per channel (``s`` [N]) the scale multiplies the fp32 sum once;
grouped (``s`` [K / 128, N]) each weight is ``nibble * s`` rounded to x's
dtype before the product. Each kernel has a split-K form for a few rows of x
(a decode step, bound by bytes) and a tensor-core form beyond (prefill, bound
by operations); ``launches`` counts both, ``launches_by_form`` each.

The W8A8 product (``quantize_acts`` + ``quant_apply_w8a8``: prefill and ViT
projections) is a plain s8 x s8 -> s32 matrix product, which the JAX package
leaves to XLA outside any Pallas kernel; here it is ``torch._int_mm`` on the
card and an exact integer product elsewhere, with the epilogue in torch. A
per-channel packed leaf takes it as two products over its nibble halves
(W4A8).
"""

from __future__ import annotations

import ctypes

import torch

from trace_tpu_torch.model.quantize import unpack4

_SOURCE = "quant_matmul.cu"
_SOURCE_P4 = "quant_matmul_p4.cu"
_TARGET_BLOCKS = 4 * 132  # a few blocks per SM of an H100
_MIN_KCHUNK = 64


def _check_impl(impl: str) -> None:
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ w [K, N] with an fp32 sum and an fp32 result (JAX's
    ``preferred_element_type=float32``). bf16 operands on the card go to
    one product with an fp32 output, so no fp32 copy of the weight is held;
    elsewhere the operands are widened first."""
    if x.is_cuda and x.dtype == w.dtype == torch.bfloat16:
        return torch.mm(x, w, out_dtype=torch.float32)
    return x.float() @ w.float()


def quant_matmul_plain(x, q, s, out_dtype=None):
    """((x @ q) -> fp32 sum) * s, the scale applied once on the sum. Every
    int8 is exact in x's dtype, so the products are those of the kernel."""
    y = (x.float() @ q.float()) * s.reshape(-1).float()[None, :]
    return y.to(out_dtype or x.dtype)


def split_k(M: int, K: int, N: int, strip: int, kchunk_max: int) -> int:
    """Rows of K per block: enough (strip, chunk, row tile) blocks to fill
    the card, a chunk no longer than the kernel's x tile."""
    blocks = -(-N // strip) * -(-M // 4)
    ksplit = max(-(-_TARGET_BLOCKS // blocks), -(-K // kchunk_max))
    ksplit = max(min(ksplit, -(-K // _MIN_KCHUNK)), -(-K // kchunk_max))
    return -(-K // ksplit)


def _check_operands(entry: str, x, q, s, out_dtype) -> None:
    """What every weight-product kernel takes: bf16 x, int8 weight bytes and a
    bf16 scale, contiguous on x's card; a bf16 or fp32 output."""
    if x.dtype != torch.bfloat16 or s.dtype != torch.bfloat16 or q.dtype != torch.int8:
        raise TypeError(f"{entry}: wants bf16 x, an int8 weight and a bf16 scale, got "
                        f"{x.dtype}, {q.dtype}, {s.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{entry}: out_dtype must be bf16 or fp32, got {out_dtype}")
    for name, t in (("x", x), ("weight", q), ("scale", s)):
        if not t.is_cuda or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{entry}: {name} must be contiguous on {x.device}")


def _launch(entry: str, x, q, s, lead_args, M, K, N, out_dtype):
    from trace_tpu_torch.kernels.build import check, load

    _check_operands(entry, x, q, s, out_dtype)
    lib = load(_SOURCE)
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * len(lead_args)
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    for const in (lib.quant_matmul_strip, lib.quant_matmul_kchunk_max):
        const.restype, const.argtypes = ctypes.c_int, []
    kchunk = split_k(M, K, N, lib.quant_matmul_strip(), lib.quant_matmul_kchunk_max())
    y = torch.empty((M, N), dtype=out_dtype, device=x.device)
    ws = torch.empty((-(-K // kchunk), M, N), dtype=torch.float32, device=x.device)
    err = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), *lead_args,
             y.data_ptr(), ws.data_ptr(), M, K, N, kchunk,
             int(out_dtype == torch.float32),
             torch.cuda.current_stream(x.device).cuda_stream)
    check(err, entry)
    return y


def quant_matmul(
    x: torch.Tensor,   # [M, K]
    q: torch.Tensor,   # [K, N] int8
    s: torch.Tensor,   # [N] (or broadcastable) per-column scale
    *,
    out_dtype=None,
    impl: str = "auto",
) -> torch.Tensor:
    """y [M, N] = (x @ q) * s, the int8 weight converted inside the kernel."""
    _check_impl(impl)
    M, K = x.shape
    if q.ndim != 2 or q.shape[0] != K or s.numel() != q.shape[1]:
        raise ValueError(f"shapes x {tuple(x.shape)} q {tuple(q.shape)} s {tuple(s.shape)}")
    if impl == "plain" or not x.is_cuda:
        return quant_matmul_plain(x, q, s, out_dtype)
    y = _launch("quant_matmul_i8", x, q, s.reshape(-1), (), M, K, q.shape[1],
                out_dtype or x.dtype)
    quant_matmul.launches += 1
    return y


quant_matmul.launches = 0


def quant_matmul_stacked(
    x: torch.Tensor,   # [M, K]
    q: torch.Tensor,   # [L, K, N] int8, the whole layer-stacked weight
    s: torch.Tensor,   # [L, N] (or [L, 1, N]) per (layer, column) scale
    li: int,
    *,
    out_dtype=None,
    impl: str = "auto",
) -> torch.Tensor:
    """y [M, N] = (x @ q[li]) * s[li]; the kernel offsets into the stacked
    weight itself, the Hopper form of the TPU kernel's scalar-prefetch index
    map."""
    _check_impl(impl)
    M, K = x.shape
    if q.ndim != 3 or q.shape[1] != K or s.numel() != q.shape[0] * q.shape[2]:
        raise ValueError(f"shapes x {tuple(x.shape)} q {tuple(q.shape)} s {tuple(s.shape)}")
    L, _, N = q.shape
    if not 0 <= li < L:
        raise IndexError(f"layer {li} of {L}")
    s = s.reshape(L, N)
    if impl == "plain" or not x.is_cuda:
        return quant_matmul_plain(x, q[li], s[li], out_dtype)
    y = _launch("quant_matmul_stacked_i8", x, q, s, (int(li), L), M, K, N,
                out_dtype or x.dtype)
    quant_matmul_stacked.launches += 1
    return y


quant_matmul_stacked.launches = 0


def quant_matmul_p4_plain(x, qp, s, out_dtype=None):
    """(x[:, :K/2] @ lo + x[:, K/2:] @ hi -> fp32 sum) * s with the nibbles of
    ``qp`` [K/2, N], the per-column scale applied once on the sum. Every
    nibble is exact in x's dtype, so the products are those of the kernel."""
    y = (x.float() @ unpack4(qp).float()) * s.reshape(-1).float()[None, :]
    return y.to(out_dtype or x.dtype)


def quant_matmul_p4_grouped_plain(x, qp, s, out_dtype=None):
    """x @ W -> fp32 sum, ``W[k, n] = nibble[k, n] * s[k // (K / G), n]``
    rounded to x's dtype (that rounding is part of the function), ``s``
    [G, N]; no scale afterwards."""
    G, N = s.shape
    K = 2 * qp.shape[0]
    w = unpack4(qp).float().reshape(G, K // G, N) * s.float()[:, None, :]
    y = x.float() @ w.to(x.dtype).float().reshape(K, N)
    return y.to(out_dtype or x.dtype)


def _launch_p4(entry: str, x, qp, s, lead_args, M, K, N, out_dtype):
    """One launch of a packed-int4 entry point of csrc/quant_matmul_p4.cu;
    returns (y, form): the split-K form up to the kernel's small-M limit
    (its workspace allocated here), the tensor-core form beyond."""
    from trace_tpu_torch.kernels.build import check, load

    _check_operands(entry, x, qp, s, out_dtype)
    lib = load(_SOURCE_P4)
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * len(lead_args)
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    for const in (lib.quant_matmul_p4_small_m_max, lib.quant_matmul_p4_strip,
                  lib.quant_matmul_p4_kchunk_max):
        const.restype, const.argtypes = ctypes.c_int, []
    y = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M <= lib.quant_matmul_p4_small_m_max():
        form = "splitk"
        kchunk = split_k(M, K // 2, N, lib.quant_matmul_p4_strip(),
                         lib.quant_matmul_p4_kchunk_max())
        ws = torch.empty((-(-(K // 2) // kchunk), M, N), dtype=torch.float32, device=x.device)
        ws_ptr = ws.data_ptr()
    else:
        form, kchunk, ws_ptr = "mma", 0, None
    err = fn(x.data_ptr(), qp.data_ptr(), s.data_ptr(), *lead_args,
             y.data_ptr(), ws_ptr, M, K, N, kchunk,
             int(out_dtype == torch.float32),
             torch.cuda.current_stream(x.device).cuda_stream)
    check(err, entry)
    return y, form


def _count(fn, form: str) -> None:
    fn.launches += 1
    fn.launches_by_form[form] += 1


def _check_p4(x, qp, stacked: bool = False) -> int:
    """Shapes of a packed product: x [M, K], qp [(L,) K/2, N]; returns N."""
    if x.ndim != 2 or qp.ndim != 2 + stacked or qp.shape[-2] * 2 != x.shape[1]:
        raise ValueError(f"shapes x {tuple(x.shape)} qp {tuple(qp.shape)}")
    return qp.shape[-1]


def _check_groups(K: int, G: int) -> None:
    if G < 2 or G % 2 or K % G:
        raise ValueError(f"grouped scales want an even number of groups dividing K, "
                         f"got G={G} for K={K}")


def quant_matmul_p4(
    x: torch.Tensor,    # [M, K]
    qp: torch.Tensor,   # [K/2, N] nibble-packed int8
    s: torch.Tensor,    # [N] (or broadcastable) per-column scale
    *,
    out_dtype=None,
    impl: str = "auto",
) -> torch.Tensor:
    """y [M, N] = (x @ unpack4(qp)) * s, the nibbles unpacked inside the kernel."""
    _check_impl(impl)
    N = _check_p4(x, qp)
    if s.numel() != N:
        raise ValueError(f"shapes qp {tuple(qp.shape)} s {tuple(s.shape)}")
    if impl == "plain" or not x.is_cuda:
        return quant_matmul_p4_plain(x, qp, s, out_dtype)
    y, form = _launch_p4("quant_matmul_p4_bf16", x, qp, s.reshape(-1), (),
                         x.shape[0], x.shape[1], N, out_dtype or x.dtype)
    _count(quant_matmul_p4, form)
    return y


def quant_matmul_p4_stacked(
    x: torch.Tensor,    # [M, K]
    qp: torch.Tensor,   # [L, K/2, N], the whole layer-stacked leaf
    s: torch.Tensor,    # [L, N] (or [L, 1, N])
    li: int,
    *,
    out_dtype=None,
    impl: str = "auto",
) -> torch.Tensor:
    """``quant_matmul_p4`` on layer ``li`` of the stacked leaf, read in place
    (the kernel offsets into it). Counts as a launch of ``quant_matmul_p4``."""
    _check_impl(impl)
    N = _check_p4(x, qp, stacked=True)
    L = qp.shape[0]
    if s.numel() != L * N:
        raise ValueError(f"shapes qp {tuple(qp.shape)} s {tuple(s.shape)}")
    if not 0 <= li < L:
        raise IndexError(f"layer {li} of {L}")
    s = s.reshape(L, N)
    if impl == "plain" or not x.is_cuda:
        return quant_matmul_p4_plain(x, qp[li], s[li], out_dtype)
    y, form = _launch_p4("quant_matmul_p4_stacked_bf16", x, qp, s, (int(li), L),
                         x.shape[0], x.shape[1], N, out_dtype or x.dtype)
    _count(quant_matmul_p4, form)
    return y


quant_matmul_p4.launches = 0
quant_matmul_p4.launches_by_form = {"splitk": 0, "mma": 0}


def quant_matmul_p4_grouped(
    x: torch.Tensor,    # [M, K]
    qp: torch.Tensor,   # [K/2, N] nibble-packed int8
    s: torch.Tensor,    # [G, N] per (group of K / G rows, column) scale, G even
    *,
    out_dtype=None,
    impl: str = "auto",
) -> torch.Tensor:
    """y [M, N] = x @ (unpack4(qp) scaled per group and rounded to x's dtype).
    The plain version takes any even G dividing K; the kernel groups of 128."""
    _check_impl(impl)
    N = _check_p4(x, qp)
    K = x.shape[1]
    if s.ndim != 2 or s.shape[1] != N:
        raise ValueError(f"shapes qp {tuple(qp.shape)} s {tuple(s.shape)}")
    _check_groups(K, s.shape[0])
    if impl == "plain" or not x.is_cuda:
        return quant_matmul_p4_grouped_plain(x, qp, s, out_dtype)
    if s.shape[0] * 128 != K:
        raise ValueError(f"the kernel wants groups of 128 rows, got G={s.shape[0]} for K={K}")
    y, form = _launch_p4("quant_matmul_p4_grouped_bf16", x, qp, s, (),
                         x.shape[0], K, N, out_dtype or x.dtype)
    _count(quant_matmul_p4_grouped, form)
    return y


def quant_matmul_p4_grouped_stacked(
    x: torch.Tensor,    # [M, K]
    qp: torch.Tensor,   # [L, K/2, N], the whole layer-stacked leaf
    s: torch.Tensor,    # [L, G, N]
    li: int,
    *,
    out_dtype=None,
    impl: str = "auto",
) -> torch.Tensor:
    """``quant_matmul_p4_grouped`` on layer ``li`` of the stacked leaf, read in
    place. Counts as a launch of ``quant_matmul_p4_grouped``."""
    _check_impl(impl)
    N = _check_p4(x, qp, stacked=True)
    L, K = qp.shape[0], x.shape[1]
    if s.ndim != 3 or s.shape[0] != L or s.shape[2] != N:
        raise ValueError(f"shapes qp {tuple(qp.shape)} s {tuple(s.shape)}")
    _check_groups(K, s.shape[1])
    if not 0 <= li < L:
        raise IndexError(f"layer {li} of {L}")
    if impl == "plain" or not x.is_cuda:
        return quant_matmul_p4_grouped_plain(x, qp[li], s[li], out_dtype)
    if s.shape[1] * 128 != K:
        raise ValueError(f"the kernel wants groups of 128 rows, got G={s.shape[1]} for K={K}")
    y, form = _launch_p4("quant_matmul_p4_grouped_stacked_bf16", x, qp, s, (int(li), L),
                         x.shape[0], K, N, out_dtype or x.dtype)
    _count(quant_matmul_p4_grouped, form)
    return y


quant_matmul_p4_grouped.launches = 0
quant_matmul_p4_grouped.launches_by_form = {"splitk": 0, "mma": 0}


def quant_apply_stacked(x, leaf: dict, li: int, out_shape: tuple, *,
                        out_dtype=None, impl: str = "auto") -> torch.Tensor:
    """Apply layer ``li`` of a stacked quantized weight (``{'q': [L, K,
    *out], 's': [L, ...]}`` or packed ``{'qp': [L, K/2, N], 's': [L, G, N]}``)
    to x [..., K] without slicing it out."""
    K = x.shape[-1]
    x2 = x.reshape(-1, K).contiguous()
    out_dtype = out_dtype or x.dtype
    if "qp" in leaf:
        L = leaf["qp"].shape[0]
        qp = leaf["qp"].reshape(L, K // 2, -1)
        s = leaf["s"].reshape(L, -1, qp.shape[2])
        if s.shape[1] > 1:
            y = quant_matmul_p4_grouped_stacked(x2, qp, s, li, out_dtype=out_dtype, impl=impl)
        else:
            y = quant_matmul_p4_stacked(x2, qp, s, li, out_dtype=out_dtype, impl=impl)
    else:
        L = leaf["q"].shape[0]
        y = quant_matmul_stacked(x2, leaf["q"].reshape(L, K, -1), leaf["s"].reshape(L, -1),
                                 li, out_dtype=out_dtype, impl=impl)
    return y.reshape(x.shape[:-1] + tuple(out_shape))


def quant_apply(x, leaf, out_shape: tuple, *, out_dtype=None,
                impl: str = "auto") -> torch.Tensor:
    """Apply a weight ``[K, *out]`` to x [..., K] as one 2-D product: an int8
    leaf ``{'q', 's'}`` through ``quant_matmul``, a packed leaf ``{'qp', 's'}``
    through ``quant_matmul_p4`` or, with group-wise scales,
    ``quant_matmul_p4_grouped``, a plain tensor through a product with an
    fp32 sum."""
    K = x.shape[-1]
    x2 = x.reshape(-1, K).contiguous()  # a step's last position is a strided slice
    if isinstance(leaf, dict) and "qp" in leaf:
        qp = leaf["qp"].reshape(K // 2, -1)
        N = qp.shape[1]
        if leaf["s"].numel() != N:
            y = quant_matmul_p4_grouped(x2, qp, leaf["s"].reshape(-1, N),
                                        out_dtype=out_dtype or x.dtype, impl=impl)
        else:
            y = quant_matmul_p4(x2, qp, leaf["s"].reshape(-1),
                                out_dtype=out_dtype or x.dtype, impl=impl)
    elif isinstance(leaf, dict):
        y = quant_matmul(x2, leaf["q"].reshape(K, -1), leaf["s"].reshape(-1),
                         out_dtype=out_dtype or x.dtype, impl=impl)
    else:
        w = leaf.reshape(K, -1)
        out_dtype = out_dtype or x.dtype
        # a product in the operands' own dtype already sums in fp32 and
        # rounds once; only a wider result needs the fp32-output product
        y = x2 @ w if out_dtype == x2.dtype == w.dtype else matmul_f32(x2, w).to(out_dtype)
    return y.reshape(x.shape[:-1] + tuple(out_shape))


def quantize_acts(x: torch.Tensor):
    """Per-token symmetric int8: [..., K] -> (int8 [..., K], fp32 row scales
    [..., 1]). Quantize once and share it across the weights that consume
    the same activations (q/k/v; gate/up)."""
    xf = x.float()
    xs = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    xq = torch.round(xf / xs).clamp(-127, 127).to(torch.int8)
    return xq, xs


def int8_matmul(a: torch.Tensor, b: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """a [M, K] int8 @ b [K, N] int8 -> the exact integer sums, as fp32
    rounded once from them (what a cast of the int32 result gives)."""
    return _int8_sums(a, b, impl).float()


def _int8_sums(a: torch.Tensor, b: torch.Tensor, impl: str) -> torch.Tensor:
    """a [M, K] int8 @ b [K, N] int8 -> the exact sums as int32.

    On the card ``torch._int_mm`` (more than 16 rows, K and N multiples of
    8, else it raises: no other route). It is handed ``b`` column-major, a
    copy made per call: on a row-major ``b`` cuBLASLt takes a WMMA kernel 6-7x
    slower (H100, [3968, 4096] @ [4096, 28672]: 7.25 ms against 1.13 ms plus
    0.85 ms for the copy), and the weight-only kernel wants the stored
    layout row-major. On the CPU, or with
    ``impl="plain"``, an exact product: int32 on the CPU; fp64 on the card,
    where no integer matmul exists and fp32 would round partial sums
    beyond 2^24 (K x 127 x 127 passes it from K = 1041)."""
    _check_impl(impl)
    if a.is_cuda and impl == "auto":
        M, K = a.shape
        if M <= 16 or K % 8 or b.shape[1] % 8:
            raise ValueError(
                f"int8_matmul on the card wants more than 16 rows and K, N "
                f"multiples of 8, got [{M}, {K}] @ {tuple(b.shape)}")
        return torch._int_mm(a, b.t().contiguous().t())
    if a.is_cuda:
        return (a.double() @ b.double()).to(torch.int32)
    return a.to(torch.int32) @ b.to(torch.int32)


def quant_apply_w8a8(xq, xs, leaf: dict, out_shape: tuple, *,
                     out_dtype=torch.bfloat16, impl: str = "auto") -> torch.Tensor:
    """s8 x s8 -> s32 product of quantized activations (``quantize_acts``)
    with an int8 leaf ``{'q': [K, *out], 's'}``, scaled by the row and then
    the column scales: ``(acc * xs) * s``, then the cast.

    A per-channel packed leaf ``{'qp': [K/2, N], 's'}`` takes the same
    product after an unpack to int8 (W4A8), as two products over the nibble
    halves, ``x[:, :K/2] @ lo + x[:, K/2:] @ hi``, summed as integers. A
    group-scaled packed leaf has no s8 x s8 form (its scale applies inside
    the contraction) and raises ``ValueError``: it is weight-only."""
    K = xq.shape[-1]
    x2 = xq.reshape(-1, K)
    if "qp" in leaf:
        if leaf["s"].numel() != leaf["qp"].shape[-1]:
            raise ValueError(
                "quant_apply_w8a8 does not take group-scaled packed-int4 leaves; "
                "use quant_apply (weight-only)")
        w = unpack4(leaf["qp"].reshape(K // 2, -1))  # [K, N]: low halves, then high
        acc = (_int8_sums(x2[:, : K // 2].contiguous(), w[: K // 2], impl)
               + _int8_sums(x2[:, K // 2:].contiguous(), w[K // 2:], impl)).float()
    else:
        acc = int8_matmul(x2, leaf["q"].reshape(K, -1), impl=impl)
    y = acc * xs.reshape(-1, 1) * leaf["s"].reshape(-1).float()[None, :]
    return y.to(out_dtype).reshape(xq.shape[:-1] + tuple(out_shape))
