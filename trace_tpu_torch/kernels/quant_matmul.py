"""Quantized weight products of the int8 and int4p serving paths: wrappers
of the CUDA kernels in csrc/quant_matmul.cu and csrc/quant_matmul_p4.cu,
their plain PyTorch versions, and the W8A8 / W4A8 product
(trace_tpu/kernels/quant_matmul.py).

``quant_matmul`` / ``quant_matmul_stacked`` compute ``y = (x @ q) * s`` with
int8 ``q`` and a per-column scale: the weight-only product of every decoder
projection of a T = 1 step (stacked: layer ``li`` of the whole ``[L, K, N]``
leaf, read in place) and of the quantized ``lm_head`` (2-D). Bound on an
H100: bytes, one streaming read of K x N int8; see the source for the
design. Each has two forms: up to 8 rows of x (``"splitk"``, a decode step
at batch <= 8) and the wide tile of 32 rows for more (``"wide"``, the
bench's decode batch of 32), both reading the weight once for every tile.
On a CUDA tensor a wrapper launches its kernel or raises; the plain
version runs for CPU tensors, or when the caller passes ``impl="plain"``.
Launches are counted in ``quant_matmul.launches`` and
``quant_matmul_stacked.launches``, and by form in ``launches_by_form``.

``quant_matmul_p4`` / ``quant_matmul_p4_grouped`` (and their ``_stacked``
entries) are the weight-only products of nibble-packed int4 leaves ``{'qp',
's'}``: byte ``qp[k, n]`` holds weight rows ``k`` (low nibble) and ``k + K/2``
(high nibble). Per channel (``s`` [N]) the scale multiplies the fp32 sum once;
grouped (``s`` [K / 128, N]) each weight is ``nibble * s`` rounded to x's
dtype before the product. Each kernel has a split-K form for up to 8 rows of
x (a decode step, bound by bytes) and a tensor-core form beyond (prefill,
bound by operations); ``launches`` counts both, ``launches_by_form`` each.

Every wrapper makes one launch that allocates only its output: the split-K
forms reduce over K inside a cluster of blocks (``split_plan``), so a call
can be captured in a CUDA graph.

fp32 x (a model served in fp32) takes the fp32 forms of every entry. Every
weight is exact in TF32 (an int8, a nibble, or a nibble times a bf16 scale),
so x is split into two TF32 parts and each product runs as two TF32
products with fp32 sums; only the order of the sums differs from the plain
version. Up to 8 rows of x (``"splitk"``) the fp32 instances of the split
form (csrc/qmm_split.cuh through the ``_f32`` entries of quant_matmul.cu and
quant_matmul_p4.cu, planned by ``split_plan`` as forms "i8f", "p4f" and
"p4gf"): one launch that allocates only y, as a bf16 call; beyond, the
tensor-core form of csrc/quant_matmul_f32.cu (``"tiled"``, two TF32
``wgmma`` products). The grouped fp32 forms take any even number of groups
dividing K. Their launches are counted in ``<wrapper>.launches_f32`` and by
form in ``launches_f32_by_form`` (``"splitk"``, ``"tiled"``).

The W8A8 product (``quantize_acts`` + ``quant_apply_w8a8``: prefill and ViT
projections) is a plain s8 x s8 -> s32 matrix product, which the JAX package
leaves to XLA outside any Pallas kernel; here it is ``torch._int_mm`` on the
card and an exact integer product elsewhere, with the epilogue in torch. A
per-channel packed leaf takes it as two products over its nibble halves
(W4A8).
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from trace_tpu_torch.kernels.build import count_launch
from trace_tpu_torch.model.quantize import unpack4

_SOURCE = "quant_matmul.cu"
_SOURCE_P4 = "quant_matmul_p4.cu"
_SOURCE_F32 = "quant_matmul_f32.cu"
# the split form's launch (csrc/qmm_split.cuh: STRIP, MT, MAX_CLUSTER,
# Layout<F, MT, X>::SMEM); a rank takes at least one stage of rows. Forms:
# "i8" (int8, tiles of SPLIT_ROWS rows of bf16 x), "i8w" (int8, the wide tile
# of SPLIT_WIDE_ROWS rows, for M > SPLIT_ROWS), "p4" and "p4g" (packed, per
# channel and grouped, tiles of SPLIT_ROWS; M <= SPLIT_ROWS only), and the
# fp32 instances "i8f", "p4f" and "p4gf" (fp32 x, M <= SPLIT_ROWS)
SPLIT_STRIP = 128
SPLIT_ROWS = 8
SPLIT_WIDE_ROWS = 32
SPLIT_MAX_CLUSTER = 8
SPLIT_MIN_SHARE = 128
SPLIT_SMEM = {"i8": 97500, "i8w": 91812, "p4": 107740, "p4g": 112860,
              "i8f": 107740, "p4f": 103632, "p4gf": 107728}
# the fp32 forms: up to SPLIT_ROWS rows of x the split form's fp32 instance
# (source, 2-D entry, stacked entry), beyond the tensor-core form of
# _SOURCE_F32 (its form code)
_F32_SPLIT = {"i8f": (_SOURCE, "quant_matmul_i8_f32", "quant_matmul_stacked_i8_f32"),
              "p4f": (_SOURCE_P4, "quant_matmul_p4_f32", "quant_matmul_p4_stacked_f32"),
              "p4gf": (_SOURCE_P4, "quant_matmul_p4_grouped_f32",
                       "quant_matmul_p4_grouped_stacked_f32")}
_F32_TILED = {"i8f": 0, "p4f": 1, "p4gf": 2}
_ENTRIES: dict = {}  # C entry name -> its declared ctypes function
_FIT: dict = {}      # (form, device index) -> clusters the card holds at once
_FIT_LOCK = threading.Lock()


def _check_impl(impl: str) -> None:
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")


class _MmF32(torch.autograd.Function):
    """bf16 [M, K] @ bf16 [K, N] -> fp32 on the card. The backward rounds the
    fp32 cotangent to bf16 and takes both products in bf16 with fp32 sums; the
    results are bf16, as JAX's transpose of a bf16-in / fp32-out ``dot_general``
    rounds them (JAX keeps the cotangent in fp32 for the products)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gb = g.to(torch.bfloat16)
        dx = gb @ w.t() if ctx.needs_input_grad[0] else None
        dw = x.t() @ gb if ctx.needs_input_grad[1] else None
        return dx, dw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ w [K, N] with an fp32 sum and an fp32 result (JAX's
    ``preferred_element_type=float32``). bf16 operands on the card go to
    one product with an fp32 output, so no fp32 copy of the weight is held;
    elsewhere the operands are widened first."""
    if x.is_cuda and x.dtype == w.dtype == torch.bfloat16:
        return _MmF32.apply(x, w)
    return x.float() @ w.float()


def quant_matmul_plain(x, q, s, out_dtype=None):
    """((x @ q) -> fp32 sum) * s, the scale applied once on the sum. Every
    int8 is exact in x's dtype, so the products are those of the kernel."""
    y = (x.float() @ q.float()) * s.reshape(-1).float()[None, :]
    return y.to(out_dtype or x.dtype)


class SplitPlan(NamedTuple):
    """One launch of a split weight product (csrc/qmm_split.cuh): a grid of
    ``cluster x strips x row_tiles`` blocks, clusters of ``cluster`` blocks
    along the weight rows, rank r taking rows [r share, (r + 1) share)."""

    cluster: int    # blocks of a cluster, one per share of the weight rows
    share: int      # weight rows (packed rows) a rank, a multiple of its k-step
    strips: int     # clusters across N, SPLIT_STRIP columns each
    row_tiles: int  # tiles of ``tile`` rows of x, each reading the weight
    smem: int       # bytes of shared memory a block
    tile: int       # rows of x a block: SPLIT_ROWS, or SPLIT_WIDE_ROWS ("i8w")

    @property
    def blocks(self) -> int:
        return self.cluster * self.strips * self.row_tiles


def int8_split_form(M: int) -> str:
    """The int8 product's form for M rows of x: "i8" up to SPLIT_ROWS,
    the wide tile "i8w" beyond."""
    return "i8w" if M > SPLIT_ROWS else "i8"


def split_plan(M: int, K: int, N: int, form: str, clusters_at_once) -> SplitPlan:
    """The launch of a split weight product (``form``: "i8", "i8w", "p4",
    "p4g", or the fp32 instances "i8f", "p4f", "p4gf") for x [M, K]: the
    largest cluster (up to the portable 8, each rank at least SPLIT_MIN_SHARE
    rows) whose clusters all run at once, ``clusters_at_once(c)`` being how
    many clusters of c blocks the form's kernel holds on the card; a cluster
    of 1 where none does. Shares are whole k-steps (16 int8 rows with bf16
    x, else 8 rows or packed rows)."""
    rows = K // 2 if form.startswith("p4") else K
    step = 16 if form in ("i8", "i8w") else 8
    tile = SPLIT_WIDE_ROWS if form == "i8w" else SPLIT_ROWS
    strips, row_tiles = -(-N // SPLIT_STRIP), -(-M // tile)
    cluster = 1
    for c in range(min(SPLIT_MAX_CLUSTER, -(-rows // SPLIT_MIN_SHARE)), 1, -1):
        if strips * row_tiles <= clusters_at_once(c):
            cluster = c
            break
    per_rank = -(-rows // cluster)
    share = -(-per_rank // step) * step
    return SplitPlan(cluster, share, strips, row_tiles, SPLIT_SMEM[form], tile)


# the int8 forms' C entries (2-D, stacked) and keys of ``launches_by_form``
_I8_ENTRY = {"i8": ("quant_matmul_i8", "quant_matmul_stacked_i8"),
             "i8w": ("quant_matmul_i8_wide", "quant_matmul_stacked_i8_wide")}
_I8_FORM = {"i8": "splitk", "i8w": "wide"}


def _check_operands(entry: str, x, q, s, out_dtype, x_dtype=torch.bfloat16) -> None:
    """What every weight-product kernel takes: x of ``x_dtype`` (bf16, or
    fp32 for the fp32 forms), int8 weight bytes and a bf16 scale, contiguous
    on x's card; a bf16 or fp32 output."""
    if x.dtype != x_dtype or s.dtype != torch.bfloat16 or q.dtype != torch.int8:
        raise TypeError(f"{entry}: wants {x_dtype} x, an int8 weight and a bf16 scale, got "
                        f"{x.dtype}, {q.dtype}, {s.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{entry}: out_dtype must be bf16 or fp32, got {out_dtype}")
    for name, t in (("x", x), ("weight", q), ("scale", s)):
        if not t.is_cuda or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{entry}: {name} must be contiguous on {x.device}")


def _entry(source: str, name: str, lead: int):
    """The C entry ``name`` of ``source``, its ctypes signature declared once:
    x, weight, scale, ``lead`` ints, y, M, K, N, cluster, share, out_f32,
    stream."""
    fn = _ENTRIES.get(name)
    if fn is None:
        from trace_tpu_torch.kernels.build import load

        fn = getattr(load(source), name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * lead + [ctypes.c_void_p]
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        _ENTRIES[name] = fn
    return fn


def _plan(form: str, M: int, K: int, N: int, device) -> SplitPlan:
    """``split_plan`` for the card of ``device``; how many clusters of each
    size its split kernel holds at once is asked once per form and card."""
    key = (form, device.index)
    fit = _FIT.get(key) or _ask_fit(form, key, device)
    return split_plan(M, K, N, form, fit.__getitem__)


def _ask_fit(form: str, key, device) -> list:
    """Ask the card how many clusters of each size it holds at once, once:
    the lock makes a second thread that arrives meanwhile read the answer."""
    with _FIT_LOCK:
        fit = _FIT.get(key)
        if fit is not None:
            return fit
        from trace_tpu_torch.kernels.build import load

        if form.startswith("i8"):
            lib = load(_SOURCE)
            ask = {"i8": lib.quant_matmul_clusters_at_once,
                   "i8w": lib.quant_matmul_wide_clusters_at_once,
                   "i8f": lib.quant_matmul_f32_clusters_at_once}[form]
            lead = ()
        else:
            lib = load(_SOURCE_P4)
            ask = (lib.quant_matmul_p4_f32_clusters_at_once if form.endswith("f")
                   else lib.quant_matmul_p4_clusters_at_once)
            lead = (int(form.startswith("p4g")),)
        ask.restype = ctypes.c_int
        ask.argtypes = [ctypes.c_int] * (len(lead) + 1)
        with torch.cuda.device(device):
            fit = [0] + [ask(*lead, c) for c in range(1, SPLIT_MAX_CLUSTER + 1)]
        if min(fit) < 0:
            raise RuntimeError(f"{form} split kernel: CUDA error {-min(fit)} asking its occupancy")
        _FIT[key] = fit
        return fit


def _launch(source: str, entry: str, x, q, s, lead_args, M, K, N, out_dtype, plan=None,
            x_dtype=torch.bfloat16):
    """One launch of a weight-product entry point: the split form with
    ``plan``, else (the packed entries' tensor-core form) none. Only y is
    allocated."""
    from trace_tpu_torch.kernels.build import check

    _check_operands(entry, x, q, s, out_dtype, x_dtype)
    fn = _entry(source, entry, len(lead_args))
    y = torch.empty((M, N), dtype=out_dtype, device=x.device)
    err = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), *lead_args, y.data_ptr(), M, K, N,
             plan.cluster if plan else 0, plan.share if plan else 0,
             int(out_dtype == torch.float32), torch.cuda.current_stream(x.device).cuda_stream)
    check(err, entry)
    return y


def _count(fn, form: str) -> None:
    count_launch(fn)
    count_launch(fn, "launches_by_form", form)


def _launch_f32(fn, form: str, x, w, s, M, K, N, out_dtype, li=None, groups: int = 0):
    """One call of the fp32 form ``form`` ("i8f", "p4f", "p4gf") on weight
    ``w`` and scale ``s``: the whole layer stack, read in place at layer
    ``li``, or the 2-D leaf where ``li`` is None. Up to SPLIT_ROWS rows of x
    the split form's fp32 instance, beyond the tensor-core form; only y is
    allocated; counted on ``fn``."""
    from trace_tpu_torch.kernels.build import check, load

    if M <= SPLIT_ROWS:
        source, flat, stacked = _F32_SPLIT[form]
        lead = (() if li is None else (int(li), w.shape[0])) + ((groups,) if groups else ())
        y = _launch(source, flat if li is None else stacked, x, w, s, lead, M, K, N, out_dtype,
                    _plan(form, M, K, N, x.device), x_dtype=torch.float32)
        kind = "splitk"
    else:
        if li is not None:
            w, s = w[li], s[li]
        _check_operands("quant_matmul_f32_tiled", x, w, s, out_dtype, torch.float32)
        entry = _ENTRIES.get("quant_matmul_f32_tiled")
        if entry is None:
            entry = load(_SOURCE_F32).quant_matmul_f32_tiled
            entry.restype = ctypes.c_int
            entry.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            _ENTRIES["quant_matmul_f32_tiled"] = entry
        y = torch.empty((M, N), dtype=out_dtype, device=x.device)
        check(entry(x.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(), M, K, N,
                    _F32_TILED[form], groups or 1, int(out_dtype == torch.float32),
                    torch.cuda.current_stream(x.device).cuda_stream), "quant_matmul_f32_tiled")
        kind = "tiled"
    count_launch(fn, "launches_f32")
    count_launch(fn, "launches_f32_by_form", kind)
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
    N = q.shape[1]
    if x.dtype == torch.float32:
        return _launch_f32(quant_matmul, "i8f", x, q, s.reshape(-1), M, K, N,
                           out_dtype or x.dtype)
    form = int8_split_form(M)
    y = _launch(_SOURCE, _I8_ENTRY[form][0], x, q, s.reshape(-1), (), M, K, N,
                out_dtype or x.dtype, _plan(form, M, K, N, x.device))
    _count(quant_matmul, _I8_FORM[form])
    return y


quant_matmul.launches = 0
quant_matmul.launches_by_form = {"splitk": 0, "wide": 0}
quant_matmul.launches_f32 = 0
quant_matmul.launches_f32_by_form = {"splitk": 0, "tiled": 0}


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
    if x.dtype == torch.float32:
        return _launch_f32(quant_matmul_stacked, "i8f", x, q, s, M, K, N, out_dtype or x.dtype,
                           li=li)
    form = int8_split_form(M)
    y = _launch(_SOURCE, _I8_ENTRY[form][1], x, q, s, (int(li), L), M, K, N,
                out_dtype or x.dtype, _plan(form, M, K, N, x.device))
    _count(quant_matmul_stacked, _I8_FORM[form])
    return y


quant_matmul_stacked.launches = 0
quant_matmul_stacked.launches_by_form = {"splitk": 0, "wide": 0}
quant_matmul_stacked.launches_f32 = 0
quant_matmul_stacked.launches_f32_by_form = {"splitk": 0, "tiled": 0}


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


def _launch_p4(entry: str, x, qp, s, lead_args, M, K, N, out_dtype, grouped: bool):
    """One launch of a packed-int4 entry point of csrc/quant_matmul_p4.cu;
    returns (y, form): the split form up to SPLIT_ROWS rows of x, the
    tensor-core form beyond."""
    if M > SPLIT_ROWS:
        return _launch(_SOURCE_P4, entry, x, qp, s, lead_args, M, K, N, out_dtype), "mma"
    plan = _plan("p4g" if grouped else "p4", M, K, N, x.device)
    return _launch(_SOURCE_P4, entry, x, qp, s, lead_args, M, K, N, out_dtype, plan), "splitk"


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
    if x.dtype == torch.float32:
        return _launch_f32(quant_matmul_p4, "p4f", x, qp, s.reshape(-1), x.shape[0],
                           x.shape[1], N, out_dtype or x.dtype)
    y, form = _launch_p4("quant_matmul_p4_bf16", x, qp, s.reshape(-1), (),
                         x.shape[0], x.shape[1], N, out_dtype or x.dtype, False)
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
    if x.dtype == torch.float32:
        return _launch_f32(quant_matmul_p4, "p4f", x, qp, s, x.shape[0], x.shape[1], N,
                           out_dtype or x.dtype, li=li)
    y, form = _launch_p4("quant_matmul_p4_stacked_bf16", x, qp, s, (int(li), L),
                         x.shape[0], x.shape[1], N, out_dtype or x.dtype, False)
    _count(quant_matmul_p4, form)
    return y


quant_matmul_p4.launches = 0
quant_matmul_p4.launches_by_form = {"splitk": 0, "mma": 0}
quant_matmul_p4.launches_f32 = 0
quant_matmul_p4.launches_f32_by_form = {"splitk": 0, "tiled": 0}


def quant_matmul_p4_grouped(
    x: torch.Tensor,    # [M, K]
    qp: torch.Tensor,   # [K/2, N] nibble-packed int8
    s: torch.Tensor,    # [G, N] per (group of K / G rows, column) scale, G even
    *,
    out_dtype=None,
    impl: str = "auto",
) -> torch.Tensor:
    """y [M, N] = x @ (unpack4(qp) scaled per group and rounded to x's dtype).
    The plain version and the fp32 forms take any even G dividing K; the
    bf16 kernel groups of 128."""
    _check_impl(impl)
    N = _check_p4(x, qp)
    K = x.shape[1]
    if s.ndim != 2 or s.shape[1] != N:
        raise ValueError(f"shapes qp {tuple(qp.shape)} s {tuple(s.shape)}")
    _check_groups(K, s.shape[0])
    if impl == "plain" or not x.is_cuda:
        return quant_matmul_p4_grouped_plain(x, qp, s, out_dtype)
    if x.dtype == torch.float32:  # any even number of groups dividing K
        return _launch_f32(quant_matmul_p4_grouped, "p4gf", x, qp, s, x.shape[0], K, N,
                           out_dtype or x.dtype, groups=s.shape[0])
    if s.shape[0] * 128 != K:
        raise ValueError(f"the kernel wants groups of 128 rows, got G={s.shape[0]} for K={K}")
    y, form = _launch_p4("quant_matmul_p4_grouped_bf16", x, qp, s, (),
                         x.shape[0], K, N, out_dtype or x.dtype, True)
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
    if x.dtype == torch.float32:
        return _launch_f32(quant_matmul_p4_grouped, "p4gf", x, qp, s, x.shape[0], K, N,
                           out_dtype or x.dtype, li=li, groups=s.shape[1])
    if s.shape[1] * 128 != K:
        raise ValueError(f"the kernel wants groups of 128 rows, got G={s.shape[1]} for K={K}")
    y, form = _launch_p4("quant_matmul_p4_grouped_stacked_bf16", x, qp, s, (int(li), L),
                         x.shape[0], K, N, out_dtype or x.dtype, True)
    _count(quant_matmul_p4_grouped, form)
    return y


quant_matmul_p4_grouped.launches = 0
quant_matmul_p4_grouped.launches_by_form = {"splitk": 0, "mma": 0}
quant_matmul_p4_grouped.launches_f32 = 0
quant_matmul_p4_grouped.launches_f32_by_form = {"splitk": 0, "tiled": 0}


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


def quantize_acts(x: torch.Tensor, amax_reduce=None):
    """Per-token symmetric int8: [..., K] -> (int8 [..., K], fp32 row scales
    [..., 1]). Quantize once and share it across the weights that consume
    the same activations (q/k/v; gate/up). ``amax_reduce`` maps the row
    maxima of this slice of K to those of the whole row (tensor parallelism:
    a max over the ranks that hold the other slices)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    if amax_reduce is not None:
        amax = amax_reduce(amax)
    xs = amax.clamp_min(1e-8) / 127.0
    xq = torch.round(xf / xs).clamp(-127, 127).to(torch.int8)
    return xq, xs


def int8_matmul(a: torch.Tensor, b: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """a [M, K] int8 @ b [K, N] int8 -> the exact integer sums, as fp32
    rounded once from them (what a cast of the int32 result gives)."""
    return _int8_sums(a, b, impl).float()


def pad_for_int_mm(a: torch.Tensor, b: torch.Tensor):
    """a [M, K] and b [K, N] int8 zero-padded to what ``torch._int_mm`` takes:
    more than 16 rows of a, K and N multiples of 8. The zero terms leave the
    integer sums exact, so the product sliced back to [M, N] is the product
    of the unpadded operands, bit for bit."""
    M, K = a.shape
    N = b.shape[1]
    Mp, Kp, Np = max(M, 17), -(-K // 8) * 8, -(-N // 8) * 8
    if (Mp, Kp) != (M, K):
        a = torch.nn.functional.pad(a, (0, Kp - K, 0, Mp - M))
    if (Kp, Np) != (K, N):
        b = torch.nn.functional.pad(b, (0, Np - N, 0, Kp - K))
    return a, b


def _int8_sums(a: torch.Tensor, b: torch.Tensor, impl: str) -> torch.Tensor:
    """a [M, K] int8 @ b [K, N] int8 -> the exact sums as int32.

    On the card ``torch._int_mm`` on the operands zero-padded by
    ``pad_for_int_mm`` (it takes more than 16 rows, K and N multiples of 8),
    sliced back to [M, N]. It is handed ``b`` column-major, a copy made per
    call: on a row-major ``b`` cuBLASLt takes a WMMA kernel 6-7x slower (H100,
    [3968, 4096] @ [4096, 28672]: 7.25 ms against 1.13 ms plus 0.85 ms for the
    copy), and the weight-only kernel wants the stored layout row-major. On
    the CPU, or with ``impl="plain"``, an exact product: int32 on the CPU;
    fp64 on the card, where no integer matmul exists and fp32 would round
    partial sums beyond 2^24 (K x 127 x 127 passes it from K = 1041)."""
    _check_impl(impl)
    if a.is_cuda and impl == "auto":
        ap, bp = pad_for_int_mm(a, b)
        return torch._int_mm(ap, bp.t().contiguous().t())[: a.shape[0], : b.shape[1]]
    if a.is_cuda:
        return (a.double() @ b.double()).to(torch.int32)
    return a.to(torch.int32) @ b.to(torch.int32)


def quant_apply_w8a8(xq, xs, leaf: dict, out_shape: tuple, *,
                     out_dtype=torch.bfloat16, impl: str = "auto",
                     reduce=None) -> torch.Tensor:
    """s8 x s8 -> s32 product of quantized activations (``quantize_acts``)
    with an int8 leaf ``{'q': [K, *out], 's'}``, scaled by the row and then
    the column scales: ``(acc * xs) * s``, then the cast.

    A per-channel packed leaf ``{'qp': [K/2, N], 's'}`` takes the same
    product after an unpack to int8 (W4A8), as two products over the nibble
    halves, ``x[:, :K/2] @ lo + x[:, K/2:] @ hi``, summed as integers. A
    group-scaled packed leaf has no s8 x s8 form (its scale applies inside
    the contraction) and raises ``ValueError``: it is weight-only.
    ``reduce`` maps the integer sums over this slice of K to those over the
    whole of K before the scales apply (tensor parallelism: a sum over the
    ranks)."""
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
    if reduce is not None:
        acc = reduce(acc)
    y = acc * xs.reshape(-1, 1) * leaf["s"].reshape(-1).float()[None, :]
    return y.to(out_dtype).reshape(xq.shape[:-1] + tuple(out_shape))
