"""Decode-step attention over one layer's KV-cache stripe: wrapper of the
CUDA kernels in csrc/decode_attention.cu (bf16 or fp32 cache) and
csrc/decode_attention_int8.cu (int8 cache), and their plain PyTorch versions.
(The kernels are in csrc/decode_bf16.cuh and csrc/decode_int8.cuh; each
source's ``*_pad.cu`` twin holds their instances at head dims other than 64
and 128 up to 128, its ``*_256.cu`` and ``*_256_pad.cu`` twins those at hd
256 and at 132 ... 252.)

Replaces trace_tpu/kernels/decode_attention.py ``decode_attention`` with its
bodies ``_kernel_bf16``, ``_kernel_int8_s8dot`` / ``_kernel_int8_s8dot_stacked``
(``mode="s8dot"``, the default; the two compute one function) and
``_kernel_int8`` (``mode="dequant"``). There the layer index selects the
stripe of the stacked [L, B, NKV, S, hd] cache through a scalar-prefetch
index map; in torch ``cache_k[li]`` is already a contiguous [B, NKV, S, hd]
view, and the kernels read that view in place.

Bound on an H100: bytes. Each (batch row, kv head) stripe is read once for
its G query rows (~G / 2 flops per byte, far below the card's ~295). Neither
kernel can run in one online pass: the bf16 body rounds ``exp(s - m)`` to
bf16 under the row's final max, and s8dot quantizes ``p * vs`` by its
maximum over all slots of the row. Each runs as one cluster launch: a
cluster of up to 8 blocks per (batch row, kv head) splits the slots, reads
the K and V rows of the visible ones only, and the blocks exchange the
row's statistics (the max first), then their partial outputs, through
distributed shared memory; the wrapper allocates only the output. See the
sources. A launch takes G = 1 ... 8 query rows a kv head at hd above 64 (1,
2 or 4 at hd <= 64); the wrapper splits a larger group (any G, as the TPU
kernel takes) into launches of at most that many rows, each on a contiguous
copy of its rows of q, and writes each launch's rows into the output.

Head dims: the kernels are built at HD = 64 and 128, and for a bf16 query
(over the bf16 cache or the int8 one) at 256; they take any hd that is a
multiple of 4 up to 256 with a bf16 query (``MAX_HEAD_DIM``: the published
head dims 64, 72, 80, 96, 100, 112, 128, 256) and up to 128 with an fp32 one
(``MAX_HEAD_DIM_NARROW``); any other raises a ``ValueError`` that names the
limit (``check_head_dim``). Another hd runs at the next width (64, 128 or
256) with no copy of the cache: the kernel reads rows of hd values in place
and zero-fills the rest of each row as it lands in shared memory (cp.async's
source size, in pieces of 16, 8 or 4 bytes as the rows' alignment allows);
it writes only the output's hd columns.

An fp32 query (a model served in fp32) takes the fp32 instances of the same
two kernels, over an fp32 cache or the int8 one: the same cluster launch on
4-byte elements, p unrounded over an fp32 cache, q quantized from its fp32
values (s8dot) or rounded to bf16 (dequant) over the int8 one, the output
in fp32; the wrapper allocates only the output here too.

On a CUDA tensor the wrapper launches its kernel or raises; the plain
version runs for CPU tensors, or when the caller passes ``impl="plain"``.
Launches are counted in ``decode_attention.launches`` (bf16 cache),
``decode_attention.launches_int8`` (int8 cache, ``{"s8dot": n, "dequant": n}``),
and for the fp32 forms in ``decode_attention.launches_f32`` (fp32 cache) and
``decode_attention.launches_int8_f32``.
"""

from __future__ import annotations

import ctypes

import torch

from trace_tpu_torch.kernels.build import count_launch
from trace_tpu_torch.kernels.flash_attention import MAX_HEAD_DIM, MAX_HEAD_DIM_NARROW

_SOURCE = "decode_attention.cu"
_SOURCE_INT8 = "decode_attention_int8.cu"
INT8_MODES = ("s8dot", "dequant")
MAX_GROUP = 8  # query rows a kv head that one launch takes (hd above 64)


def _source(name: str, hd: int) -> str:
    """The library of a decode source that holds head dim ``hd``: the source
    itself at 64 and 128, its ``*_pad.cu`` twin at the other head dims up to
    128, its ``*_256.cu`` twin at 256 and ``*_256_pad.cu`` between 128 and
    256."""
    wide = "_256" if hd > 128 else ""
    pad = "" if hd in (64, 128, 256) else "_pad"
    return name.replace(".cu", f"{wide}{pad}.cu")


def grouped_attention(q, k, v, bias):
    """q [B,NH,T,hd]; k,v [B,NKV,S,hd]; bias [B,1,T,S] additive fp32.

    Port of ``_attention`` of trace_tpu/model/mistral.py (GQA through a
    reshape to groups; fp32 scores, probabilities cast to v's dtype)."""
    B, NH, T, HD = q.shape
    NKV = k.shape[1]
    G = NH // NKV
    qg = q.reshape(B, NKV, G, T, HD)
    scores = torch.einsum("bngth,bnsh->bngts", qg.float(), k.float())
    scores = scores * (HD ** -0.5)
    scores = scores + bias.float()[:, :, None, :, :]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bngts,bnsh->bngth", probs.float(), v.float())
    return out.reshape(B, NH, T, HD).to(q.dtype)


def decode_attention_bf16(q, k, v, bias_row):
    """Plain version of ``_kernel_bf16``: fp32 scores, ``p = exp(s - m)``
    under the row max, l summed in fp32 over the unrounded p, p cast to v's
    dtype (bf16 for a bf16 cache) before P.V with fp32 sums, then divided by
    max(l, 1e-30) and cast to q's dtype. q [B,H,1,hd]; k, v [B,NKV,S,hd];
    bias_row [B,S] additive."""
    B, H, _, hd = q.shape
    NKV = k.shape[1]
    qg = q.float().reshape(B, NKV, H // NKV, hd)
    s = _gqa_scores(qg, k.float()) * (hd ** -0.5) + bias_row.float()[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bngs,bnsh->bngh", p.to(v.dtype).float(), v.float())
    o = o / l.clamp_min(1e-30)
    return o.to(q.dtype).reshape(B, H, 1, hd)


def _gqa_scores(qg, k):
    """qg [B,NKV,G,hd] . k [B,NKV,S,hd] -> [B,NKV,G,S], in the operands' dtype."""
    return torch.einsum("bngh,bnsh->bngs", qg, k)


def decode_attention_int8_s8dot(q, kq, ks, vq, vs, bias_row):
    """Plain version of the s8dot bodies: the q rows and ``p * vs`` are
    quantized to int8 (scale = max * (1/127), a multiply by the fp32
    constant; true divisions; round half to even) and both products are
    integer sums, taken here in fp64, which is exact (|sum| < 2^53) where
    fp32 is not (S x 127 x 127 passes 2^24 from S = 1041)."""
    B, H, _, hd = q.shape
    NKV = kq.shape[1]
    qf = q.float().reshape(B, NKV, H // NKV, hd)
    qs = qf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) * (1.0 / 127.0)
    qq = torch.round(qf / qs).clamp(-127, 127)
    s32 = _gqa_scores(qq.double(), kq.double())
    s = s32.float() * (qs * (hd ** -0.5)) * ks.float() + bias_row[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = p * vs.float()
    ps = pv.amax(dim=-1, keepdim=True).clamp_min(1e-30) * (1.0 / 127.0)
    pq = torch.round(pv / ps).clamp(-127, 127)
    o32 = torch.einsum("bngs,bnsh->bngh", pq.double(), vq.double())
    o = o32.float() * ps / l.clamp_min(1e-30)
    return o.to(q.dtype).reshape(B, H, 1, hd)


def decode_attention_int8_dequant(q, kq, ks, vq, vs, bias_row):
    """Plain version of the dequantizing body: K/V as bf16 values, fp32
    sums, the weights ``bf16(p) * vs`` rounded to bf16 before P.V."""
    B, H, _, hd = q.shape
    NKV = kq.shape[1]
    qg = q.to(torch.bfloat16).float().reshape(B, NKV, H // NKV, hd)
    s = _gqa_scores(qg, kq.float()) * ks.float() * (hd ** -0.5)
    s = s + bias_row[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    w = p.to(torch.bfloat16) * vs.to(torch.bfloat16)
    o = torch.einsum("bngs,bnsh->bngh", w.float(), vq.float()) / l.clamp_min(1e-30)
    return o.to(q.dtype).reshape(B, H, 1, hd)


_PLAIN_INT8 = {"s8dot": decode_attention_int8_s8dot,
               "dequant": decode_attention_int8_dequant}


def check_head_dim(hd: int, dtype=torch.bfloat16) -> None:
    """A ``ValueError`` unless the decode kernels take head dim ``hd`` with a
    query of ``dtype``: multiples of 4 up to ``MAX_HEAD_DIM`` with a bf16
    query, up to ``MAX_HEAD_DIM_NARROW`` with an fp32 one (the fp32 cache,
    or the int8 one with an fp32 query)."""
    f32 = dtype == torch.float32
    limit = MAX_HEAD_DIM_NARROW if f32 else MAX_HEAD_DIM
    if not (0 < hd <= limit and hd % 4 == 0):
        raise ValueError(f"head dim {hd}: the {'fp32' if f32 else 'bf16'}-query decode "
                         f"attention kernels take multiples of 4 up to {limit}")


def row_alignment(row_bytes: int) -> int:
    """The alignment the kernels need of a cache stripe whose rows hold
    ``row_bytes``: the largest of 16, 8 and 4 that divides a row."""
    return next(a for a in (16, 8, 4) if row_bytes % a == 0)


def group_splits(G: int, hd: int) -> list:
    """The query rows of a kv head as the launches take them: [(g0, n)],
    each n a group the kernels take (1 ... 8 at hd above 64, run at width
    128 or 256; 1, 2 or 4 at hd <= 64), the largest first."""
    sizes = range(MAX_GROUP, 0, -1) if hd > 64 else (4, 2, 1)
    splits, g0 = [], 0
    while g0 < G:
        n = next(size for size in sizes if size <= G - g0)
        splits.append((g0, n))
        g0 += n
    return splits


def _by_groups(q, NKV: int, launch):
    """``launch(q_part, G_part)`` over the group splits of q [B, H, 1, hd]:
    q itself where one launch takes the whole group, else each split's rows
    of every kv head, copied contiguous, their output written into o's."""
    B, H, _, hd = q.shape
    G = H // NKV
    splits = group_splits(G, hd)
    if len(splits) == 1:
        return launch(q, G)
    o = torch.empty_like(q)
    qg, og = q.view(B, NKV, G, hd), o.view(B, NKV, G, hd)
    for g0, n in splits:
        part = launch(qg[:, :, g0:g0 + n].contiguous().view(B, NKV * n, 1, hd), n)
        og[:, :, g0:g0 + n] = part.view(B, NKV, n, hd)
    return o


def _decode_attention_int8(q, cache: dict, bias_row, mode: str, impl: str):
    if mode not in INT8_MODES:
        raise ValueError(f"mode must be one of {INT8_MODES}, got {mode!r}")
    kq, ks, vq, vs = (cache[name] for name in ("kq", "ks", "vq", "vs"))
    if impl == "plain" or not q.is_cuda:
        return _PLAIN_INT8[mode](q, kq, ks, vq, vs, bias_row)
    B, H, T, hd = q.shape
    _, NKV, S, _ = kq.shape
    if T != 1 or kq.shape != (B, NKV, S, hd) or vq.shape != kq.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} cache {tuple(kq.shape)}")
    if ks.shape != (B, NKV, 1, S) or vs.shape != ks.shape:
        raise ValueError(f"scales must be [B, NKV, 1, S], got {tuple(ks.shape)}")
    check_head_dim(hd, q.dtype)
    if H % NKV:
        raise ValueError(f"unsupported heads {H}/{NKV}")
    f32 = q.dtype == torch.float32
    for name, x, dtype in (("q", q, torch.float32 if f32 else torch.bfloat16),
                           ("kq", kq, torch.int8),
                           ("vq", vq, torch.int8), ("ks", ks, torch.bfloat16),
                           ("vs", vs, torch.bfloat16), ("bias_row", bias_row, torch.float32)):
        if x.dtype != dtype or not x.is_contiguous() or x.device != q.device:
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {q.device}")
    for name, x in (("kq", kq), ("vq", vq)):
        if x.data_ptr() % row_alignment(hd):
            raise ValueError(f"{name}: data pointer not {row_alignment(hd)}-byte aligned")
    if bias_row.shape != (B, S):
        raise ValueError("bias_row must be [B, S]")

    from trace_tpu_torch.kernels.build import check, load

    name = f"decode_attn_int8_f32_{mode}" if f32 else f"decode_attn_int8_{mode}"
    fn = getattr(load(_source(_SOURCE_INT8, hd)), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]

    def launch(qp, G):
        o = torch.empty_like(qp)  # the kernel's only allocation, no workspace
        err = fn(
            qp.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(),
            bias_row.data_ptr(), o.data_ptr(), B, NKV, G, S, hd, float(hd ** -0.5),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        check(err, name)
        count_launch(decode_attention, "launches_int8_f32" if f32 else "launches_int8", mode)
        return o

    return _by_groups(q, NKV, launch)


def decode_attention(
    q: torch.Tensor,         # [B, H, 1, hd]
    cache_k,                 # [B, NKV, S, hd], one layer's stripe; or the int8
                             # stripe {kq, vq [B,NKV,S,hd] int8, ks, vs [B,NKV,1,S] bf16}
    cache_v,                 # [B, NKV, S, hd] (None with an int8 stripe)
    bias_row: torch.Tensor,  # [B, S] additive fp32 (0 visible / -1e30 masked)
    *,
    mode: str = "s8dot",
    impl: str = "auto",
) -> torch.Tensor:
    """One decode step of attention. Returns [B, H, 1, hd] in q's dtype.
    ``mode`` selects the int8 body and is not read for a bf16 cache."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    if isinstance(cache_k, dict):
        return _decode_attention_int8(q, cache_k, bias_row, mode, impl)
    if impl == "plain" or not q.is_cuda:
        return decode_attention_bf16(q, cache_k, cache_v, bias_row)
    B, H, T, hd = q.shape
    _, NKV, S, _ = cache_k.shape
    if T != 1 or cache_k.shape != (B, NKV, S, hd) or cache_v.shape != cache_k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} cache {tuple(cache_k.shape)}")
    check_head_dim(hd, q.dtype)
    if H % NKV:
        raise ValueError(f"unsupported heads {H}/{NKV}")
    f32 = q.dtype == torch.float32
    dtype = torch.float32 if f32 else torch.bfloat16
    align = row_alignment(hd * q.element_size())
    for name, x in (("q", q), ("cache_k", cache_k), ("cache_v", cache_v)):
        if (x.dtype != dtype or not x.is_contiguous() or x.device != q.device
                or x.data_ptr() % align):
            raise ValueError(f"{name} must be a contiguous, {align}-byte aligned {dtype} "
                             f"tensor on {q.device} (bfloat16 or float32, q's dtype)")
    if (bias_row.shape != (B, S) or bias_row.dtype != torch.float32
            or not bias_row.is_contiguous() or bias_row.device != q.device):
        raise ValueError(f"bias_row must be a contiguous fp32 [B, S] on {q.device}")

    from trace_tpu_torch.kernels.build import check, load

    name = "decode_attn_f32" if f32 else "decode_attn_bf16"
    fn = getattr(load(_source(_SOURCE, hd)), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]

    def launch(qp, G):
        o = torch.empty_like(qp)  # the kernel's only allocation, no workspace
        err = fn(
            qp.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), bias_row.data_ptr(),
            o.data_ptr(), B, NKV, G, S, hd, float(hd ** -0.5),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        check(err, name)
        count_launch(decode_attention, "launches_f32" if f32 else "launches")
        return o

    return _by_groups(q, NKV, launch)


decode_attention.launches = 0
decode_attention.launches_int8 = {mode: 0 for mode in INT8_MODES}
decode_attention.launches_f32 = 0
decode_attention.launches_int8_f32 = {mode: 0 for mode in INT8_MODES}
