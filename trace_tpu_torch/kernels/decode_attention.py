"""Decode-step attention over one layer's KV-cache stripe: wrapper of the
CUDA kernels in csrc/decode_attention.cu (bf16 cache) and
csrc/decode_attention_int8.cu (int8 cache), and their plain PyTorch versions.

Replaces trace_tpu/kernels/decode_attention.py ``decode_attention`` with its
bodies ``_kernel_bf16``, ``_kernel_int8_s8dot`` / ``_kernel_int8_s8dot_stacked``
(``mode="s8dot"``, the default; the two compute one function) and
``_kernel_int8`` (``mode="dequant"``). There the layer index selects the
stripe of the stacked [L, B, NKV, S, hd] cache through a scalar-prefetch
index map; in torch ``cache_k[li]`` is already a contiguous [B, NKV, S, hd]
view, and the kernels read that view in place.

Bound on an H100: bytes. Each (batch row, kv head) stripe is read once for
G = 4 query rows (~2 flops per byte, far below the card's ~295). The bf16
kernel streams K and V once at full row width and keeps the softmax online
in registers, the slots split into chunks of 256 with a second small launch
that merges them. The int8 kernels cannot run in one pass: s8dot quantizes
``p * vs`` by its maximum over all slots of the row, so they write the
scores to a workspace, reduce each row's statistics, and run the P.V pass
afterwards (four small launches). See the sources.

On a CUDA tensor the wrapper launches its kernel or raises; the plain
version runs for CPU tensors, or when the caller passes ``impl="plain"``.
Launches are counted in ``decode_attention.launches`` (bf16 cache) and
``decode_attention.launches_int8`` (int8 cache, ``{"s8dot": n, "dequant": n}``).
"""

from __future__ import annotations

import ctypes

import torch

_SOURCE = "decode_attention.cu"
_SOURCE_INT8 = "decode_attention_int8.cu"
INT8_MODES = ("s8dot", "dequant")


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
    if H % NKV or H // NKV not in (1, 2, 4) or hd not in (64, 128):
        raise ValueError(f"unsupported heads {H}/{NKV} or head dim {hd}")
    for name, x, dtype in (("q", q, torch.bfloat16), ("kq", kq, torch.int8),
                           ("vq", vq, torch.int8), ("ks", ks, torch.bfloat16),
                           ("vs", vs, torch.bfloat16), ("bias_row", bias_row, torch.float32)):
        if x.dtype != dtype or not x.is_contiguous() or x.device != q.device:
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {q.device}")
    if bias_row.shape != (B, S):
        raise ValueError("bias_row must be [B, S]")

    from trace_tpu_torch.kernels.build import check, load

    lib = load(_SOURCE_INT8)
    fn = getattr(lib, f"decode_attn_int8_{mode}")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.decode_attn_int8_chunk.restype = ctypes.c_int
    lib.decode_attn_int8_chunk.argtypes = []
    G = H // NKV
    nchunk = -(-S // lib.decode_attn_int8_chunk())
    o = torch.empty_like(q)
    dev = q.device
    ws_s = torch.empty((B, NKV, G, S), dtype=torch.float32, device=dev)
    ws_stat = torch.empty((B, NKV, G, 2), dtype=torch.float32, device=dev)
    ws_o = torch.empty((B, NKV, nchunk, G, hd), dtype=torch.int32, device=dev)
    err = fn(
        q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(),
        bias_row.data_ptr(), o.data_ptr(), ws_s.data_ptr(), ws_stat.data_ptr(),
        ws_o.data_ptr(), B, NKV, G, S, hd, float(hd ** -0.5),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(err, f"decode_attn_int8_{mode}")
    decode_attention.launches_int8[mode] += 1
    return o


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
        return grouped_attention(q, cache_k, cache_v, bias_row[:, None, None, :])
    B, H, T, hd = q.shape
    _, NKV, S, _ = cache_k.shape
    if T != 1 or cache_k.shape != (B, NKV, S, hd) or cache_v.shape != cache_k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} cache {tuple(cache_k.shape)}")
    if H % NKV or H // NKV not in (1, 2, 4) or hd not in (64, 128):
        raise ValueError(f"unsupported heads {H}/{NKV} or head dim {hd}")
    for name, x in (("q", q), ("cache_k", cache_k), ("cache_v", cache_v)):
        if x.dtype != torch.bfloat16 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous bfloat16 tensor")
    if (bias_row.shape != (B, S) or bias_row.dtype != torch.float32
            or not bias_row.is_contiguous()):
        raise ValueError("bias_row must be a contiguous fp32 [B, S]")

    from trace_tpu_torch.kernels.build import check, load

    lib = load(_SOURCE)
    fn = lib.decode_attn_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.decode_attn_chunk.restype = ctypes.c_int
    lib.decode_attn_chunk.argtypes = []
    G = H // NKV
    nchunk = -(-S // lib.decode_attn_chunk())
    o = torch.empty_like(q)
    # per-chunk partials: (max, sum) and the unnormalised output
    ws_ml = torch.empty((B, NKV, nchunk, G, 2), dtype=torch.float32, device=q.device)
    ws_acc = torch.empty((B, NKV, nchunk, G, hd), dtype=torch.float32, device=q.device)
    err = fn(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        bias_row.data_ptr(), o.data_ptr(), ws_ml.data_ptr(), ws_acc.data_ptr(),
        B, NKV, G, S, hd, float(hd ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(err, "decode_attn_bf16")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
decode_attention.launches_int8 = {mode: 0 for mode in INT8_MODES}
