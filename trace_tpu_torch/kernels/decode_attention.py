"""Decode-step attention over one layer's KV-cache stripe: wrapper of the
CUDA kernel in csrc/decode_attention.cu, and its plain PyTorch version.

Replaces trace_tpu/kernels/decode_attention.py ``decode_attention`` with its
bf16 body (``_kernel_bf16``). There the layer index selects the stripe of
the stacked [L, B, NKV, S, hd] cache through a scalar-prefetch index map;
in torch ``cache_k[li]`` is already a contiguous [B, NKV, S, hd] view, and
the kernel reads that view in place.

Bound on an H100: bytes. Each (batch row, kv head) stripe is read once for
G = 4 query rows (~2 flops per byte, far below the card's ~295), so the
kernel streams K and V once at full row width and keeps the softmax online
in registers. The slots are split into chunks of 256 so that enough blocks
stream at serving batch (B x NKV is only 16 at B = 2); a second small
launch merges the chunks' partial results. See csrc/decode_attention.cu.

On a CUDA tensor the wrapper launches its kernel or raises; the plain
version runs for CPU tensors, or when the caller passes ``impl="plain"``.
Launches are counted in ``decode_attention.launches``.
"""

from __future__ import annotations

import ctypes

import torch

_SOURCE = "decode_attention.cu"


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


def decode_attention(
    q: torch.Tensor,         # [B, H, 1, hd]
    cache_k: torch.Tensor,   # [B, NKV, S, hd], one layer's stripe
    cache_v: torch.Tensor,   # [B, NKV, S, hd]
    bias_row: torch.Tensor,  # [B, S] additive fp32 (0 visible / -1e30 masked)
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """One decode step of attention. Returns [B, H, 1, hd] in q's dtype."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
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
