"""Mistral decoder in PyTorch: the bf16 branch of trace_tpu/model/mistral.py.

Parameters keep the JAX package's layout: a plain dict whose layer weights
are stacked on a leading [L, ...] axis (wq [L, D, NH, hd], wo [L, NH, hd, D],
w_gate [L, D, I], ...). Layer ``li`` reads ``leaf[li]``, a view.

The KV cache is a (k, v) pair of [L, B, NKV, S, hd] tensors, updated IN
PLACE: a layer writes its chunk's k/v into its stripe first, then attends
(the JAX package threads an immutable cache through a scan carry).

Attention always goes through a kernel wrapper: a T=1 step with a cache
through ``decode_attention`` over the layer's stripe, anything else (the
cache-less forward, prefill into an empty cache) through
``flash_attention`` over the chunk. Each wrapper takes its plain version
for CPU tensors or ``impl="plain"``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from trace_tpu_torch.kernels.decode_attention import decode_attention
from trace_tpu_torch.kernels.flash_attention import flash_attention
from trace_tpu_torch.model.config import DecoderConfig

NEG_INF = -1e30  # finite large-negative avoids NaNs from (-inf) - (-inf)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in fp32, result cast back to the input dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return normed.to(x.dtype) * weight.to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [..., T] -> (cos, sin) each [..., T, head_dim], fp32
    (non-interleaved HF layout, paired with rotate_half)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, N, T, hd]; cos/sin [B, T, hd] broadcast over heads."""
    cos = cos[:, None].to(x.dtype)
    sin = sin[:, None].to(x.dtype)
    return x * cos + rotate_half(x) * sin


def _proj_heads(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h [B, T, D] @ w [D, N, hd] -> [B, N, T, hd]."""
    B, T, D = h.shape
    N, hd = w.shape[1], w.shape[2]
    y = h.reshape(B * T, D) @ w.reshape(D, N * hd)
    return y.view(B, T, N, hd).transpose(1, 2)


def _layer(
    x: torch.Tensor,
    lp: dict,
    *,
    config: DecoderConfig,
    cos: torch.Tensor,
    sin: torch.Tensor,
    flash_bias: Optional[torch.Tensor] = None,
    decode_bias: Optional[torch.Tensor] = None,
    cache_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_index: int = 0,
    impl: str = "auto",
) -> torch.Tensor:
    """One decoder block. ``cache_kv`` is this layer's (k, v) stripe pair
    [B, NKV, S, hd], written in place at ``cache_index``. With
    ``decode_bias`` ([B, S]) the step attends over the stripe, else the
    chunk attends causally to itself under ``flash_bias`` ([B, T])."""
    B, T, D = x.shape
    NH, HD = config.num_heads, config.head_dim

    h = rms_norm(x, lp["attn_norm"], config.rms_eps)
    q = apply_rope(_proj_heads(h, lp["wq"]), cos, sin)
    k = apply_rope(_proj_heads(h, lp["wk"]), cos, sin)
    v = _proj_heads(h, lp["wv"])

    if cache_kv is not None:
        ck, cv = cache_kv
        ck[:, :, cache_index:cache_index + T] = k.to(ck.dtype)
        cv[:, :, cache_index:cache_index + T] = v.to(cv.dtype)

    if decode_bias is not None:
        attn = decode_attention(q.contiguous(), ck, cv, decode_bias, impl=impl)
    else:
        attn = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               flash_bias, True, impl=impl)

    attn_flat = attn.transpose(1, 2).reshape(B * T, NH * HD)
    x = x + (attn_flat @ lp["wo"].reshape(NH * HD, D)).view(B, T, D)

    h = rms_norm(x, lp["mlp_norm"], config.rms_eps).reshape(B * T, D)
    # the JAX package keeps gate/up in fp32 (preferred_element_type); a bf16
    # torch matmul rounds them to bf16 first
    gate = (h @ lp["w_gate"]).float()
    up = (h @ lp["w_up"]).float()
    act = (F.silu(gate) * up).to(x.dtype)
    return x + (act @ lp["w_down"]).view(B, T, D)


def decoder_forward(
    params: dict,
    config: DecoderConfig,
    embeds: torch.Tensor,       # [B, T, D]
    attn_mask: torch.Tensor,    # [B, T] bool, True = real token
    positions: torch.Tensor,    # [B, T] int RoPE positions
    *,
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # [L,B,NKV,S,hd] x2
    cache_index: int = 0,
    cache_mask: Optional[torch.Tensor] = None,  # [B, S] bool over cache slots
    impl: str = "auto",
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Run the decoder stack (causal). Without a cache: attention within
    the sequence. With a cache, keys/values are written at ``cache_index``;
    a T=1 step then attends over the static cache, masked by ``cache_mask``
    (slots valid before this call) plus its own slot. A T > 1 chunk with a
    cache is prefill into an empty cache (``cache_index`` 0, ``cache_mask``
    not read), as the JAX package's flash path assumes; chunked prefill
    after earlier slots has no kernel and raises. Returns (final-normed
    hidden, cache)."""
    B, T, D = embeds.shape
    dev = embeds.device
    x = embeds
    cos, sin = rope_cos_sin(positions, config.head_dim, config.rope_theta)

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    flash_bias = decode_bias = None
    if cache is not None and T == 1:
        S = cache[0].shape[3]
        vis = (torch.arange(S, device=dev) == cache_index)[None] & attn_mask.bool()
        if cache_mask is not None:
            vis = vis | cache_mask
        decode_bias = torch.where(vis, zero, neg).contiguous()
    elif cache is not None and cache_index != 0:
        raise NotImplementedError(
            "chunked prefill (T > 1 at cache_index > 0) is not ported: no "
            "kernel attends a chunk over earlier cache slots")
    else:
        flash_bias = torch.where(attn_mask.bool(), zero, neg).contiguous()

    layers = params["layers"]
    num_layers = layers["wq"].shape[0]
    for li in range(num_layers):
        lp = {name: leaf[li] for name, leaf in layers.items()}
        x = _layer(
            x, lp, config=config, cos=cos, sin=sin,
            flash_bias=flash_bias, decode_bias=decode_bias,
            cache_kv=None if cache is None else (cache[0][li], cache[1][li]),
            cache_index=cache_index, impl=impl,
        )
    return rms_norm(x, params["final_norm"], config.rms_eps), cache


HEAD_NAMES = ("lm_head", "sync_head", "time_head", "score_head")


def compute_logits(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """hidden [..., D] -> combined fp32 logits [..., V + 1 + Vt + Vs] in
    text|sync|time|score order. The products run in fp32 on the exact fp32
    values of the bf16 operands, as the JAX package's
    preferred_element_type=fp32 does."""
    h = hidden.float()
    return torch.cat([h @ params[name].float() for name in HEAD_NAMES], dim=-1)


def init_kv_cache(
    config: DecoderConfig, batch_size: int, max_len: int,
    dtype=torch.bfloat16, device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static (k, v) cache, each [L, B, NKV, max_len, hd] (bf16 layout)."""
    if config.kv_cache_dtype != "bf16":
        raise NotImplementedError(
            f"kv_cache_dtype={config.kv_cache_dtype!r}: only the bf16 cache is ported"
        )
    shape = (config.num_layers, batch_size, config.num_kv_heads, max_len,
             config.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
