"""Mistral decoder in PyTorch: the dense (bf16), int8 and nibble-packed
int4 branches of trace_tpu/model/mistral.py.

Parameters keep the JAX package's layout: a plain dict whose layer weights
are stacked on a leading [L, ...] axis (wq [L, D, NH, hd], wo [L, NH, hd, D],
w_gate [L, D, I], ...). Layer ``li`` reads ``leaf[li]``, a view. An int8
tree (``model/quantize.py``) holds ``{'q', 's'}`` leaves, in the serving
layout fused into ``wqkv`` and ``w_gateup``: a chunk of more than one token
runs W8A8 when ``config.act_quant`` is set, a T = 1 step the weight-only
``quant_matmul_stacked`` kernel on the whole stacked leaf. An int4p tree
holds packed ``{'qp', 's'}`` layer leaves (``lm_head`` stays int8): with
group-wise scales every chunk length is weight-only through
``quant_matmul_p4_grouped``; with per-channel scales a longer chunk runs W4A8
under ``act_quant`` and a T = 1 step ``quant_matmul_p4``.

The KV cache is a (k, v) pair of [L, B, NKV, S, hd] tensors, or for
``kv_cache_dtype="int8"`` the dict {kq, ks, vq, vs} (int8 values, bf16
scales [L, B, NKV, 1, S]), updated IN PLACE: a layer writes its chunk's k/v
into its stripe first, then attends (the JAX package threads an immutable
cache through a scan carry).

Attention always goes through a kernel wrapper: a T=1 step with a cache
through ``decode_attention`` over the layer's stripe, anything else (the
cache-less forward, prefill into an empty cache) through
``flash_attention`` over the chunk. Each wrapper takes its plain version
for CPU tensors or ``impl="plain"``.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from trace_tpu_torch.kernels.decode_attention import decode_attention
from trace_tpu_torch.kernels.flash_attention import flash_attention
from trace_tpu_torch.kernels.quant_matmul import (
    quant_apply,
    quant_apply_stacked,
    quant_apply_w8a8,
    quantize_acts,
)
from trace_tpu_torch.model.config import DecoderConfig
from trace_tpu_torch.model.quantize import is_packed4, is_quantized, packed4_groups

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


def _quantize_kv(x: torch.Tensor):
    """[B, N, T, hd] -> (int8 values, one bf16 scale per slot [B, N, 1, T])."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) / 127.0).clamp_min(1e-8)[:, :, None, :]
    q = torch.round(xf / scale.transpose(-1, -2)).clamp(-127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def _project(h, layers: dict, name: str, li: int, out_shape: tuple, *,
             acts=None, out_dtype=None, impl: str = "auto") -> torch.Tensor:
    """h [B, T, K] through layer ``li`` of the stacked weight ``name``. A
    quantized leaf (int8 or packed int4) takes the s8 x s8 product when
    ``acts`` (``quantize_acts`` of h) is given, else its weight-only kernel,
    which reads the layer out of the whole stacked leaf in place; a dense
    weight takes a product with an fp32 sum."""
    leaf = layers[name]
    out_dtype = out_dtype or h.dtype
    if not is_quantized(leaf):
        return quant_apply(h, leaf[li], out_shape, out_dtype=out_dtype)
    if acts is None:
        return quant_apply_stacked(h, leaf, li, out_shape, out_dtype=out_dtype,
                                   impl=impl)
    return quant_apply_w8a8(*acts, {k: v[li] for k, v in leaf.items()},
                            out_shape, out_dtype=out_dtype, impl=impl)


def _layer(
    x: torch.Tensor,
    layers: dict,
    li: int,
    *,
    config: DecoderConfig,
    cos: torch.Tensor,
    sin: torch.Tensor,
    flash_bias: Optional[torch.Tensor] = None,
    decode_bias: Optional[torch.Tensor] = None,
    cache=None,
    cache_index: int = 0,
    impl: str = "auto",
) -> torch.Tensor:
    """Decoder block ``li`` of the stacked tree ``layers``. ``cache`` is the
    whole cache; the block writes its chunk's k/v into its stripe in place
    at ``cache_index`` (quantized per slot for the int8 cache). With
    ``decode_bias`` ([B, S]) the step attends over the stripe, else the
    chunk attends causally to itself under ``flash_bias`` ([B, T]).

    Routing of a quantized tree, as the JAX package's defaults, decided on
    the q (or fused qkv) leaf: a chunk of more than one token with
    ``config.act_quant`` runs W8A8, or W4A8 on per-channel packed leaves
    (activations quantized once per consumer group); a T = 1 step is always
    weight-only, and so is every chunk of a group-scaled packed tree, whose
    scales apply inside the contraction. The fused serving leaves ``wqkv`` /
    ``w_gateup`` are used where present."""
    B, T, D = x.shape
    NH, NKV, HD = config.num_heads, config.num_kv_heads, config.head_dim
    NQ, NKVW = NH * HD, NKV * HD
    fused_qkv = "wqkv" in layers
    wq = layers["wqkv" if fused_qkv else "wq"]
    grouped = is_packed4(wq) and packed4_groups(wq) > 1
    w8a8 = config.act_quant and T > 1 and is_quantized(wq) and not grouped
    acts = lambda t: quantize_acts(t) if w8a8 else None
    proj = functools.partial(_project, layers=layers, li=li, impl=impl)

    h = rms_norm(x, layers["attn_norm"][li], config.rms_eps)
    hq = acts(h)  # one rounding pass shared by q/k/v
    heads = lambda t, n: t.view(B, T, n, HD).transpose(1, 2)
    if fused_qkv:
        qkv = proj(h, name="wqkv", out_shape=(NQ + 2 * NKVW,), acts=hq)
        q, k, v = (heads(t, n) for t, n in zip(
            qkv.split((NQ, NKVW, NKVW), dim=-1), (NH, NKV, NKV)))
    else:
        q = proj(h, name="wq", out_shape=(NH, HD), acts=hq).transpose(1, 2)
        k = proj(h, name="wk", out_shape=(NKV, HD), acts=hq).transpose(1, 2)
        v = proj(h, name="wv", out_shape=(NKV, HD), acts=hq).transpose(1, 2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    stripe = None
    if isinstance(cache, dict):
        stripe = {name: leaf[li] for name, leaf in cache.items()}
        sl = slice(cache_index, cache_index + T)
        stripe["kq"][:, :, sl], stripe["ks"][:, :, :, sl] = _quantize_kv(k)
        stripe["vq"][:, :, sl], stripe["vs"][:, :, :, sl] = _quantize_kv(v)
    elif cache is not None:
        stripe = (cache[0][li], cache[1][li])
        stripe[0][:, :, cache_index:cache_index + T] = k.to(stripe[0].dtype)
        stripe[1][:, :, cache_index:cache_index + T] = v.to(stripe[1].dtype)

    if decode_bias is not None:
        if isinstance(stripe, dict):
            attn = decode_attention(q.contiguous(), stripe, None, decode_bias,
                                    mode=config.decode_attn_int8, impl=impl)
        else:
            attn = decode_attention(q.contiguous(), *stripe, decode_bias, impl=impl)
    else:
        attn = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               flash_bias, True, impl=impl)

    attn_flat = attn.transpose(1, 2).reshape(B, T, NQ)
    x = x + proj(attn_flat, name="wo", out_shape=(D,), acts=acts(attn_flat))

    # gate and up stay fp32 into silu, as the JAX package's
    # preferred_element_type=float32 keeps them
    h = rms_norm(x, layers["mlp_norm"][li], config.rms_eps)
    hq = acts(h)  # shared by gate/up
    if "w_gateup" in layers:
        gate, up = proj(h, name="w_gateup", out_shape=(-1,), acts=hq,
                        out_dtype=torch.float32).chunk(2, dim=-1)
    else:
        gate = proj(h, name="w_gate", out_shape=(-1,), acts=hq, out_dtype=torch.float32)
        up = proj(h, name="w_up", out_shape=(-1,), acts=hq, out_dtype=torch.float32)
    act = F.silu(gate) * up
    if not w8a8:
        act = act.to(x.dtype)
    return x + proj(act, name="w_down", out_shape=(D,), acts=acts(act),
                    out_dtype=x.dtype)


def decoder_forward(
    params: dict,
    config: DecoderConfig,
    embeds: torch.Tensor,       # [B, T, D]
    attn_mask: torch.Tensor,    # [B, T] bool, True = real token
    positions: torch.Tensor,    # [B, T] int RoPE positions
    *,
    cache=None,                 # (k, v) [L,B,NKV,S,hd] x2, or the int8 dict
    cache_index: int = 0,
    cache_mask: Optional[torch.Tensor] = None,  # [B, S] bool over cache slots
    impl: str = "auto",
):
    """Run the decoder stack (causal). Without a cache: attention within
    the sequence. With a cache, keys/values are written at ``cache_index``;
    a T=1 step then attends over the static cache, masked by ``cache_mask``
    (slots valid before this call) plus its own slot. A T > 1 chunk with a
    cache is prefill into an empty cache (``cache_index`` 0, ``cache_mask``
    not read), as the JAX package's flash path assumes; chunked prefill
    after earlier slots has no kernel and raises. The layer weights may be
    dense, int8 ``{'q', 's'}`` or packed int4 ``{'qp', 's'}`` leaves, per
    weight or in the fused serving layout; the
    cache the (k, v) pair or the int8 dict of ``init_kv_cache``. Returns
    (final-normed hidden, cache)."""
    B, T, D = embeds.shape
    dev = embeds.device
    x = embeds
    cos, sin = rope_cos_sin(positions, config.head_dim, config.rope_theta)

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    flash_bias = decode_bias = None
    if cache is not None and T == 1:
        S = (cache["kq"] if isinstance(cache, dict) else cache[0]).shape[3]
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
    for li in range(layers["attn_norm"].shape[0]):
        x = _layer(
            x, layers, li, config=config, cos=cos, sin=sin,
            flash_bias=flash_bias, decode_bias=decode_bias,
            cache=cache, cache_index=cache_index, impl=impl,
        )
    return rms_norm(x, params["final_norm"], config.rms_eps), cache


HEAD_NAMES = ("lm_head", "sync_head", "time_head", "score_head")


def compute_logits(params: dict, hidden: torch.Tensor, *,
                   impl: str = "auto") -> torch.Tensor:
    """hidden [..., D] -> combined fp32 logits [..., V + 1 + Vt + Vs] in
    text|sync|time|score order. The products run in fp32 on the exact fp32
    values of the bf16 operands, as the JAX package's
    preferred_element_type=fp32 does; an int8 ``lm_head`` goes weight-only
    through ``quant_matmul`` with an fp32 result, at every T."""
    h = hidden.float()
    parts = [h @ params[name].float() for name in HEAD_NAMES[1:]]
    lm_head = params["lm_head"]
    if is_quantized(lm_head):
        text = quant_apply(hidden, lm_head, (lm_head["q"].shape[-1],),
                           out_dtype=torch.float32, impl=impl)
    else:
        text = h @ lm_head.float()
    return torch.cat([text] + parts, dim=-1)


def init_kv_cache(
    config: DecoderConfig, batch_size: int, max_len: int,
    dtype=torch.bfloat16, device=None,
):
    """Static cache: the (k, v) pair, each [L, B, NKV, max_len, hd] in
    ``dtype``; or, for ``config.kv_cache_dtype == "int8"``, the dict
    ``{kq, ks, vq, vs}`` with int8 values and bf16 scales
    [L, B, NKV, 1, max_len] (one per layer, row, kv head and slot; the JAX
    package's layout)."""
    shape = (config.num_layers, batch_size, config.num_kv_heads, max_len,
             config.head_dim)
    if config.kv_cache_dtype == "int8":
        sshape = shape[:-2] + (1, max_len)
        return {
            "kq": torch.zeros(shape, dtype=torch.int8, device=device),
            "ks": torch.ones(sshape, dtype=torch.bfloat16, device=device),
            "vq": torch.zeros(shape, dtype=torch.int8, device=device),
            "vs": torch.ones(sshape, dtype=torch.bfloat16, device=device),
        }
    if config.kv_cache_dtype != "bf16":
        raise ValueError(f"kv_cache_dtype={config.kv_cache_dtype!r}: 'bf16' or 'int8'")
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
