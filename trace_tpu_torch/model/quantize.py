"""Weight-only quantization and the serving layouts
(trace_tpu/model/quantize.py).

int8: per-output-channel symmetric int8 on the decoder's and the ViT's
matmul weights: a quantized leaf is the dict ``{"q": int8, "s": bf16}`` with
the weight's own einsum shape in ``q`` and the reduced axes kept as size 1
in ``s``.

int4p: nibble-packed int4 on the decoder's layer weights: the leaf
``{"qp": int8 [L, K/2, N], "s": bf16 [L, G, N]}`` in the flattened
[L, K, N] view the weight products use. Byte ``qp[l, k, n]`` holds weight
rows ``k`` (low nibble) and ``k + K/2`` (high nibble), both in [-7, 7] as
4-bit two's complement. ``G`` scale groups divide the contraction dim:
K / 128 with the default ``group=128`` where that is an even whole number,
else 1 (per output channel, as ``group=0`` gives everywhere). ``lm_head``
stays int8.

``fuse_decoder_serving`` concatenates the quantized q/k/v and gate/up
projections along their output channels (one product per group and layer).
One torch implementation serves both the JAX package's device and host
(numpy) variants; every operation is elementwise IEEE, a max or integer
bit arithmetic, so values and scales are bit-identical to JAX's on the same
weights.
"""

from __future__ import annotations

import dataclasses

import torch

from trace_tpu_torch.model.config import TraceConfig

def _quantize_axis(w: torch.Tensor, reduce_axes: tuple) -> dict:
    """Symmetric int8 over ``reduce_axes``; the scale keeps the other axes."""
    wf = w.float()
    amax = wf.abs().amax(dim=reduce_axes, keepdim=True)
    scale = (amax / 127).clamp_min(1e-8)
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return {"q": q, "s": scale.to(torch.bfloat16)}


def _quantize_stacked(w: torch.Tensor, reduce_axes: tuple) -> dict:
    """``_quantize_axis`` of a layer-stacked weight, one layer at a time
    (an fp32 temp of the whole stacked ``w_gate`` of a 7B model is 7.5 GB).
    ``reduce_axes`` count the leading layer axis, as in JAX."""
    axes = tuple(a - 1 for a in reduce_axes)
    leaves = [_quantize_axis(w[li], axes) for li in range(w.shape[0])]
    return {"q": torch.stack([lf["q"] for lf in leaves]),
            "s": torch.stack([lf["s"] for lf in leaves])}


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf.keys()) in ({"q", "s"}, {"qp", "s"})


def is_packed4(leaf) -> bool:
    """A nibble-packed int4 leaf ``{"qp", "s"}``."""
    return isinstance(leaf, dict) and "qp" in leaf


def packed4_groups(leaf) -> int:
    """Scale groups along the contraction dim of a packed leaf: 1 = one
    scale per output channel ([.., 1, N]), more = [.., K / group, N]."""
    return leaf["s"].shape[-2]


def unpack4(qp: torch.Tensor) -> torch.Tensor:
    """[.., K/2, N] packed int8 -> [.., K, N] int8 in [-8, 7]: the
    sign-extended low nibbles, then the high nibbles. Through int16, where
    the mask and the arithmetic shift mean the same on every backend."""
    w = qp.to(torch.int16)
    lo = ((w & 0xF) ^ 8) - 8
    hi = w >> 4
    return torch.cat([lo, hi], dim=-2).to(torch.int8)


def pack4(q4: torch.Tensor) -> torch.Tensor:
    """[.., K, N] int4-valued integers -> [.., K/2, N] packed int8."""
    K = q4.shape[-2]
    if K % 2:
        raise ValueError(f"pack4 wants an even contraction dim, got {tuple(q4.shape)}")
    lo = q4[..., : K // 2, :].to(torch.int32)
    hi = q4[..., K // 2:, :].to(torch.int32)
    return ((lo & 0xF) | ((hi & 0xF) << 4)).to(torch.uint8).view(torch.int8)


def dequantize(leaf, dtype=torch.bfloat16):
    """A quantized leaf back to a dense weight (the product is rounded to
    bf16 first, as in JAX); a packed leaf gives the flattened [.., K, N]
    view it is stored in. Any other leaf is returned as it is."""
    if is_packed4(leaf):
        w = unpack4(leaf["qp"]).to(torch.bfloat16)
        G = packed4_groups(leaf)
        if G > 1:
            shape = w.shape
            wg = w.reshape(shape[:-2] + (G, shape[-2] // G, shape[-1]))
            wg = wg * leaf["s"][..., :, None, :].to(torch.bfloat16)
            return wg.reshape(shape).to(dtype)
        return (w * leaf["s"]).to(dtype)
    if is_quantized(leaf):
        return (leaf["q"].to(torch.bfloat16) * leaf["s"]).to(dtype)
    return leaf


_DECODER_REDUCE = {
    "wq": (1,), "wk": (1,), "wv": (1,),   # [L, D, NH, hd]
    "wo": (1, 2),                          # [L, NH, hd, D]
    "w_gate": (1,), "w_up": (1,),          # [L, D, I]
    "w_down": (1,),                        # [L, I, D]
}


def _group_count(K: int, group: int) -> int:
    """Scale groups along a contraction dim of K: K // group when that is
    whole and even (byte k pairs rows k and k + K/2, so each half needs whole
    groups), else 1 (per output channel; the tiny test configs land here)."""
    if group <= 0 or K % group or (K // group) % 2:
        return 1
    return K // group


def _quantize_grouped4(w: torch.Tensor, reduce_axes: tuple, group: int) -> dict:
    """Group-wise symmetric int4 of a layer-stacked weight in the flattened
    [L, K, N] view, nibble-packed: ``{"qp": [L, K/2, N] int8, "s": [L, G, N]
    bf16}``. One layer at a time, as ``_quantize_stacked``."""
    L = w.shape[0]
    K = 1
    for a in reduce_axes:
        K *= w.shape[a]
    G = _group_count(K, group)
    qp, s = [], []
    for li in range(L):
        wf = w[li].float().reshape(G, K // G, -1)
        scale = (wf.abs().amax(dim=1, keepdim=True) / 7.0).clamp_min(1e-8)
        q = torch.round(wf / scale).clamp(-7, 7).to(torch.int8)
        qp.append(pack4(q.reshape(K, -1)))
        s.append(scale[:, 0, :].to(torch.bfloat16))
    return {"qp": torch.stack(qp), "s": torch.stack(s)}


def quantize_decoder_params(params: dict, bits: int = 8, pack: bool = False,
                            group: int = 128) -> dict:
    """Quantize the decoder's large matmul weights per (layer, output
    channel); the attention projections reduce over the input dim. The
    norms, the embedding and the small heads stay as they are; ``lm_head``
    is int8 per vocabulary column in every mode (it feeds fp32 logits).

    ``bits=8``: int8 ``{"q", "s"}`` leaves. ``bits=4, pack=True``:
    nibble-packed int4 ``{"qp", "s"}`` leaves with group-wise scales along
    the contraction dim (``group``, default 128; 0 = one scale per output
    channel). ``bits=4, pack=False`` is the JAX package's native ``jnp.int4``
    storage, which has no torch dtype."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if bits == 4 and not pack:
        raise NotImplementedError(
            "bits=4 without pack=True is native jnp.int4 storage, which torch "
            "has no dtype for; use pack=True (nibble-packed int8 bytes)")
    out = dict(params)
    layers = dict(params["layers"])
    for name, axes in _DECODER_REDUCE.items():
        if bits == 4:
            layers[name] = _quantize_grouped4(layers[name], axes, group)
        else:
            layers[name] = _quantize_stacked(layers[name], axes)
    out["layers"] = layers
    out["lm_head"] = _quantize_axis(params["lm_head"], (0,))  # [D, V]
    return out


def _concat_out_channels(leaves: list) -> dict:
    """Concat quantized leaves along the output channels in the flattened
    [L, K, N] view ``quant_apply`` uses. Scales are per output channel (and
    group), and nibbles pair rows of one column, so column n of the result
    is column n of the weight that owns it."""
    key = "qp" if "qp" in leaves[0] else "q"
    L, K = leaves[0][key].shape[:2]
    # int8 scales keep the weight's einsum axes ([L, 1, NH, hd]): one group
    G = leaves[0]["s"].shape[1] if key == "qp" else 1
    if key == "qp" and any(lf["s"].shape[1] != G for lf in leaves):
        raise ValueError("fused packed leaves must share their scale groups")
    return {key: torch.cat([lf[key].reshape(L, K, -1) for lf in leaves], dim=2),
            "s": torch.cat([lf["s"].reshape(L, G, -1) for lf in leaves], dim=2)}


def fuse_decoder_serving(params: dict) -> dict:
    """Serving layout: ``wqkv`` [L, D, NQ + 2 NKV] and ``w_gateup``
    [L, D, 2 I] in place of five separate weights, so a layer runs four
    products. Only dense layers quantized in one way (all int8 or all
    nibble-packed) are fused; any other tree (unquantized, mixed, already
    fused, LoRA, MoE, biased QKV) comes back as it is."""
    layers = params.get("layers", {})
    if "wqkv" in layers or "router" in layers or "bq" in layers:
        return params
    if any("_lora_" in k for k in layers):
        return params
    names = ("wq", "wk", "wv", "w_gate", "w_up")
    if not all(is_quantized(layers.get(n)) for n in names):
        return params
    if len({"qp" if "qp" in layers[n] else "q" for n in names}) != 1:
        return params
    if "q" in layers["wq"] and layers["wq"]["q"].dtype != torch.int8:
        return params
    new = dict(layers)
    new["wqkv"] = _concat_out_channels([new.pop("wq"), new.pop("wk"), new.pop("wv")])
    new["w_gateup"] = _concat_out_channels([new.pop("w_gate"), new.pop("w_up")])
    out = dict(params)
    out["layers"] = new
    return out


def unfuse_decoder_serving(params: dict) -> dict:
    """Inverse of :func:`fuse_decoder_serving`: split ``wqkv`` / ``w_gateup``
    back into per-weight leaves (flattened [L, K, N] views). The q width is
    read from ``wo`` ([L, NH, hd, D], flattened [L, NH hd, D] or packed
    [L, NH hd / 2, D]); k and v split the rest evenly."""
    layers = params.get("layers", {})
    if "wqkv" not in layers:
        return params
    new = dict(layers)

    def values(leaf):
        return leaf["qp"] if "qp" in leaf else leaf["q"]

    def split(leaf, bounds):
        key = "qp" if "qp" in leaf else "q"
        outs, lo = [], 0
        for hi in bounds:
            outs.append({key: leaf[key][..., lo:hi], "s": leaf["s"][..., lo:hi]})
            lo = hi
        return outs

    wo = layers["wo"]
    if is_packed4(wo):
        nq = 2 * wo["qp"].shape[1]
    else:
        wo = wo["q"] if isinstance(wo, dict) else wo
        nq = wo.shape[1] * wo.shape[2] if wo.ndim == 4 else wo.shape[1]
    qkv = new.pop("wqkv")
    n_total = values(qkv).shape[-1]
    nkvw = (n_total - nq) // 2
    new["wq"], new["wk"], new["wv"] = split(qkv, (nq, nq + nkvw, n_total))
    gu = new.pop("w_gateup")
    i2 = values(gu).shape[-1]
    new["w_gate"], new["w_up"] = split(gu, (i2 // 2, i2))
    out = dict(params)
    out["layers"] = new
    return out


def quantize_vision_params(params: dict) -> dict:
    """int8-quantize the CLIP encoder's stacked linear weights [L, in, out]
    and the patch embedding."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in ("wq", "wk", "wv", "wo", "fc1", "fc2"):
        layers[name] = _quantize_stacked(layers[name], (1,))
    out["layers"] = layers
    out["patch_embed"] = _quantize_axis(params["patch_embed"], (0,))
    return out


def quantize_trace_params(params: dict, *, vision: bool = True) -> dict:
    out = dict(params)
    out["decoder"] = quantize_decoder_params(params["decoder"])
    if vision and "vision" in params:
        out["vision"] = quantize_vision_params(params["vision"])
    return out


def int8_serving(params: dict, config: TraceConfig, *,
                 vision: bool = True) -> tuple[dict, TraceConfig]:
    """The int8 serving pair, as the JAX package's ``model_init(...,
    quant="int8")`` and its bench build it: int8 decoder weights in the
    fused layout, the int8 KV cache, W8A8 prefill (``act_quant``) and, with
    ``vision``, the int8 ViT with W8A8 products. The input tree is left as
    it is; drop it to free the dense weights."""
    return _serving(params, config, quantize_decoder_params(params["decoder"]), vision)


def int4p_serving(params: dict, config: TraceConfig, *, vision: bool = True,
                  group: int = 128) -> tuple[dict, TraceConfig]:
    """The int4p serving pair, as ``model_init(..., quant="int4p")`` and the
    bench's ``--quant int4p`` build it: nibble-packed int4 decoder layer
    weights with group-``group`` scales in the fused layout, an int8
    ``lm_head``, the int8 KV cache, ``act_quant`` and, with ``vision``, the
    int8 W8A8 ViT. Grouped leaves (the default at 7B widths) run weight-only
    at every chunk length; per-channel leaves (``group=0``) run W4A8 on
    chunks of more than one token."""
    decoder = quantize_decoder_params(params["decoder"], bits=4, pack=True, group=group)
    return _serving(params, config, decoder, vision)


def _serving(params: dict, config: TraceConfig, decoder: dict, vision: bool):
    params = dict(params)
    params["decoder"] = fuse_decoder_serving(decoder)
    if vision:
        params["vision"] = quantize_vision_params(params["vision"])
    config = dataclasses.replace(
        config,
        decoder=dataclasses.replace(config.decoder, kv_cache_dtype="int8",
                                    act_quant=True),
        vision=dataclasses.replace(config.vision, act_quant=vision),
    )
    return params, config
