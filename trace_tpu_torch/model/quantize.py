"""Weight-only int8 quantization and the int8 serving layout
(trace_tpu/model/quantize.py, int8 parts).

Per-output-channel symmetric int8 on the decoder's and the ViT's matmul
weights: a quantized leaf is the dict ``{"q": int8, "s": bf16}`` with the
weight's own einsum shape in ``q`` and the reduced axes kept as size 1 in
``s``. ``fuse_decoder_serving`` concatenates the quantized q/k/v and gate/up
projections along their output channels (one product per group and layer).
One torch implementation serves both the JAX package's device and host
(numpy) variants; every operation is elementwise IEEE or a max, so ``q`` and
``s`` are bit-identical to JAX's on the same weights.

The nibble-packed int4 layout (``{"qp", "s"}`` leaves, ``bits=4``) belongs to
the int4p slice and raises ``NotImplementedError`` here.
"""

from __future__ import annotations

import dataclasses

import torch

from trace_tpu_torch.model.config import TraceConfig

_INT4P = ("nibble-packed int4 ('qp' leaves, bits=4, pack=True) is not ported: "
          "it waits for the int4p slice (quant_matmul_p4 / quant_matmul_p4_grouped)")


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


def dequantize(leaf, dtype=torch.bfloat16):
    """A quantized leaf back to a dense weight (the product is rounded to
    bf16 first, as in JAX); any other leaf is returned as it is."""
    if isinstance(leaf, dict) and "qp" in leaf:
        raise NotImplementedError(_INT4P)
    if is_quantized(leaf):
        return (leaf["q"].to(torch.bfloat16) * leaf["s"]).to(dtype)
    return leaf


_DECODER_REDUCE = {
    "wq": (1,), "wk": (1,), "wv": (1,),   # [L, D, NH, hd]
    "wo": (1, 2),                          # [L, NH, hd, D]
    "w_gate": (1,), "w_up": (1,),          # [L, D, I]
    "w_down": (1,),                        # [L, I, D]
}


def quantize_decoder_params(params: dict, bits: int = 8, pack: bool = False) -> dict:
    """int8-quantize the decoder's large matmul weights per (layer, output
    channel); the attention projections reduce over the input dim. The
    norms, the embedding and the small heads stay as they are; ``lm_head``
    is quantized per vocabulary column (it feeds fp32 logits)."""
    if bits != 8 or pack:
        raise NotImplementedError(_INT4P)
    out = dict(params)
    layers = dict(params["layers"])
    for name, axes in _DECODER_REDUCE.items():
        layers[name] = _quantize_stacked(layers[name], axes)
    out["layers"] = layers
    out["lm_head"] = _quantize_axis(params["lm_head"], (0,))  # [D, V]
    return out


def _concat_out_channels(leaves: list) -> dict:
    """Concat quantized leaves along the output channels in the flattened
    [L, K, N] view ``quant_apply`` uses. Scales are per output channel, so
    column n of the result is column n of the weight that owns it."""
    L, K = leaves[0]["q"].shape[:2]
    return {"q": torch.cat([lf["q"].reshape(L, K, -1) for lf in leaves], dim=2),
            "s": torch.cat([lf["s"].reshape(L, 1, -1) for lf in leaves], dim=2)}


def fuse_decoder_serving(params: dict) -> dict:
    """Serving layout: ``wqkv`` [L, D, NQ + 2 NKV] and ``w_gateup``
    [L, D, 2 I] in place of five separate weights, so a layer runs four
    products. Only int8-quantized dense layers are fused; any other tree
    (unquantized, already fused, LoRA, MoE, biased QKV) comes back as it is."""
    layers = params.get("layers", {})
    if "wqkv" in layers or "router" in layers or "bq" in layers:
        return params
    if any("_lora_" in k for k in layers):
        return params
    names = ("wq", "wk", "wv", "w_gate", "w_up")
    if not all(is_quantized(layers.get(n)) for n in names):
        return params
    if any("qp" in layers[n] or layers[n]["q"].dtype != torch.int8 for n in names):
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
    read from ``wo`` ([L, NH, hd, D] or flattened [L, NH hd, D]); k and v
    split the rest evenly."""
    layers = params.get("layers", {})
    if "wqkv" not in layers:
        return params
    new = dict(layers)

    def split(leaf, bounds):
        outs, lo = [], 0
        for hi in bounds:
            outs.append({"q": leaf["q"][..., lo:hi], "s": leaf["s"][..., lo:hi]})
            lo = hi
        return outs

    wo = layers["wo"]["q"] if isinstance(layers["wo"], dict) else layers["wo"]
    nq = wo.shape[1] * wo.shape[2] if wo.ndim == 4 else wo.shape[1]
    qkv = new.pop("wqkv")
    n_total = qkv["q"].shape[-1]
    nkvw = (n_total - nq) // 2
    new["wq"], new["wk"], new["wv"] = split(qkv, (nq, nq + nkvw, n_total))
    gu = new.pop("w_gateup")
    i2 = gu["q"].shape[-1]
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
    params = dict(params)
    params["decoder"] = fuse_decoder_serving(
        quantize_decoder_params(params["decoder"]))
    if vision:
        params["vision"] = quantize_vision_params(params["vision"])
    config = dataclasses.replace(
        config,
        decoder=dataclasses.replace(config.decoder, kv_cache_dtype="int8",
                                    act_quant=True),
        vision=dataclasses.replace(config.vision, act_quant=vision),
    )
    return params, config
