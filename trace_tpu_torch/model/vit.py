"""CLIP ViT-L/14-336 vision tower in PyTorch (the dense fused-qkv and the
int8 W8A8 branches of trace_tpu/model/vit.py).

The hidden-states tap at ``select_layer=-2`` is implemented by not running
the last layer; the CLS position attends and is dropped from the output.
Patch embedding is a reshape plus one matmul; layers are stacked on a
leading [L, ...] axis as in the JAX package.
"""

from __future__ import annotations

import torch

from trace_tpu_torch.kernels.flash_attention import vit_attention_btd
from trace_tpu_torch.kernels.quant_matmul import quant_apply_w8a8, quantize_acts
from trace_tpu_torch.model.config import VisionConfig
from trace_tpu_torch.model.quantize import dequantize, is_quantized

# OpenAI CLIP normalization constants (CLIPImageProcessor defaults).
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def layer_norm(x, scale, bias, eps: float):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * scale.float() + bias.float()).to(x.dtype)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def extract_patches(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, H, W, 3] -> [B, n_patches, 3*p*p] (row-major patch grid, channel-
    major rows within a patch, as a conv kernel [C, kh, kw] flattens)."""
    B, H, W, C = images.shape
    p = patch_size
    gh, gw = H // p, W // p
    x = images.reshape(B, gh, p, gw, p, C).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(B, gh * gw, C * p * p)


def fuse_vision_qkv(params: dict) -> dict:
    """Serving layout: concat the stacked q/k/v projections into one
    [L, D, 3D] weight (one matmul per layer for QKV). An int8 tree keeps
    its separate weights and comes back as it is."""
    layers = dict(params["layers"])
    if "wqkv" in layers or not torch.is_tensor(layers.get("wq")):
        return params
    layers["wqkv"] = torch.cat(
        [layers.pop("wq"), layers.pop("wk"), layers.pop("wv")], dim=-1)
    layers["bqkv"] = torch.cat(
        [layers.pop("bq"), layers.pop("bk"), layers.pop("bv")], dim=-1)
    out = dict(params)
    out["layers"] = layers
    return out


def _linear(x, w, b):
    """x [..., K] @ w [K, N] + b, accumulated in fp32 where the backend
    does (cuBLAS adds the bias in its fp32 epilogue). An int8 weight is
    dequantized first (the weight-only ViT, ``act_quant`` off)."""
    lead = x.shape[:-1]
    w = dequantize(w, x.dtype)
    y = torch.addmm(b.to(x.dtype), x.reshape(-1, x.shape[-1]), w.to(x.dtype))
    return y.view(*lead, w.shape[-1])


def _linear_w8a8(acts, leaf: dict, b, dtype, impl: str):
    """s8 x s8 product of quantized activations with an int8 weight; the
    bias is added to the fp32 result before the cast."""
    y = quant_apply_w8a8(*acts, leaf, (leaf["q"].shape[-1],),
                         out_dtype=torch.float32, impl=impl)
    return (y + b).to(dtype)


def _vit_layer(x, lp: dict, config: VisionConfig, tq: int, impl: str = "auto"):
    c = config
    D = x.shape[-1]
    w8a8 = c.act_quant and is_quantized(lp.get("wq"))
    if w8a8:
        lin = lambda t, w, b: _linear_w8a8(quantize_acts(t), lp[w], lp[b], x.dtype, impl)
    else:
        lin = lambda t, w, b: _linear(t, lp[w], lp[b])

    h = layer_norm(x, lp["ln1_scale"], lp["ln1_bias"], c.layer_eps)
    if w8a8:
        hq = quantize_acts(h)  # one rounding pass shared by q/k/v
        q, k, v = (_linear_w8a8(hq, lp[w], lp[b], x.dtype, impl)
                   for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
    elif "wqkv" in lp:
        q, k, v = lin(h, "wqkv", "bqkv").split(D, dim=-1)
    else:
        q, k, v = lin(h, "wq", "bq"), lin(h, "wk", "bk"), lin(h, "wv", "bv")
    attn = vit_attention_btd(q, k, v, tq, c.num_heads, impl=impl)
    x = x + lin(attn.to(x.dtype), "wo", "bo")

    h = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"], c.layer_eps)
    h1 = lin(h, "fc1", "b1")
    return x + lin(quick_gelu(h1), "fc2", "b2")


def vit_forward(
    params: dict,
    config: VisionConfig,
    images: torch.Tensor,  # [B, H, W, 3] CLIP-normalized
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """Images -> patch features [B, num_patches, hidden] at the -2 tap.

    The token dim is padded once from 577 to a multiple of 16 (592) for the
    whole stack and attention runs through ``vit_attention_btd`` with keys
    >= 577 masked; pad rows are dropped at the end."""
    c = config
    B = images.shape[0]
    patch_w = dequantize(params["patch_embed"],
                         images.dtype if images.is_floating_point() else torch.float32)
    embeds = extract_patches(images, c.patch_size).to(patch_w.dtype) @ patch_w

    cls = params["class_embedding"].expand(B, 1, c.hidden_size).to(embeds.dtype)
    x = torch.cat([cls, embeds], dim=1)
    x = x + params["position_embedding"][None, : x.shape[1]]
    x = layer_norm(x, params["pre_ln"]["scale"], params["pre_ln"]["bias"], c.layer_eps)

    tq = x.shape[1]
    P = -(-tq // 16) * 16
    if P != tq:
        x = torch.nn.functional.pad(x, (0, 0, 0, P - tq))

    num_run = c.num_layers + 1 + c.select_layer  # -2 => num_layers - 1
    layers = params["layers"]
    for li in range(num_run):
        lp = {name: ({k: v[li] for k, v in leaf.items()} if isinstance(leaf, dict)
                     else leaf[li]) for name, leaf in layers.items()}
        x = _vit_layer(x, lp, c, tq, impl=impl)
    x = x[:, :tq]
    if c.select_feature == "patch":
        return x[:, 1:]
    return x
