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
through ``decode_attention`` over the layer's stripe, a chunk of a chunked
prefill (T > 1 at ``cache_index`` > 0) through ``flash_attention`` over the
stripe with the chunk's query offset (two ``flash_attention_fwd_res``
launches merged by their logsumexp where the cache mask marks a slot at or
past ``cache_index``), anything else (the cache-less
forward, prefill into an empty cache) through ``flash_attention`` over the
chunk, or with ``trainable`` through ``flash_attention_trainable``, whose
backward is a pair of kernels too. Each wrapper takes its plain version for
CPU tensors or ``impl="plain"``; a chunk's plain route is the JAX package's
einsum over the S slots (``_attend_chunk``).

Training reads the same stacked leaves. A leaf that requires a gradient is
sliced through ``layer_slice``, whose backward adds the layer's gradient into
stripe ``li`` of the stacked ``.grad`` in place: indexing ``leaf[li]`` under
autograd would build a full [L, ...] zero gradient per layer and weight.
LoRA adapters (model/lora.py) are extra stacked leaves of the same tree.

A Mixtral-family tree (``router`` among the layer leaves, ``model/moe.py``)
runs its layers' MLP as routed experts, in the form of ``config.moe_impl``,
on every route (prefill, decode step, training); MLP adapters do not apply
there, as in the JAX package. Its weights stay unquantized.

Tensor parallelism (``decoder_forward(tp_group=)``, ``compute_logits``,
``init_kv_cache(num_kv_heads=)``): a rank runs the layers on its shards of a
tree that ``runtime/mesh.py`` placed by the JAX package's rules, with the
collectives of ``parallel/collectives.py`` where GSPMD inserts them there,
and every kernel at its local shapes. One layer body (``_layer``) serves one
rank and a rank of a group alike.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from trace_tpu_torch.kernels.decode_attention import decode_attention, grouped_attention
from trace_tpu_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_trainable,
)
from trace_tpu_torch.kernels.flash_backward import flash_attention_fwd_res, merge_attention
from trace_tpu_torch.kernels.quant_matmul import (
    quant_apply,
    quant_apply_stacked,
    quant_apply_w8a8,
    quantize_acts,
)
from trace_tpu_torch.model.config import DecoderConfig
from trace_tpu_torch.model.lora import lora_delta
from trace_tpu_torch.model.moe import MOE_KEYS, moe_mlp
from trace_tpu_torch.model.quantize import is_packed4, is_quantized, packed4_groups
from trace_tpu_torch.parallel.collectives import (
    all_reduce,
    copy_to_group,
    gather,
    group_rank,
    group_size,
    reduce_from_group,
)

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


class _StackedLayerGrad(torch.autograd.Function):
    """``leaf[li]`` of a stacked [L, ...] leaf. The backward adds the layer's
    gradient into ``leaf.grad[li]`` in place (allocating a zero ``.grad`` of
    the leaf's shape once) and hands autograd nothing for the leaf, so one
    backward costs one stacked gradient, not L of them. ``torch.autograd.grad``
    does not see this gradient; ``backward()`` and ``.grad`` do."""

    @staticmethod
    def forward(ctx, leaf, li):
        ctx.leaf, ctx.li = leaf, li
        return leaf[li]

    @staticmethod
    def backward(ctx, g):
        leaf = ctx.leaf
        if leaf.grad is None:
            leaf.grad = torch.zeros_like(leaf)
        leaf.grad[ctx.li].add_(g)
        return None, None


def layer_slice(leaf: torch.Tensor, li: int) -> torch.Tensor:
    """Layer ``li`` of a stacked leaf: a view, differentiable towards the
    leaf's stacked ``.grad`` when the leaf takes a gradient."""
    if leaf.requires_grad and torch.is_grad_enabled():
        return _StackedLayerGrad.apply(leaf, li)
    return leaf[li]


# the q/k/v adapters apply only beside a q or v adapter, as in the JAX package
_QKV = ("wq", "wk", "wv")


def _has_adapter(layers: dict, name: str) -> bool:
    return f"{name}_lora_a" in layers and (
        name not in _QKV or "wq_lora_a" in layers or "wv_lora_a" in layers)


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
        return quant_apply(h, layer_slice(leaf, li), out_shape, out_dtype=out_dtype)
    if acts is None:
        return quant_apply_stacked(h, leaf, li, out_shape, out_dtype=out_dtype,
                                   impl=impl)
    return quant_apply_w8a8(*acts, {k: v[li] for k, v in leaf.items()},
                            out_shape, out_dtype=out_dtype, impl=impl)


def _attend_chunk(q, stripe, chunk_vis, cache_index: int, impl: str) -> torch.Tensor:
    """A chunk of a chunked prefill: q [B, NH, T, hd] at slots ``cache_index``
    ... + T - 1 over the layer's stripe, into which its k / v are written.
    The JAX package's einsum path (trace_tpu/model/mistral.py, the cache
    branch of ``decoder_forward``): query i sees the slots valid before the
    call (``old``, the cache mask) and the chunk's real slots up to its own,
    ``new`` marking them: ``chunk_vis`` = (old, new, marked), old and new
    [B, S] bool, ``marked`` whether ``old`` marks a slot at or past
    ``cache_index``. An int8 stripe is dequantized first, each value times
    its slot's scale (exact in fp32) cast once to q's dtype, as the JAX
    package's compiled path computes ``kq.astype(bf16) * ks`` followed by
    the cast. On the card (``impl="auto"``) the stripe is read in place by
    ``flash_attention`` with query offset ``cache_index`` and the bias row of
    ``old | new`` where nothing is marked (every caller in the package: the
    causal offset then hides no slot of ``old``); else by
    ``_attend_chunk_parts``. Its plain route is the JAX expression itself."""
    if isinstance(stripe, dict):
        k_all = stripe["kq"].float() * stripe["ks"].transpose(-1, -2).float()
        v_all = stripe["vq"].float() * stripe["vs"].transpose(-1, -2).float()
    else:
        k_all, v_all = stripe
    k_all, v_all = k_all.to(q.dtype), v_all.to(q.dtype)
    old, new, marked = chunk_vis
    dev, T, S = q.device, q.shape[2], k_all.shape[2]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    if q.is_cuda and impl == "auto":
        if marked:
            return _attend_chunk_parts(q.contiguous(), k_all, v_all, old, new, cache_index,
                                       impl)
        bias_row = torch.where(old | new, zero, neg).contiguous()
        return flash_attention(q.contiguous(), k_all, v_all, bias_row, True,
                               q_offset=cache_index, impl=impl)
    slot = torch.arange(S, device=dev)
    upto = cache_index + torch.arange(T, device=dev)[:, None]  # [T, 1]
    in_chunk = (slot >= cache_index) & (slot <= upto)          # [T, S]
    vis = old[:, None, :] | (in_chunk[None] & new[:, None, :])  # [B, T, S]
    return grouped_attention(q, k_all, v_all, torch.where(vis, zero, neg)[:, None])


def _attend_chunk_parts(q, k_all, v_all, old, new, cache_index: int, impl: str):
    """The chunk's attention as two disjoint key sets merged by their
    logsumexp: every slot of ``old`` (no causal mask), and the chunk's real
    slots up to each query's own that ``old`` does not mark (causal at query
    offset ``cache_index``). Two launches of ``flash_attention_fwd_res`` on
    the card; its plain version elsewhere."""
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=q.device)
    o1, lse1 = flash_attention_fwd_res(q, k_all, v_all, torch.where(old, zero, neg).contiguous(),
                                       causal=False, impl=impl)
    o2, lse2 = flash_attention_fwd_res(q, k_all, v_all,
                                       torch.where(new & ~old, zero, neg).contiguous(),
                                       causal=True, q_offset=cache_index, impl=impl)
    return merge_attention(o1, lse1, o2, lse2, q.dtype)


def _attend(q, k, v, li: int, *, config: DecoderConfig, flash_bias, decode_bias, cache,
            cache_index: int, impl: str, trainable: bool, chunk_vis=None) -> torch.Tensor:
    """q [B, NH, T, hd], k / v [B, NKV, T, hd] after RoPE: the chunk's k / v
    written into layer ``li``'s stripe of ``cache`` at ``cache_index`` (where
    there is a cache), then the step's attention over the stripe
    (``decode_bias``), a chunk's of a chunked prefill over it (``chunk_vis``,
    ``_attend_chunk``) or the chunk's causal attention over itself
    (``flash_bias``). Returns [B, NH, T, hd]."""
    T = q.shape[2]
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

    if chunk_vis is not None:
        return _attend_chunk(q, stripe, chunk_vis, cache_index, impl)
    if decode_bias is not None:
        if isinstance(stripe, dict):
            return decode_attention(q.contiguous(), stripe, None, decode_bias,
                                    mode=config.decode_attn_int8, impl=impl)
        return decode_attention(q.contiguous(), *stripe, decode_bias, impl=impl)
    if trainable:
        return flash_attention_trainable(q, k, v, flash_bias, True, impl=impl)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           flash_bias, True, impl=impl)


# ---------------------------------------------------------------------------
# Shares of a weight under tensor parallelism (runtime/mesh.py places them);
# with no group every share is the whole weight and every collective the
# identity
# ---------------------------------------------------------------------------
# A rank holds, of every weight the rules shard, an even share along one
# axis: a column share [r n, (r + 1) n) of its outputs (q / k / v, gate /
# up, lm_head; ``_col``) or a row share of its inputs (wo, w_down; ``_row``).
# A weight whose axis the group does not divide is whole on every rank while
# its neighbours may be sharded (the JAX rules' divisibility fallback); a
# tensor in one column layout moves to another through ``_relayout``. A
# replicated tensor that feeds a rank-specific computation passes through
# ``copy_to_group``, and partial sums through ``reduce_from_group``, so the
# gradients of replicated leaves come out whole on every rank.

def _width(leaf, axis: str, in_dims: int = 1) -> int:
    """The per-layer input ('in') or output ('out') width of a stacked
    weight: dense [L, *in, *out], int8 {'q': the same, 's'} or packed
    {'qp': [L, K/2, N], 's'}."""
    packed = isinstance(leaf, dict) and "qp" in leaf
    t = leaf if torch.is_tensor(leaf) else leaf["qp" if packed else "q"]
    if t.ndim == 3:  # a flattened [L, K, N] form
        in_dims = 1
    dims = t.shape[1:1 + in_dims] if axis == "in" else t.shape[1 + in_dims:]
    n = 1
    for d in dims:
        n *= d
    return 2 * n if packed and axis == "in" else n


def _share(n_local: int, full: int, rank: int) -> tuple:
    """(first column, width) of a rank's even share, or (0, full) when whole."""
    return (rank * n_local, n_local) if n_local < full else (0, full)


def _relayout(t: torch.Tensor, have: tuple, want: tuple, full: int, group) -> torch.Tensor:
    """``t`` [..., n] holding columns ``have`` = (lo, n) of a [..., full]
    tensor (a rank's even share, or all of it) -> the columns ``want``."""
    if have == want:
        return t
    if have[1] < full:
        t = gather(t, -1, group)
    if want[1] == full:
        return t
    return copy_to_group(t, group)[..., want[0]:want[0] + want[1]]


def _take(t: torch.Tensor, dim: int, lo: int, n: int, group) -> torch.Tensor:
    """A rank-specific slice of a replicated tensor."""
    return copy_to_group(t, group).narrow(dim, lo, n)


def _adapter(layers: dict, name: str, li: int, k: int, n: int, config: DecoderConfig,
             group) -> tuple:
    """Layer ``li``'s LoRA adapter of weight ``name`` (A [k, r], B [r, n]),
    whole on every rank: a dimension the rules shard is gathered (adapters
    are small beside the activations their products would gather)."""
    out = []
    for part, full in (("a", (k, config.lora_r)), ("b", (config.lora_r, n))):
        t = layer_slice(layers[f"{name}_lora_{part}"], li)
        for dim in (0, 1):
            if t.shape[dim] < full[dim]:
                t = gather(t, dim, group)
        out.append(t)
    return tuple(out)


def _col(h, hq, layers: dict, name: str, li: int, full: int, *, group, config, impl,
         out_dtype=None):
    """h [B, T, K] (whole on every rank) through a column-parallel weight:
    (y [B, T, n], its columns (lo, n) of ``full``), plus the weight's LoRA
    delta at those columns where the tree holds an adapter. ``hq``: the
    W8A8 activations."""
    n = _width(layers[name], "out")
    cols = _share(n, full, group_rank(group))
    share = cols[1] < full
    y = _project(copy_to_group(h, group) if share else h, layers, name, li, (n,), acts=hq,
                 out_dtype=out_dtype, impl=impl)
    if _has_adapter(layers, name) and not is_quantized(layers[name]):
        a, b = _adapter(layers, name, li, h.shape[-1], full, config, group)
        if share:  # the rank's columns of B; the rank-r product's gradient summed
            b = _take(b, 1, *cols, group)
        y = y + lora_delta(h, a, b, config,
                           low=(lambda u: copy_to_group(u, group)) if share else None)
    return y, cols


def _row(x, cols: tuple, layers: dict, name: str, li: int, full: int, out_dim: int, *,
         group, config, impl, w8a8: bool, out_dtype):
    """x [B, T, n] (its columns ``cols`` of the weight's K = ``full``)
    through a row-parallel weight, plus its LoRA delta: [B, T, out_dim],
    whole on every rank. Partial products sum in fp32 (the W8A8 ones as
    integer sums, their row scales from the row maxima over all of K)
    before the cast."""
    leaf = layers[name]
    want = _share(_width(leaf, "in", 2 if name == "wo" else 1), full, group_rank(group))
    sharded = want[1] < full
    x = _relayout(x, cols, want, full, group)
    if w8a8:
        xq, xs = quantize_acts(x, functools.partial(all_reduce, group=group,
                                                    op=dist.ReduceOp.MAX) if sharded else None)
        y = quant_apply_w8a8(xq, xs, {k: v[li] for k, v in leaf.items()}, (out_dim,),
                             out_dtype=out_dtype, impl=impl,
                             reduce=functools.partial(all_reduce, group=group) if sharded
                             else None)
    else:
        y = _project(x, layers, name, li, (out_dim,), impl=impl,
                     out_dtype=torch.float32 if sharded else out_dtype)
        if sharded:
            y = reduce_from_group(y, group).to(out_dtype)
    if _has_adapter(layers, name) and not is_quantized(leaf):
        a, b = _adapter(layers, name, li, full, out_dim, config, group)
        if sharded:  # the rows of A that meet the rank's share of K
            a = _take(a, 0, *want, group)
        y = y + lora_delta(x, a, b, config,
                           low=(lambda u: reduce_from_group(u, group)) if sharded else None)
    return y


def _attn_heads(q_cols: tuple, k_cols: tuple, config: DecoderConfig):
    """The heads a rank attends with: ((q columns), (k / v columns)) when its
    q share is whole heads whose kv heads it holds or can take from a whole
    k / v; None when it must gather q, k and v and attend with every head
    (a whole q among them)."""
    NH, NKV, HD = config.num_heads, config.num_kv_heads, config.head_dim
    G = NH // NKV
    (q_lo, q_n), (k_lo, k_n) = q_cols, k_cols
    if q_n == NH * HD or q_lo % HD or q_n % HD:
        return None
    h0, nh = q_lo // HD, q_n // HD
    if nh % G == 0 and h0 % G == 0:
        kv = (h0 // G * HD, nh // G * HD)
    elif G % nh == 0 and h0 // G == (h0 + nh - 1) // G:
        kv = (h0 // G * HD, HD)
    else:
        return None
    if k_n == NKV * HD or (k_lo, k_n) == kv:
        return q_cols, kv
    return None


def local_kv_heads(layers: dict, config: DecoderConfig, group) -> int:
    """The kv heads a rank's KV cache holds under tensor parallelism over
    ``group`` (all of them with no group)."""
    if group_size(group) == 1:
        return config.num_kv_heads
    rank, HD = group_rank(group), config.head_dim
    q_cols = _share(_width(layers["wq"], "out"), config.num_heads * HD, rank)
    k_cols = _share(_width(layers["wk"], "out"), config.num_kv_heads * HD, rank)
    heads = _attn_heads(q_cols, k_cols, config)
    return config.num_kv_heads if heads is None else heads[1][1] // HD


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
    trainable: bool = False,
    group=None,
    chunk_vis=None,
) -> torch.Tensor:
    """Decoder block ``li`` of the stacked tree ``layers``. ``cache`` is the
    whole cache; the block writes its chunk's k/v into its stripe in place
    at ``cache_index`` (quantized per slot for the int8 cache). With
    ``decode_bias`` ([B, S]) the step attends over the stripe, with
    ``chunk_vis`` a chunk of a chunked prefill over it (``_attend_chunk``),
    else the chunk attends causally to itself under ``flash_bias`` ([B, T]),
    with ``trainable`` through the differentiable wrapper.

    Routing of a quantized tree, as the JAX package's defaults, decided on
    the q (or fused qkv) leaf: a chunk of more than one token with
    ``config.act_quant`` runs W8A8, or W4A8 on per-channel packed leaves
    (activations quantized once per consumer group); a T = 1 step is always
    weight-only, and so is every chunk of a group-scaled packed tree, whose
    scales apply inside the contraction. The fused serving leaves ``wqkv`` /
    ``w_gateup`` are used where present (one rank only: a mesh unfuses).

    With ``group`` (the 'model' group of a mesh) the block runs on this
    rank's shards: q / k / v and gate / up column-parallel, wo and w_down
    row-parallel with the all-reduce after; the rank attends with its q heads
    and the kv heads they group onto (its KV cache holds those), or, where
    the shares are not whole heads, with every head after a gather. ``x`` is
    whole on every rank, in and out."""
    B, T, D = x.shape
    NH, NKV, HD = config.num_heads, config.num_kv_heads, config.head_dim
    NQ, NKVW = NH * HD, NKV * HD
    fused_qkv = "wqkv" in layers
    wq = layers["wqkv" if fused_qkv else "wq"]
    grouped = is_packed4(wq) and packed4_groups(wq) > 1
    w8a8 = config.act_quant and T > 1 and is_quantized(wq) and not grouped
    kw = dict(group=group, config=config, impl=impl)

    h = rms_norm(x, layer_slice(layers["attn_norm"], li), config.rms_eps)
    hq = quantize_acts(h) if w8a8 else None  # one rounding pass shared by q/k/v
    if fused_qkv:
        qkv, _ = _col(h, hq, layers, "wqkv", li, NQ + 2 * NKVW, **kw)
        q, k, v = qkv.split((NQ, NKVW, NKVW), dim=-1)
        q_cols, k_cols, v_cols = (0, NQ), (0, NKVW), (0, NKVW)
    else:
        q, q_cols = _col(h, hq, layers, "wq", li, NQ, **kw)
        k, k_cols = _col(h, hq, layers, "wk", li, NKVW, **kw)
        v, v_cols = _col(h, hq, layers, "wv", li, NKVW, **kw)
    heads = _attn_heads(q_cols, k_cols, config)
    if heads is None:
        q = _relayout(q, q_cols, (0, NQ), NQ, group)
        heads = ((0, NQ), (0, NKVW))
    qc, kvc = heads
    k = _relayout(k, k_cols, kvc, NKVW, group)
    v = _relayout(v, v_cols, kvc, NKVW, group)
    nh, nkv = qc[1] // HD, kvc[1] // HD
    q, k, v = (t.reshape(B, T, n, HD).transpose(1, 2) for t, n in ((q, nh), (k, nkv), (v, nkv)))
    if config.attn_qkv_bias:  # qwen2: after the LoRA deltas, before RoPE
        def bias(name, c, n):
            bl = layer_slice(layers[name], li)
            if n < bl.shape[0]:
                bl = _take(bl, 0, c[0] // HD, n, group)
            return bl[None, :, None, :]

        q = q + bias("bq", qc, nh).to(q.dtype)
        k = k + bias("bk", kvc, nkv).to(k.dtype)
        v = v + bias("bv", kvc, nkv).to(v.dtype)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = _attend(q, k, v, li, config=config, flash_bias=flash_bias, decode_bias=decode_bias,
                   cache=cache, cache_index=cache_index, impl=impl, trainable=trainable,
                   chunk_vis=chunk_vis)
    attn_flat = attn.transpose(1, 2).reshape(B, T, nh * HD)
    x = x + _row(attn_flat, qc, layers, "wo", li, NQ, D, w8a8=w8a8, out_dtype=x.dtype, **kw)

    h = rms_norm(x, layer_slice(layers["mlp_norm"], li), config.rms_eps)
    if "router" in layers:  # routed experts (whole, or a share a rank), no MLP adapters
        lp = {name: layer_slice(layers[name], li) for name in MOE_KEYS}
        ep = lp["w_gate"].shape[0] < config.num_experts
        return x + moe_mlp(h, lp, config, group=group if ep else None)
    # gate and up stay fp32 into silu, as the JAX package's
    # preferred_element_type=float32 keeps them
    I = config.intermediate_size
    hq = quantize_acts(h) if w8a8 else None  # shared by gate/up
    f32 = dict(out_dtype=torch.float32, **kw)
    if "w_gateup" in layers:
        gate, up = _col(h, hq, layers, "w_gateup", li, 2 * I, **f32)[0].chunk(2, dim=-1)
        g_cols = (0, I)
    else:
        gate, g_cols = _col(h, hq, layers, "w_gate", li, I, **f32)
        up, u_cols = _col(h, hq, layers, "w_up", li, I, **f32)
        up = _relayout(up, u_cols, g_cols, I, group)
    act = F.silu(gate) * up
    if not w8a8:
        act = act.to(x.dtype)
    return x + _row(act, g_cols, layers, "w_down", li, I, D, w8a8=w8a8, out_dtype=x.dtype,
                    **kw)


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
    remat: bool = False,
    trainable: bool = False,
    tp_group=None,
):
    """Run the decoder stack (causal). Without a cache: attention within
    the sequence, with ``trainable`` through ``flash_attention_trainable``
    (forward and backward kernels); ``remat`` runs each layer under a
    non-reentrant checkpoint, so only its input is kept for the backward.
    With a cache, keys/values are written at ``cache_index``; a T=1 step then attends over the static cache, masked by ``cache_mask``
    (slots valid before this call) plus its own slot. A T > 1 chunk at
    ``cache_index`` 0 is prefill into an empty cache (``cache_mask`` not
    read), as the JAX package's flash path assumes; at ``cache_index`` > 0 it
    is a chunk of a chunked prefill, which attends as the JAX package's
    einsum path does: query i sees the slots of ``cache_mask`` and the
    chunk's real slots up to its own (``_attend_chunk``; the JAX package's
    flash path would drop the earlier slots). The layer weights may be
    dense, int8 ``{'q', 's'}`` or packed int4 ``{'qp', 's'}`` leaves, per
    weight or in the fused serving layout; the
    cache the (k, v) pair or the int8 dict of ``init_kv_cache``. With
    ``tp_group`` (the 'model' group of a mesh) the layers run on this rank's
    shards of a tree placed by ``runtime/mesh.py`` (see ``_layer``), the
    cache holding ``local_kv_heads``; ``embeds`` and the result are whole on
    every rank. Returns (final-normed hidden, cache)."""
    B, T, D = embeds.shape
    dev = embeds.device
    x = embeds
    cos, sin = rope_cos_sin(positions, config.head_dim, config.rope_theta)

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    flash_bias = decode_bias = chunk_vis = None
    S = None if cache is None else (cache["kq"] if isinstance(cache, dict) else cache[0]).shape[3]
    if cache is not None and T == 1:
        vis = (torch.arange(S, device=dev) == cache_index)[None] & attn_mask.bool()
        if cache_mask is not None:
            vis = vis | cache_mask
        decode_bias = torch.where(vis, zero, neg).contiguous()
    elif cache is not None and cache_index != 0:
        if cache_index + T > S:
            raise ValueError(f"a chunk of {T} at slot {cache_index} passes the cache's {S}")
        new = torch.zeros((B, S), dtype=torch.bool, device=dev)
        new[:, cache_index:cache_index + T] = attn_mask.bool()
        old = (cache_mask.bool() if cache_mask is not None
               else torch.zeros((B, S), dtype=torch.bool, device=dev))
        # once a call: whether old marks a slot the causal offset would hide
        marked = cache_mask is not None and bool(old[:, cache_index:].any())
        chunk_vis = (old, new, marked)
    else:
        flash_bias = torch.where(attn_mask.bool(), zero, neg).contiguous()

    layers = params["layers"]
    trainable = trainable and flash_bias is not None and T > 1 and cache is None
    group = tp_group if group_size(tp_group) > 1 else None
    for li in range(layers["attn_norm"].shape[0]):
        layer = functools.partial(
            _layer, layers=layers, li=li, config=config, cos=cos, sin=sin,
            flash_bias=flash_bias, decode_bias=decode_bias,
            cache=cache, cache_index=cache_index, impl=impl, trainable=trainable, group=group,
            chunk_vis=chunk_vis,
        )
        if remat and torch.is_grad_enabled():
            x = checkpoint(layer, x, use_reentrant=False)
        else:
            x = layer(x)
    return rms_norm(x, params["final_norm"], config.rms_eps), cache


HEAD_NAMES = ("lm_head", "sync_head", "time_head", "score_head")


def compute_logits(params: dict, hidden: torch.Tensor, *,
                   impl: str = "auto", tp_group=None,
                   vocab_size: Optional[int] = None) -> torch.Tensor:
    """hidden [..., D] -> combined fp32 logits [..., V + 1 + Vt + Vs] in
    text|sync|time|score order. The products run in fp32 on the exact fp32
    values of the bf16 operands, as the JAX package's
    preferred_element_type=fp32 does; an int8 ``lm_head`` goes weight-only
    through ``quant_matmul`` with an fp32 result, at every T. With
    ``tp_group`` an ``lm_head`` sharded over the vocabulary (its width under
    ``vocab_size``) gives this rank's columns, gathered into the whole
    logits on every rank."""
    h = hidden.float()
    parts = [h @ params[name].float() for name in HEAD_NAMES[1:]]
    lm_head = params["lm_head"]
    width = (lm_head["q"] if is_quantized(lm_head) else lm_head).shape[-1]
    sharded = group_size(tp_group) > 1 and width < vocab_size
    if is_quantized(lm_head):
        text = quant_apply(hidden, lm_head, (width,), out_dtype=torch.float32, impl=impl)
    else:
        text = (copy_to_group(h, tp_group) if sharded else h) @ lm_head.float()
    if sharded:
        text = gather(text, -1, tp_group)
    return torch.cat([text] + parts, dim=-1)


def init_kv_cache(
    config: DecoderConfig, batch_size: int, max_len: int,
    dtype=torch.bfloat16, device=None, *, num_kv_heads: Optional[int] = None,
):
    """Static cache: the (k, v) pair, each [L, B, NKV, max_len, hd] in
    ``dtype``; or, for ``config.kv_cache_dtype == "int8"``, the dict
    ``{kq, ks, vq, vs}`` with int8 values and bf16 scales
    [L, B, NKV, 1, max_len] (one per layer, row, kv head and slot; the JAX
    package's layout). ``num_kv_heads`` (default the config's) sizes a
    tensor-parallel rank's cache (``local_kv_heads``)."""
    shape = (config.num_layers, batch_size, num_kv_heads or config.num_kv_heads, max_len,
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
