"""Mixtral-style routed-expert MLP (trace_tpu/model/moe.py): the Mistral
block with its MLP replaced by ``num_experts`` SwiGLU experts, ``top_k`` of
them routed per token, the expert weights stacked per layer on an [L, E, ...]
axis (router [L, D, E], w_gate / w_up [L, E, D, I], w_down [L, E, I, D]).

Routing follows Mixtral and the JAX package: softmax of the fp32 router
logits, the top-k experts of each token, their probabilities renormalized.
Top-k breaks ties as ``jax.lax.top_k`` does, the lower expert first (a
stable descending sort): a left-padded row of zeros has exactly uniform
probabilities and must pick experts 0 .. k-1.

Two forms, as in the JAX package:

* ``"sparse"``: capacity-bucketed dispatch. Each of the N * k assignments
  (token-major) takes the next slot of its expert's bucket of
  C = ceil(N k cf / E) rows; an assignment past C goes to a dump row, which
  is written and discarded, and the token loses that expert's contribution
  (Switch semantics, earlier tokens win). The slot arithmetic is integer
  cumsums, equal to JAX's.
* ``"dense"``: every expert computes every token and the outputs mix by the
  gate vector (zero off the top-k): exact, no drops. Converted checkpoints
  get it.

The rounding points are JAX's: router logits, gate, up and expert outputs
are fp32 sums of the operands' products (``matmul_f32``: on the card one
bf16 product with an fp32 output, never an fp32 copy of an expert);
``silu(gate) * up`` is cast to x's dtype before ``w_down``; the sparse
combine gathers fp32 rows and sums the k of them in fp32, the dense mix sums
over the experts in fp32; one cast to x's dtype at the end. Both forms run
one expert at a time, so no [N, E, I] fp32 transient is held (1.9 GB a
tensor at a 2 x 2100-token prefill of Mixtral-8x7B); the dense mix then sums
its experts in order 0 .. E-1, where JAX's einsum picks its own order (fp32,
within 1e-5 of it). Routing, scatter and gather are eager torch operations:
the JAX package runs the expert products as XLA einsums, outside any Pallas
kernel, and so does the port.

Expert parallelism: ``moe_mlp`` also takes a layer whose expert stacks hold
a rank's even share of the E experts (E / n consecutive ones) with the
'model' group of n ranks: the router is whole and routes over all E
experts, each rank sums the contributions of its own experts, and an
all-reduce adds the ranks. ``MOE_PARAM_RULES`` is the JAX package's
placement of the stacks; as there, ``runtime/mesh.py shard_params`` does not
apply it (the [L, E, D, I] stacks match no rule of ``_PARAM_RULES`` and stay
whole), and an expert-parallel layer is placed by hand.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from trace_tpu_torch.kernels.quant_matmul import matmul_f32
from trace_tpu_torch.model.config import MoEConfig
from trace_tpu_torch.parallel.collectives import copy_to_group, group_rank, reduce_from_group

# a layer's routed-expert leaves, each stacked [L, ...]
MOE_KEYS = ("router", "w_gate", "w_up", "w_down")

# Expert stacks partition as (None, 'model', None, None): each 'model' rank
# holds E / model experts; the mixture sums over the experts, so their
# contributions add up across the ranks (the expert-parallel all-reduce).
MOE_PARAM_RULES = (
    ("moe/router", (None, None, None)),
    ("moe/w_gate", (None, "model", None, None)),
    ("moe/w_up", (None, "model", None, None)),
    ("moe/w_down", (None, "model", None, None)),
)

__all__ = ["MOE_KEYS", "MOE_PARAM_RULES", "MoEConfig", "init_moe_decoder_params", "init_moe_mlp_params",
           "moe_aux_loss", "moe_mlp", "route", "dispatch"]


def init_moe_mlp_params(config: MoEConfig, generator: torch.Generator,
                        dtype=torch.float32, device=None) -> dict:
    """Per-layer-stacked expert weights, N(0, 0.02), drawn from
    ``generator`` on ``device`` (default: the generator's): router [L, D, E],
    w_gate / w_up [L, E, D, I], w_down [L, E, I, D]. JAX's PRNG cannot be
    matched, so the values differ from its."""
    from trace_tpu_torch.params import _Init

    c = config
    L, E, D, I = c.num_layers, c.num_experts, c.hidden_size, c.intermediate_size
    r = _Init(generator, torch.device(device if device is not None else generator.device),
              dtype)
    return {
        "router": r.normal((L, D, E)),
        "w_gate": r.normal((L, E, D, I)),
        "w_up": r.normal((L, E, D, I)),
        "w_down": r.normal((L, E, I, D)),
    }


def init_moe_decoder_params(config: MoEConfig, generator: torch.Generator,
                            dtype=torch.float32, device=None) -> dict:
    """A whole Mixtral-family decoder: the Mistral attention stack, norms,
    embedding and heads of ``params.init_trace_params`` with the dense MLP
    weights replaced by routed expert weights (``init_moe_mlp_params``)."""
    from trace_tpu_torch.params import _decoder, _Init

    device = torch.device(device if device is not None else generator.device)
    params = _decoder(config, _Init(generator, device, dtype), mlp=False)
    params["layers"].update(init_moe_mlp_params(config, generator, dtype, device))
    return params


def route(x2d: torch.Tensor, router: torch.Tensor, top_k: int):
    """x2d [N, D] through the router [D, E]: (the renormalized probabilities
    of the top-k experts [N, k] fp32, their indices [N, k] int64, in
    descending order, ties to the lower index)."""
    probs = torch.softmax(matmul_f32(x2d, router), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_vals, top_idx = vals[:, :top_k], idx[:, :top_k]
    return top_vals / top_vals.sum(dim=-1, keepdim=True), top_idx


def capacity(n_tokens: int, config: MoEConfig) -> int:
    """Rows of an expert's bucket: ceil(N k cf / E), at least 1 (JAX's
    expression, in Python floats)."""
    c = config
    return max(1, math.ceil(n_tokens * c.top_k * c.capacity_factor / c.num_experts))


def dispatch(top_idx: torch.Tensor, num_experts: int, cap: int):
    """The sparse form's slots of the N * k assignments of ``top_idx``
    (token-major): (within, keep, slot), each [N * k] int64 / bool. ``within``
    counts the earlier assignments to the same expert, ``keep`` is
    within < cap, and ``slot`` is expert * cap + within, or the dump row
    E * cap where not kept."""
    flat_e = top_idx.reshape(-1)
    onehot = F.one_hot(flat_e, num_experts)
    within = ((onehot.cumsum(dim=0) - onehot) * onehot).sum(dim=1)
    keep = within < cap
    slot = torch.where(keep, flat_e * cap + within, num_experts * cap)
    return within, keep, slot


def _swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor, dtype) -> torch.Tensor:
    """One expert on rows x [M, D]: fp32 gate and up, their SwiGLU cast to
    ``dtype``, then ``w_down`` with an fp32 result [M, D]."""
    act = (F.silu(matmul_f32(x, w_gate)) * matmul_f32(x, w_up)).to(dtype)
    return matmul_f32(act, w_down)


def moe_mlp(x: torch.Tensor, lp: dict, config: MoEConfig, *, group=None) -> torch.Tensor:
    """x [B, T, D] -> [B, T, D] through the top-k routed expert SwiGLU MLPs of
    one layer (``lp``: router [D, E], w_gate / w_up [E, D, I], w_down
    [E, I, D]), in ``config.moe_impl``'s form. With ``group`` the expert
    stacks hold this rank's share of the experts (see the module's note);
    ``x`` and the result are whole on every rank."""
    if config.moe_impl not in ("sparse", "dense"):
        raise ValueError(f"moe_impl must be 'sparse' or 'dense', got {config.moe_impl!r}")
    n_local = lp["w_gate"].shape[0]
    first = group_rank(group) * n_local
    if first + n_local > config.num_experts or (group is None and n_local != config.num_experts):
        raise ValueError(f"{n_local} experts a rank do not tile {config.num_experts}")
    form = _moe_mlp_sparse if config.moe_impl == "sparse" else _moe_mlp_dense
    return reduce_from_group(form(x, lp, config, first, group), group).to(x.dtype)


def _experts(lp: dict):
    """(w_gate, w_up, w_down) of each expert: views of the layer's stacks,
    whose backward stacks the experts' gradients once."""
    return zip(lp["w_gate"].unbind(0), lp["w_up"].unbind(0), lp["w_down"].unbind(0))


def _moe_mlp_sparse(x: torch.Tensor, lp: dict, config: MoEConfig, first: int,
                    group) -> torch.Tensor:
    """The experts ``first`` ... of ``lp``'s stacks over the capacity
    buckets of all E: their fp32 contributions [B, T, D]."""
    B, T, D = x.shape
    N, E, k = B * T, config.num_experts, config.top_k
    cap = capacity(N, config)
    xf = x.reshape(N, D)
    top_vals, top_idx = route(xf, lp["router"], k)
    _, keep, slot = dispatch(top_idx, E, cap)

    # row n repeated for its k assignments, scattered into the buckets
    xr = copy_to_group(xf, group).repeat_interleave(k, dim=0)
    buf = xf.new_zeros((E * cap + 1, D)).index_put((slot,), xr)
    n_local = lp["w_gate"].shape[0]
    rows = buf[first * cap:(first + n_local) * cap].view(n_local, cap, D)
    outs = [_swiglu(r, wg, wu, wd, x.dtype) for r, (wg, wu, wd) in zip(rows, _experts(lp))]
    zeros = lambda n: xf.new_zeros((n, D), dtype=torch.float32)
    flat_out = torch.cat([zeros(first * cap)] + outs + [zeros((E - first - n_local) * cap + 1)],
                         dim=0)
    gathered = flat_out[slot]  # [N k, D] fp32
    weighted = gathered * (copy_to_group(top_vals, group).reshape(-1) * keep)[:, None]
    return weighted.view(N, k, D).sum(dim=1).view(B, T, D)


def _moe_mlp_dense(x: torch.Tensor, lp: dict, config: MoEConfig, first: int,
                   group) -> torch.Tensor:
    """Every token through the experts ``first`` ... of ``lp``'s stacks,
    mixed by the gate vector: their fp32 contributions [B, T, D]."""
    B, T, D = x.shape
    xf = x.reshape(B * T, D)
    top_vals, top_idx = route(xf, lp["router"], config.top_k)
    gates = torch.zeros((B * T, config.num_experts), dtype=torch.float32,
                        device=x.device).scatter(-1, top_idx, top_vals)
    xf, gates = copy_to_group(xf, group), copy_to_group(gates, group)
    out = None
    for e, (wg, wu, wd) in enumerate(_experts(lp), start=first):
        part = _swiglu(xf, wg, wu, wd, x.dtype) * gates[:, e, None]
        out = part if out is None else out + part
    return out.view(B, T, D)


def moe_aux_loss(x: torch.Tensor, lp: dict, config: MoEConfig) -> torch.Tensor:
    """Switch-style load-balancing loss: E x sum over experts of (the share
    of tokens whose top-1 is the expert) x (its mean probability). Not part
    of the training loss, as in the JAX package."""
    E = config.num_experts
    probs = torch.softmax(matmul_f32(x.reshape(-1, x.shape[-1]), lp["router"]), dim=-1)
    frac = F.one_hot(probs.argmax(dim=-1), E).float().mean(dim=0)
    return E * (frac * probs.mean(dim=0)).sum()
