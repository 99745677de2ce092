"""GPipe pipeline parallelism for the decoder stack
(trace_tpu/parallel/pipeline.py on ``torch.distributed``).

* A pipeline mesh puts the world's ranks on a 'stage' axis (and, with more
  ranks than stages, a 'model' axis whose ranks repeat the same stage);
* the layer-stacked params [L, ...] split into S stages of L / S layers,
  stage s on the ranks of stage index s;
* the batch splits into M microbatches and the schedule runs M + S - 1
  ticks: at tick t stage s runs microbatch t - s (a bubble tick runs
  nothing), and its output hops to stage s + 1 through a broadcast in their
  two-rank group (``parallel/collectives.py hop``);
* the last stage's outputs are broadcast to every stage (the JAX package's
  ``psum`` over 'stage'), and the final RMSNorm runs on every rank.

The backward is the reverse schedule, written out in one autograd Function:
stage s recomputes its layers on each microbatch's saved input (the stage
is rematerialised; ``remat`` also checkpoints each layer inside it), takes
the gradient of its output (the caller's on the last stage, the hop back
from stage s + 1 elsewhere), accumulates its layers' gradients and hops
the gradient of its input back to s - 1. The embeddings' gradient, stage
0's, is then summed over the stages, so every rank holds it whole. The
layers of the other stages get no gradient on a rank: a train step sums the
layer gradients over 'stage' (``train/train.py``).

The JAX package turns its Pallas kernels off under a pipeline mesh; each
stage here runs the hand-written attention kernels: ``flash_attention``
in the forward, ``flash_attention_trainable`` (forward with the
logsumexp, then the dq and dk/dv kernels) in the recomputation.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from trace_tpu_torch.model.config import DecoderConfig
from trace_tpu_torch.model.mistral import NEG_INF, _layer, rms_norm, rope_cos_sin
from trace_tpu_torch.parallel.collectives import all_reduce, broadcast, hop
from trace_tpu_torch.runtime.mesh import Mesh, grid_mesh


def build_pp_mesh(num_stages: int, n_devices: Optional[int] = None, *, device=None) -> Mesh:
    """A 'stage' mesh over ``num_stages`` ranks, or a ('stage', 'model') grid
    when ``n_devices`` (the world's ranks) exceeds it; ``device`` is the
    rank's (default: its CUDA card). Every rank calls it: it makes the
    groups of neighbouring stages too."""
    n = n_devices or num_stages
    if n % num_stages:
        raise ValueError("devices must tile stages")
    if n == num_stages:
        mesh = grid_mesh(("stage",), (num_stages,), device=device)
    else:
        mesh = grid_mesh(("stage", "model"), (num_stages, n // num_stages), device=device)
    # the two-rank groups of neighbouring stages, made by every rank in one order
    stride = n // num_stages
    for first in range(num_stages - 1):
        for col in range(stride):
            pair = [first * stride + col, (first + 1) * stride + col]
            g = dist.new_group(pair) if n > 1 else None
            if dist.is_initialized() and dist.get_rank() in pair:
                mesh.hops[first] = (g, pair)
    return mesh


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def split_layers_into_stages(layers: dict, num_stages: int) -> dict:
    """[L, ...]-stacked layer params -> [S, L/S, ...] (views)."""
    L = layers["attn_norm"].shape[0]
    if L % num_stages:
        raise ValueError(f"{L} layers must tile {num_stages} stages")
    return _tree_map(lambda x: x.reshape((num_stages, L // num_stages) + x.shape[1:]), layers)


class _Schedule:
    """One rank's share of a GPipe run: its stage's layers, the microbatches'
    RoPE tables and padding biases, the hops to its neighbours, and what the
    forward keeps for the backward (each microbatch's stage input)."""

    def __init__(self, layers, first_layer, n_layers, config, cos, sin, bias, mesh, M,
                 remat, impl, embeds_grad):
        self.layers, self.first, self.n = layers, first_layer, n_layers
        self.config, self.cos, self.sin, self.bias = config, cos, sin, bias
        self.S, self.s, self.M = mesh.shape["stage"], mesh.coord("stage"), M
        self.group = mesh.group("stage")
        self.last_rank = mesh.ranks["stage"][-1]
        self.left = mesh.hops.get(self.s - 1) if self.s > 0 else None
        self.right = mesh.hops.get(self.s) if self.s < self.S - 1 else None
        self.remat, self.impl, self.embeds_grad = remat, impl, embeds_grad
        self.inputs = {}

    def stage(self, x, m: int, trainable: bool):
        for li in range(self.first, self.first + self.n):
            def layer(h, li=li):
                return _layer(h, self.layers, li, config=self.config, cos=self.cos[m],
                              sin=self.sin[m], flash_bias=self.bias[m], impl=self.impl,
                              trainable=trainable)
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, use_reentrant=False)
            else:
                x = layer(x)
        return x

    def _send(self, x, link, to_right: bool):
        g, pair = link
        src, dst = (pair[0], pair[1]) if to_right else (pair[1], pair[0])
        hop(x, src, dst, g)

    def _recv(self, like, link, from_left: bool):
        g, pair = link
        src, dst = (pair[0], pair[1]) if from_left else (pair[1], pair[0])
        return hop(None, src, dst, g, shape=like.shape, dtype=like.dtype, device=like.device)

    def forward(self, embeds):
        S, s, M = self.S, self.s, self.M
        x_mb = embeds.chunk(M)
        received, outs = {}, [None] * M
        for t in range(M + S - 1):
            m = t - s
            if 0 <= m < M:
                inp = x_mb[m] if s == 0 else received.pop(m)
                self.inputs[m] = inp
                h = self.stage(inp, m, trainable=False)
                if s == S - 1:
                    outs[m] = h
                else:
                    self._send(h, self.right, to_right=True)
            if s > 0 and 0 <= t - s + 1 < M:  # stage s - 1's output of this tick
                received[t - s + 1] = self._recv(x_mb[0], self.left, from_left=True)
        out = torch.cat(outs) if s == S - 1 else torch.empty_like(embeds)
        return broadcast(out, self.last_rank, self.group)

    def backward(self, g):
        S, s, M = self.S, self.s, self.M
        g_mb = g.chunk(M)
        received, d_in = {}, [None] * M
        for t in reversed(range(M + S - 1)):
            m = t - s
            if 0 <= m < M:
                dh = g_mb[m] if s == S - 1 else received.pop(m)
                with torch.enable_grad():
                    inp = self.inputs.pop(m).detach().requires_grad_(
                        s > 0 or self.embeds_grad)
                    h = self.stage(inp, m, trainable=True)
                    torch.autograd.backward(h, dh.to(h.dtype))
                if s > 0:
                    self._send(inp.grad, self.left, to_right=False)
                else:
                    d_in[m] = inp.grad
            if s < S - 1 and 0 <= t - s - 1 < M:  # stage s + 1's input gradient
                received[t - s - 1] = self._recv(g_mb[0], self.right, from_left=False)
        if not self.embeds_grad:
            return None
        d = torch.cat(d_in) if s == 0 else torch.zeros_like(g)
        return all_reduce(d, self.group)


class _Pipeline(torch.autograd.Function):
    """The schedule as one autograd node. ``anchor`` (a scalar that takes a
    gradient) puts the node on the graph when only the layers, which it
    reads from the schedule, take gradients."""

    @staticmethod
    def forward(ctx, embeds, anchor, schedule):
        ctx.schedule = schedule
        with torch.no_grad():
            return schedule.forward(embeds)

    @staticmethod
    def backward(ctx, g):
        return ctx.schedule.backward(g.contiguous()), None, None


def pp_decoder_forward(
    params: dict,
    config: DecoderConfig,
    embeds: torch.Tensor,     # [B, T, D]
    attn_mask: torch.Tensor,  # [B, T] bool
    positions: torch.Tensor,  # [B, T] int
    *,
    mesh: Mesh,
    num_microbatches: int,
    remat: bool = False,
    impl: str = "auto",
) -> torch.Tensor:
    """Cache-less causal decoder forward, pipelined over the mesh's 'stage'
    axis: ``decoder_forward(causal)``'s final-normed hidden [B, T, D], on
    every rank. ``params["layers"]`` holds all L layers (each rank runs its
    stage's L / S) or this stage's L / S (``split_layers_into_stages(...)``
    at the stage index). Differentiable end to end (see the module's note);
    ``remat`` checkpoints each layer inside a stage.

    Single-token decode does not run under a pipeline (a step would
    serialize across the stages); serving shards with tensor parallelism
    (``runtime/generate.py generate_sharded``)."""
    B, T, D = embeds.shape
    M, S = num_microbatches, mesh.shape["stage"]
    if B % M:
        raise ValueError("batch must tile microbatches")
    L = config.num_layers
    if L % S:
        raise ValueError(f"{L} layers must tile {S} stages")
    per = L // S
    held = params["layers"]["attn_norm"].shape[0]
    first = mesh.coord("stage") * per if held == L else 0
    if held not in (L, per):
        raise ValueError(f"the tree holds {held} layers: {L}, or a stage's {per}")

    cos, sin = rope_cos_sin(positions, config.head_dim, config.rope_theta)
    zero = torch.zeros((), dtype=torch.float32, device=embeds.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=embeds.device)
    bias = torch.where(attn_mask.bool(), zero, neg).contiguous()
    schedule = _Schedule(params["layers"], first, per, config, cos.chunk(M), sin.chunk(M),
                         [b.contiguous() for b in bias.chunk(M)], mesh, M, remat, impl,
                         embeds.requires_grad and torch.is_grad_enabled())
    layer_grads = any(t.requires_grad for t in _leaves(params["layers"]))
    if torch.is_grad_enabled() and (schedule.embeds_grad or layer_grads):
        anchor = torch.zeros((), device=embeds.device, requires_grad=True)
        x = _Pipeline.apply(embeds, anchor, schedule)
    else:
        x = schedule.forward(embeds)
    return rms_norm(x, params["final_norm"], config.rms_eps)
