"""The collectives of the port's parallel paths: what GSPMD inserts in the
JAX package, written out with ``torch.distributed``.

Every one is built from ``all_reduce`` and ``broadcast`` alone, the two
collectives a gloo group takes on CUDA tensors, so each runs on gloo over
CPU tensors (the tests), on gloo over CUDA tensors (several ranks on one
card, where NCCL refuses a second rank) and on NCCL alike.

Tensor parallelism follows Megatron's pair of operators around a sharded
region, each an autograd Function where a gradient flows through it:

* ``copy_to_group``: identity forward, all-reduce backward. A replicated
  tensor passes through it before a rank-specific computation (a product
  with a column shard, a slice of heads), so its gradient, a partial sum on
  each rank, comes back whole;
* ``reduce_from_group``: all-reduce forward, identity backward. It sums the
  partial results of row-sharded products;
* ``gather``: a dimension sharded over the group made whole, as a
  zero-padded all-reduce; its backward takes the rank's slice of the
  gradient (what follows it is replicated, so that gradient is whole);
* ``hop``: the pipeline's stage hop, a ``broadcast`` in the two-rank group
  of neighbouring stages.

``group=None`` (one rank) makes each of them the identity.

``TIMING`` measures what the collectives cost: with ``TIMING["on"]`` each
call synchronizes the device before and after and adds its host time to
``TIMING["seconds"]`` and one to ``TIMING["calls"]`` (off by default: the
synchronizations would cost time of their own).
"""

from __future__ import annotations

import time
from typing import Optional

import torch
import torch.distributed as dist

TIMING = {"on": False, "seconds": 0.0, "calls": 0}


def _run(fn, x: torch.Tensor) -> None:
    """``fn()``, a collective on ``x``, timed when TIMING is on."""
    if not TIMING["on"]:
        fn()
        return
    sync = torch.cuda.synchronize if x.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    TIMING["seconds"] += time.perf_counter() - t0
    TIMING["calls"] += 1


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce(x: torch.Tensor, group, op=None) -> torch.Tensor:
    """A new tensor: the sum (or ``op``) of ``x`` over the group."""
    out = x.contiguous().clone()
    if group_size(group) > 1:
        _run(lambda: dist.all_reduce(out, op=dist.ReduceOp.SUM if op is None else op,
                                     group=group), out)
    return out


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The zero-padded all-reduce of ``gather``."""
    shape = list(x.shape)
    shape[dim] *= group_size(group)
    out = x.new_zeros(shape)
    out.narrow(dim, group_rank(group) * x.shape[dim], x.shape[dim]).copy_(x)
    _run(lambda: dist.all_reduce(out, group=group), out)
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.lo, ctx.width = dim, group_rank(group) * x.shape[dim], x.shape[dim]
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.lo, ctx.width).contiguous(), None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over ``group``."""
    if group_size(group) == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` (every rank gets it); the gradient passes as it is."""
    if group_size(group) == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromGroup.apply(x, group)
    return all_reduce(x, group)


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' equal slices of dimension ``dim``, in rank order, made
    whole on every rank (a zero-padded all-reduce); the gradient of the
    result comes back as this rank's slice of it."""
    if group_size(group) == 1:
        return x
    dim = dim % x.ndim
    if torch.is_grad_enabled() and x.requires_grad:
        return _Gather.apply(x, dim, group)
    return _gather(x, dim, group)


def hop(x: Optional[torch.Tensor], src: int, dst: int, group, shape=None, dtype=None,
        device=None) -> torch.Tensor:
    """``x`` from global rank ``src`` to ``dst`` through a broadcast in their
    two-rank ``group``: the sender passes ``x``, the receiver ``x=None`` and
    the buffer's shape, dtype and device, and gets the sender's values. The
    pipeline's forward hops s -> s+1 and its backward the gradient back."""
    if x is None:
        x = torch.empty(shape, dtype=dtype, device=device)
    else:
        x = x.contiguous()
    _run(lambda: dist.broadcast(x, src=src, group=group), x)
    return x


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` of global rank ``src`` on every rank of ``group``, in place."""
    if group_size(group) > 1:
        _run(lambda: dist.broadcast(x, src=src, group=group), x)
    return x
