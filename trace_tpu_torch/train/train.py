"""Training: optimizer groups, freeze policies, the train step and the loop
(trace_tpu/train/train.py on hand-written AdamW in place of optax).

* stage "pretrain": freeze the LM backbone; train the connector at
  ``projector_lr`` plus the time/score/sync towers and auxiliary heads;
* stage "sft": unfreeze the backbone, the LM embedding and ``lm_head``;
* stage "lora": freeze the base weights, train the adapters (and what
  "pretrain" trains);
* AdamW with norm scales and biases excluded from weight decay, a separate
  learning-rate group for the connector, a cosine schedule with 3 % warmup.

What the optimizer reproduces of the JAX package's optax chain: each label
("base", "projector") clips by ITS OWN global norm before Adam; the schedule
is indexed from 0 and warms up from 0, so the first step changes nothing;
Adam is bias-corrected with ``m_hat / (sqrt(v_hat) + eps)``, its moments kept
in the parameter's dtype; the decay term joins the update before the
learning rate, on the ``decay_mask`` leaves and only when
``weight_decay != 0``; ``grad_accum_steps = k`` averages k gradients and
updates on every k-th call.

Under a mesh (``runtime/mesh.py``) a rank holds its shards of the params
and the moments: gradients add up over 'data' (so a step is the step on the
global batch), and every global norm (clipping, ``grad_norm``) adds the
squares of the sharded leaves over 'model'. Under a pipeline mesh
(``parallel/pipeline.py``) every rank holds the whole tree, and the layer
gradients, each stage's on its own ranks, add up over 'stage'.

Unlike the JAX step, which returns new trees, ``train_step`` updates the
parameters and the optimizer state IN PLACE and returns the same objects:
a second copy of a 7B tree does not fit beside the first. Leaves the stage
freezes get ``requires_grad_(False)``, so no gradient of theirs is ever
allocated, while the backward still runs through the frozen layers to the
connector.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from trace_tpu_torch.model.config import TraceConfig
from trace_tpu_torch.model.trace_model import forward_train
from trace_tpu_torch.parallel.collectives import all_reduce
from trace_tpu_torch.video.preprocess import preprocess_frames


# ---------------------------------------------------------------------------
# Parameter grouping
# ---------------------------------------------------------------------------

def _children(tree):
    """(key, child) pairs of a dict, or of a list (a connector's layers):
    its indices, as JAX's paths name them."""
    return tree.items() if isinstance(tree, dict) else enumerate(tree)


def tree_paths(tree: dict, prefix: str = ""):
    """(path, leaf) pairs of nested dicts and lists, paths joined with '/'."""
    for k, v in _children(tree):
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list)):
            yield from tree_paths(v, path)
        else:
            yield path, v


def _map_with_path(fn: Callable, tree, prefix: str = ""):
    out = {}
    for k, v in _children(tree):
        path = f"{prefix}/{k}" if prefix else str(k)
        out[k] = _map_with_path(fn, v, path) if isinstance(v, (dict, list)) else fn(path, v)
    return out if isinstance(tree, dict) else list(out.values())


def param_group(path_s: str, stage: str) -> str:
    """'frozen' | 'projector' | 'base' for a param path under the stage recipe."""
    if path_s.startswith("vision"):
        return "frozen"  # the CLIP tower is frozen in every stage
    if "_lora_" in path_s:
        return "base"  # adapters always train when present
    if path_s.startswith("connector"):
        return "projector"
    if path_s.startswith("towers"):
        return "base"  # time/score/sync embeds: tuned in every stage
    if path_s.startswith("decoder"):
        tail = path_s.split("/", 1)[1]
        if tail in ("time_head", "score_head", "sync_head"):
            return "base"
        if stage in ("pretrain", "lora"):
            # stage 1 freezes the backbone; the LoRA stage freezes the base
            # weights and trains only the adapters
            return "frozen"
        return "base"
    return "base"


def param_labels(params: dict, stage: str) -> dict:
    return _map_with_path(lambda path, _: param_group(path, stage), params)


def _no_weight_decay(path_s: str) -> bool:
    """Norm scales and biases are excluded from decay."""
    name = path_s.rsplit("/", 1)[-1]
    if "norm" in name:
        return True
    return name in (
        "bias", "ln_scale", "ln_bias", "class_embedding",
        "bq", "bk", "bv", "bo", "b1", "b2",
    )


def decay_mask(params: dict) -> dict:
    return _map_with_path(lambda path, _: not _no_weight_decay(path), params)


# ---------------------------------------------------------------------------
# Optimizer / schedule
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainRecipe:
    stage: str = "sft"                 # 'pretrain' | 'sft' | 'lora'
    learning_rate: float = 5e-6
    projector_lr: Optional[float] = None  # separate connector group
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    total_steps: int = 1000
    max_grad_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    grad_accum_steps: int = 1

    @classmethod
    def stage1(cls, total_steps: int) -> "TrainRecipe":
        return cls(stage="pretrain", learning_rate=1e-3, total_steps=total_steps)

    @classmethod
    def stage2(cls, total_steps: int) -> "TrainRecipe":
        return cls(stage="sft", learning_rate=5e-6, total_steps=total_steps)


def cosine_schedule(recipe: TrainRecipe, lr: float) -> Callable[[int], float]:
    """count (updates done so far, from 0) -> learning rate: linear from 0 to
    ``lr`` over ``max(1, int(warmup_ratio * total_steps))`` updates, then a
    cosine to 0 at ``total_steps``."""
    warmup = max(1, int(recipe.warmup_ratio * recipe.total_steps))
    decay = recipe.total_steps - warmup
    if decay <= 0:
        raise ValueError(
            f"total_steps={recipe.total_steps} leaves no step after {warmup} of warmup")

    def schedule(count: int) -> float:
        if count < warmup:
            return lr * count / warmup
        frac = min(count - warmup, decay) / decay
        return lr * 0.5 * (1.0 + math.cos(math.pi * frac))

    return schedule


# leaves above this many elements are updated a leading slice at a time, so
# the fp32 temporaries of the update stay small beside a stacked 7B leaf
_UPDATE_SLICE_NUMEL = 1 << 27


def global_sq(pairs, device, sharded=frozenset(), group=None) -> torch.Tensor:
    """The squared global norm of (path, tensor) pairs whose ``sharded``
    paths hold a rank's slice over ``group`` (their squares add up over it)
    while the others are whole on every rank: an fp32 scalar on ``device``.
    Every rank of the group calls it (it all-reduces even with nothing
    sharded)."""
    def sq(ts):
        return (torch.stack([t.float().square().sum() for t in ts]).sum() if ts
                else torch.zeros((), dtype=torch.float32, device=device))

    total = sq([g for p, g in pairs if p not in sharded])
    if group is not None:
        total = total + all_reduce(sq([g for p, g in pairs if p in sharded]), group)
    return total


class Optimizer:
    """AdamW over the 'base' and 'projector' leaves of a params tree, each
    label clipped by its own global norm and on its own learning rate; frozen
    leaves are never touched. ``init`` makes the state, ``update`` applies one
    gradient tree to the parameters in place. ``sharded`` / ``group``: the
    paths of the leaves a rank holds a slice of and the group over which
    their squares add up (``runtime/mesh.py sharded_paths``, the 'model'
    group)."""

    def __init__(self, params: dict, recipe: TrainRecipe, *, sharded=frozenset(),
                 group=None):
        self.recipe = recipe
        self.sharded, self.group = frozenset(sharded), group
        self.labels = dict(tree_paths(param_labels(params, recipe.stage)))
        self.decay = dict(tree_paths(decay_mask(params)))
        self.schedules = {
            "base": cosine_schedule(recipe, recipe.learning_rate),
            "projector": cosine_schedule(
                recipe, recipe.projector_lr or recipe.learning_rate),
        }

    def trainable(self, params: dict):
        """(path, leaf) of every leaf the optimizer updates."""
        return [(p, x) for p, x in tree_paths(params) if self.labels[p] != "frozen"]

    def init(self, params: dict) -> dict:
        state = {"count": 0,
                 "mu": {p: torch.zeros_like(x) for p, x in self.trainable(params)},
                 "nu": {p: torch.zeros_like(x) for p, x in self.trainable(params)}}
        if self.recipe.grad_accum_steps > 1:
            state["mini_step"] = 0
            state["acc"] = {p: torch.zeros_like(x) for p, x in self.trainable(params)}
        return state

    def learning_rates(self, state: dict) -> dict:
        """The rates the next update will use."""
        return {label: fn(state["count"]) for label, fn in self.schedules.items()}

    @torch.no_grad()
    def update(self, params: dict, state: dict, grads: dict) -> None:
        """One call of the optimizer with ``grads`` ({path: tensor} of the
        trainable leaves). With ``grad_accum_steps = k`` the first k - 1
        calls only add into the running mean."""
        r = self.recipe
        leaves = self.trainable(params)
        if r.grad_accum_steps > 1:
            state["mini_step"] += 1
            n = state["mini_step"]
            for p, _ in leaves:
                acc = state["acc"][p]
                acc.add_((grads[p].to(acc.dtype) - acc) / n)  # running mean
            if n < r.grad_accum_steps:
                return
            grads = state["acc"]

        scale = {}
        for label in ("base", "projector"):
            pairs = [(p, grads[p]) for p, _ in leaves if self.labels[p] == label]
            device = leaves[0][1].device if leaves else "cpu"
            norm = global_sq(pairs, device, self.sharded, self.group).sqrt().item()
            scale[label] = 1.0 if norm < r.max_grad_norm else r.max_grad_norm / norm
        lrs = self.learning_rates(state)
        state["count"] += 1
        t = state["count"]
        c1, c2 = 1.0 - r.b1 ** t, 1.0 - r.b2 ** t
        for p, x in leaves:
            label = self.labels[p]
            wd = r.weight_decay if self.decay[p] else 0.0
            parts = (x, grads[p], state["mu"][p], state["nu"][p])
            if x.numel() > _UPDATE_SLICE_NUMEL and x.ndim > 1:
                parts = zip(*parts)  # a leading slice at a time
            else:
                parts = (parts,)
            for x_, g_, m_, v_ in parts:
                g = g_.float() * scale[label]
                m = m_.float().mul_(r.b1).add_(g, alpha=1.0 - r.b1)
                v = v_.float().mul_(r.b2).addcmul_(g, g, value=1.0 - r.b2)
                m_.copy_(m)
                v_.copy_(v)
                u = (m / c1) / ((v / c2).sqrt_() + r.eps)
                if wd:
                    u.add_(x_.float(), alpha=wd)
                x_.copy_(x_.float().add_(u, alpha=-lrs[label]))
        if r.grad_accum_steps > 1:
            state["mini_step"] = 0
            for acc in state["acc"].values():
                acc.zero_()


def build_optimizer(params: dict, recipe: TrainRecipe, *, sharded=frozenset(),
                    group=None) -> Optimizer:
    return Optimizer(params, recipe, sharded=sharded, group=group)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def preprocess_batch_frames(frames_u8: torch.Tensor, config: TraceConfig) -> torch.Tensor:
    """uint8 [B,T,H,W,3] -> normalized [B,T,S,S,3] on the frames' device, in
    the model's dtype."""
    return torch.stack([
        preprocess_frames(f, config.vision.image_size,
                          aspect_ratio=config.image_aspect_ratio)
        for f in frames_u8]).to(config.dtype)


def _batch_to_device(batch: dict, device: torch.device) -> dict:
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):  # torch wants a writable, contiguous array
            v = torch.from_numpy(np.ascontiguousarray(v) if v.flags.writeable else v.copy())
        t = v
        out[k] = t.to(device) if torch.is_tensor(t) else t
    return out


def make_train_step(
    config: TraceConfig,
    tx: Optimizer,
    *,
    remat: bool = True,
    freeze_stage: Optional[str] = None,
    mesh=None,
    pp_mesh=None,
    pp_microbatches: int = 1,
):
    """Returns ``(params, opt_state, batch) -> (params, opt_state, metrics)``.
    The trees are updated in place and handed back; ``batch`` holds numpy
    arrays or tensors and is moved to the parameters' device.

    ``freeze_stage`` applies the stage's freeze policy (``param_group``) as
    ``requires_grad_(False)``: without it every leaf outside the vision tower
    takes a gradient (and ``metrics["grad_norm"]`` counts it) although the
    optimizer moves none of the frozen ones. ``metrics["grad_norm"]`` is the
    norm of all gradients of this call before clipping.

    ``mesh``: the params are a rank's shards (``shard_params``; ``tx`` built
    with the sharded paths and the 'model' group) and ``batch`` its 'data'
    rows with all their frames; the gradients add up over 'data'.
    ``pp_mesh``: the decoder is pipelined over its stages in
    ``pp_microbatches`` microbatches; the layer gradients add up over
    'stage'."""
    data = mesh.group("data") if mesh is not None else None
    stage = pp_mesh.group("stage") if pp_mesh is not None else None

    def train_step(params, opt_state, batch):
        leaves = list(tree_paths(params))
        device = leaves[0][1].device
        for path, x in leaves:
            frozen = path.startswith("vision") or (
                freeze_stage is not None and param_group(path, freeze_stage) == "frozen")
            x.requires_grad_(not frozen)
            x.grad = None
        batch = _batch_to_device(batch, device)
        if "frames" not in batch:
            batch["frames"] = preprocess_batch_frames(batch.pop("frames_u8"), config)

        loss, metrics = forward_train(params, config, batch, remat=remat, mesh=mesh,
                                      pp_mesh=pp_mesh, pp_microbatches=pp_microbatches)
        loss.backward()

        grads, every = {}, []
        for path, x in leaves:
            if not x.requires_grad:
                continue
            g = x.grad if x.grad is not None else torch.zeros_like(x)
            if data is not None:
                g = all_reduce(g, data)
            if stage is not None and path.startswith("decoder/layers/"):
                g = all_reduce(g, stage)
            every.append((path, g))
            if tx.labels[path] != "frozen":
                grads[path] = g
            x.grad = None
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_sq(every, device, getattr(tx, "sharded", frozenset()),
                                         getattr(tx, "group", None)).sqrt()
        tx.update(params, opt_state, grads)
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# High-level loop (host side)
# ---------------------------------------------------------------------------

def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device) if torch.is_tensor(tree) else tree


def train_loop(
    params: dict,
    config: TraceConfig,
    dataset,
    recipe: TrainRecipe,
    *,
    batch_size: int = 2,
    mesh=None,
    log_every: int = 1,
    checkpoint_dir: Optional[str] = None,
    save_every: int = 2000,
    resume: bool = True,
    metrics_path: Optional[str] = None,
    pp_mesh=None,
    pp_microbatches: int = 1,
    device=None,
):
    """Minimal epoch loop with modality-grouped order, checkpoints and
    auto-resume, on ``device`` (default: the CUDA card, which must exist;
    pass ``device="cpu"`` to run on the CPU). Returns (params, opt_state,
    metrics of the last step); the params are the caller's tensors when they
    already lie on the device, updated in place.

    More than one process (``runtime/distributed.py initialize`` first):
    ``batch_size`` stays the GLOBAL batch. With ``mesh`` (``build_mesh``,
    on its device) the params are sharded before the optimizer is built, so
    the moments are sharded like them; each rank loads its 'data' share of
    every global batch (``process_order_shard``), and a step equals the
    step on the global batch. With ``pp_mesh`` every rank loads the whole
    batch and runs its stages. Each rank writes its own checkpoint file and
    resumes from it on the same mesh; only the primary logs."""
    from trace_tpu_torch.runtime.distributed import (
        host_local_to_global,
        is_primary,
        process_count,
        process_index,
        process_order_shard,
    )
    from trace_tpu_torch.runtime.mesh import Mesh, shard_params, sharded_paths

    for name, m in (("mesh", mesh), ("pp_mesh", pp_mesh)):
        if m is not None and not isinstance(m, Mesh):
            raise TypeError(f"{name} must be a runtime.mesh.Mesh, got {type(m).__name__}")
    if mesh is not None and pp_mesh is not None:
        raise ValueError("a mesh and a pipeline mesh together are not supported")
    if pp_mesh is not None and "stage" not in pp_mesh.shape:
        raise ValueError("pp_mesh needs a 'stage' axis (parallel.pipeline.build_pp_mesh)")
    placed = mesh or pp_mesh
    if placed is not None:
        device = placed.device
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "train_loop: no CUDA device; pass device='cpu' explicitly to run on the CPU")
    n_proc = process_count()
    if n_proc > 1 and placed is None:
        raise ValueError("multi-process training requires a mesh")

    from trace_tpu_torch.data.loader import PrefetchLoader
    from trace_tpu_torch.data.sampler import modality_grouped_indices

    sharded, group = frozenset(), None
    if mesh is not None:
        sharded, group = sharded_paths(params, mesh), mesh.group("model")
        params = shard_params(params, mesh)
    else:
        params = _to_device(params, device)
    tx = build_optimizer(params, recipe, sharded=sharded, group=group)
    opt_state = tx.init(params)
    step_fn = make_train_step(config, tx, freeze_stage=recipe.stage, mesh=mesh,
                              pp_mesh=pp_mesh, pp_microbatches=pp_microbatches)

    start_step = 0
    ckpt = None
    if checkpoint_dir:
        from trace_tpu_torch.checkpoint.io import CheckpointManager

        ckpt = CheckpointManager(
            checkpoint_dir, shard=(process_index(), n_proc) if n_proc > 1 else None)
        if resume:
            restored = ckpt.restore_latest(params, opt_state)
            if restored is not None:
                params, opt_state, start_step = restored

    lengths = dataset.modality_lengths() if hasattr(dataset, "modality_lengths") else None
    order = modality_grouped_indices(
        lengths, batch_size, seed=recipe.total_steps
    ) if lengths else list(range(len(dataset)))
    local_bs = batch_size
    if mesh is not None and mesh.shape["data"] > 1:
        local_bs = batch_size // mesh.shape["data"]
        order = process_order_shard(order, batch_size, index=mesh.coord("data"),
                                    count=mesh.shape["data"])

    mlog = None
    if metrics_path and is_primary():
        from trace_tpu_torch.utils.profiling import MetricsLogger

        mlog = MetricsLogger(metrics_path)

    loader = PrefetchLoader(
        dataset, local_bs, order=order[start_step * local_bs:],
        num_workers=4, prefetch_batches=2,
    )

    step = start_step
    metrics = {}
    try:
        for batch in loader:
            if mesh is not None:
                batch = host_local_to_global(batch, mesh)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            step += 1
            if log_every and step % log_every == 0 and is_primary():
                m = {k: float(v) for k, v in metrics.items()}
                print(f"step {step}: " + " ".join(f"{k}={v:.4f}" for k, v in m.items()),
                      flush=True)
                if mlog:
                    mlog.log(step, m)
            if ckpt and step % save_every == 0:
                ckpt.save(step, params, opt_state)
            if step >= recipe.total_steps:
                break
    finally:
        if mlog:
            mlog.close()

    if ckpt:
        ckpt.save(step, params, opt_state)
    return params, opt_state, metrics
