"""The device mesh and its sharding rules (trace_tpu/runtime/mesh.py on
``torch.distributed``).

A ``Mesh`` lays the ranks of the world, one device each, on a grid with
named axes, ``('data', 'model')`` for ``build_mesh``: rank = data index x
model size + model index, as the JAX package reshapes its device list. Each
rank holds one process group per axis (the ranks that differ from it only
along that axis) and its coordinate along each.

The sharding rules are a copy of the JAX package's, name-matched over the
params tree: ``param_spec`` gives for every leaf the tuple of mesh axis
names (or None) per dimension that JAX's ``PartitionSpec`` holds, with the
same matching (the first rule whose key is a suffix or a substring of the
path and whose length equals the leaf's ndim; an axis whose dimension the
mesh axis does not divide becomes None). Placing a tree (``shard_params``,
``shard_params_for_inference``) leaves each rank its slice of every sharded
leaf: a rank computes on its shards, and the model's collectives
(``parallel/collectives.py``) combine them where GSPMD would.

Two placements differ from the JAX package's by design:

* the vision tower and the connector stay replicated under a training mesh
  too (``shard_params``), and the ViT runs frame-parallel over 'model' as
  in serving; the JAX rules TP-shard them. The loss and the gradients are
  the same;
* a fused serving tree (``wqkv`` / ``w_gateup``) is split into its
  canonical leaves before it is placed, by ``shard_params`` as by
  ``shard_params_for_inference``; the JAX rules would shard the fused
  output dim across the q|k|v boundaries;
* a per-channel nibble-packed layer leaf (the native int4 tree of
  ``int4_serving``) is unpacked to its int4 values, one an int8, placed by
  the rules of an int8 leaf (the JAX package places its ``jnp.int4``
  leaves so), and packed again on each rank from its own shard: a byte
  pairs rows k and k + K / 2 of the weight it holds, so a row-parallel
  shard (``wo``, ``w_down``) is packed within its local K, never cut out of
  a globally packed array. Group-scaled packed leaves (int4p) are placed
  as they are; ``generate_sharded`` refuses them.
"""

from __future__ import annotations

import itertools
import math
from typing import Optional

import torch

from trace_tpu_torch.runtime.distributed import local_device, process_count, process_index


class Mesh:
    """Ranks on a grid with named axes. ``shape`` maps each axis name to its
    size (JAX's ``Mesh.shape``); ``coords`` this rank's index along each;
    ``groups`` its process group along each (None for an axis of size 1, or
    a mesh made only to read specs, ``Mesh(names, sizes)`` with no world)."""

    def __init__(self, axis_names: tuple, sizes: tuple, *, coords: Optional[dict] = None,
                 groups: Optional[dict] = None, ranks: Optional[dict] = None, device=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.coords = coords or {name: 0 for name in self.axis_names}
        self.groups = groups or {name: None for name in self.axis_names}
        # the global ranks of this rank's group along each axis, in axis order
        self.ranks = ranks or {name: [0] for name in self.axis_names}
        self.device = torch.device("cpu") if device is None else torch.device(device)
        # a pipeline mesh's two-rank groups of neighbouring stages: first stage
        # -> (group, [its rank, the next stage's rank]), for this rank's pairs
        self.hops = {}

    def group(self, name: str):
        return self.groups.get(name)

    def coord(self, name: str) -> int:
        return self.coords.get(name, 0)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, coords={self.coords}, device={self.device})"


def grid_mesh(axis_names: tuple, sizes: tuple, *, device=None) -> Mesh:
    """A mesh over the whole world (one rank per device), row-major over
    ``sizes``. Every rank calls it with the same arguments: the groups are
    made collectively, in one order."""
    import torch.distributed as dist

    n, world = math.prod(sizes), process_count()
    if n != world:
        raise ValueError(
            f"a mesh of {dict(zip(axis_names, sizes))} needs {n} ranks; the world has "
            f"{world} (one device a rank: call runtime.distributed.initialize first)")
    rank = process_index()
    strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
    coords = {name: rank // strides[i] % sizes[i] for i, name in enumerate(axis_names)}
    groups = {name: None for name in axis_names}
    ranks_of = {name: [rank] for name in axis_names}
    for a, name in enumerate(axis_names):
        if sizes[a] == 1 or world == 1:
            continue
        others = [i for i in range(len(sizes)) if i != a]
        for fixed in itertools.product(*(range(sizes[i]) for i in others)):
            base = sum(c * strides[i] for c, i in zip(fixed, others))
            ranks = [base + k * strides[a] for k in range(sizes[a])]
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[name], ranks_of[name] = g, ranks
    return Mesh(axis_names, sizes, coords=coords, groups=groups, ranks=ranks_of,
                device=local_device(device))


def build_mesh(n_devices: Optional[int] = None, model_axis: Optional[int] = None,
               *, device=None) -> Mesh:
    """2-D ``('data', 'model')`` mesh over the world's n ranks.

    ``model_axis`` defaults to min(4, n), lowered until it divides n, as in
    the JAX package: tensor-parallel groups of up to 4, everything else
    data-parallel. ``device`` is the rank's device (default: its CUDA card;
    ``"cpu"`` for the CPU)."""
    return grid_mesh(("data", "model"), mesh_sizes(n_devices or process_count(), model_axis),
                     device=device)


def mesh_sizes(n: int, model_axis: Optional[int] = None) -> tuple:
    """(data, model) of ``build_mesh`` over n ranks."""
    if model_axis is None:
        model_axis = min(4, n)
    while n % model_axis:
        model_axis -= 1
    return n // model_axis, model_axis


# Name-matched rules for decoder / vision / connector params, JAX's in the
# same order: the first key that is a suffix or a substring of the param
# path, with as many entries as the leaf has dimensions, wins.
_PARAM_RULES: tuple = (
    # decoder
    ("decoder/embed", ("model", None)),
    ("decoder/layers/wq", (None, None, "model", None)),
    ("decoder/layers/wk", (None, None, "model", None)),
    ("decoder/layers/wv", (None, None, "model", None)),
    ("decoder/layers/wo", (None, "model", None, None)),
    # flattened [L, K, N] forms (quantized leaves after an unfuse round-trip)
    ("decoder/layers/wq", (None, None, "model")),
    ("decoder/layers/wk", (None, None, "model")),
    ("decoder/layers/wv", (None, None, "model")),
    ("decoder/layers/wo", (None, "model", None)),
    ("decoder/layers/w_gate", (None, None, "model")),
    ("decoder/layers/w_up", (None, None, "model")),
    ("decoder/layers/w_down", (None, "model", None)),
    # fused serving leaves: the port splits them before placing (see above)
    ("decoder/layers/wqkv", (None, None, "model")),
    ("decoder/layers/w_gateup", (None, None, "model")),
    ("decoder/lm_head", (None, "model")),
    ("decoder/time_head", (None, None)),
    ("decoder/score_head", (None, None)),
    ("decoder/sync_head", (None, None)),
    # vision (attention fused [L, D, D]: shard output dim)
    ("vision/patch_embed", (None, "model")),
    ("vision/position_embedding", (None, None)),
    ("vision/layers/wq", (None, None, "model")),
    ("vision/layers/wk", (None, None, "model")),
    ("vision/layers/wv", (None, None, "model")),
    ("vision/layers/wo", (None, "model", None)),
    ("vision/layers/fc1", (None, None, "model")),
    ("vision/layers/fc2", (None, "model", None)),
    ("vision/layers/bq", (None, "model")),
    ("vision/layers/bk", (None, "model")),
    ("vision/layers/bv", (None, "model")),
    ("vision/layers/b1", (None, "model")),
    # connector
    ("connector/readout", (None, "model")),
)


def _path_str(path) -> str:
    if isinstance(path, str):
        return path
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def param_spec(path, leaf, mesh: Optional[Mesh] = None) -> tuple:
    """The mesh axis (or None) of each dimension of ``leaf`` at ``path`` (a
    '/'-joined string or a sequence of keys); () replicates."""
    return _spec_for(_path_str(path), leaf, mesh)


def _spec_for(s: str, leaf, mesh: Optional[Mesh] = None) -> tuple:
    for key, spec in _PARAM_RULES:
        if s.endswith(key) or key in s:
            if len(spec) != getattr(leaf, "ndim", 0):
                continue
            if mesh is None:
                return spec
            # an axis whose dim the mesh axis does not divide replicates
            # (tiny test models replicate where the 7B shards)
            return tuple(
                name if name is not None and leaf.shape[i] % mesh.shape[name] == 0
                else None
                for i, name in enumerate(spec))
    return ()  # replicate


def _leaves(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list)):
            yield from _leaves(v, path)
        else:
            yield path, v


def _map(fn, tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        path = f"{prefix}/{k}" if prefix else str(k)
        out[k] = _map(fn, v, path) if isinstance(v, (dict, list)) else fn(path, v)
    return out if isinstance(tree, dict) else list(out.values())


def param_shardings(params: dict, mesh: Mesh):
    """``param_spec`` of every leaf, as a tree of the params' structure."""
    return _map(lambda path, leaf: param_spec(path, leaf, mesh), params)


def _local(leaf: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``leaf`` under ``spec``, on the mesh's device."""
    out = leaf
    for dim, name in enumerate(spec):
        if name is None or mesh.shape[name] == 1:
            continue
        n = out.shape[dim] // mesh.shape[name]
        out = out.narrow(dim, mesh.coord(name) * n, n)
    return out.to(mesh.device).contiguous()


def _unfused(params: dict) -> dict:
    from trace_tpu_torch.model.quantize import unfuse_decoder_serving

    if "decoder" in params:
        if "wqkv" in params["decoder"].get("layers", {}):
            params = dict(params)
            params["decoder"] = unfuse_decoder_serving(params["decoder"])
    elif "wqkv" in params.get("layers", {}):
        params = unfuse_decoder_serving(params)
    return params


def _channel_int4(params: dict) -> tuple:
    """(tree, names): the per-channel packed decoder layer leaves of an
    unfused ``params`` (the whole tree or the decoder) as ``{"q": [L, K, N]
    int4 values in int8, "s"}``, and their names, to pack again once placed
    (``_repack_int4``)."""
    from trace_tpu_torch.model.quantize import is_packed4, packed4_groups, unpack4

    dec = params.get("decoder", params)
    layers = dec.get("layers", {})
    names = [n for n, leaf in layers.items() if is_packed4(leaf) and packed4_groups(leaf) == 1]
    if not names:
        return params, ()
    layers = dict(layers)
    for n in names:
        layers[n] = {"q": unpack4(layers[n]["qp"]), "s": layers[n]["s"]}
    dec = {**dec, "layers": layers}
    return ({**params, "decoder": dec} if "decoder" in params else dec), tuple(names)


def _repack_int4(params: dict, names: tuple) -> dict:
    """``_channel_int4``'s leaves, placed, packed again on this rank."""
    from trace_tpu_torch.model.quantize import pack4

    if not names:
        return params
    dec = params.get("decoder", params)
    layers = dict(dec["layers"])
    for n in names:
        layers[n] = {"qp": pack4(layers[n]["q"]), "s": layers[n]["s"]}
    dec = {**dec, "layers": layers}
    return {**params, "decoder": dec} if "decoder" in params else dec


def _place(params: dict, mesh: Mesh, spec_of) -> dict:
    def place(path, leaf):
        if not torch.is_tensor(leaf):
            return leaf
        spec = spec_of(path, leaf)
        with torch.no_grad():
            return _local(leaf.detach(), spec, mesh) if spec else leaf.detach().to(mesh.device)

    return _map(place, params)


def shard_params(params: dict, mesh: Mesh) -> dict:
    """A training tree on the mesh: each rank keeps its slice of every
    decoder leaf the rules shard; the vision tower, the connector and the
    towers stay whole on every rank (see the module's note)."""
    params, packed = _channel_int4(_unfused(params))
    return _repack_int4(_place(params, mesh, lambda path, leaf: (
        param_spec(path, leaf, mesh) if path.startswith("decoder") else ())), packed)


def inference_param_shardings(params: dict, mesh: Mesh):
    """Serving placement specs: the decoder TP over 'model', everything else
    (vision, connector, towers: encode-only, small) replicated. Accepts the
    full params tree or the decoder subtree."""
    is_subtree = isinstance(params, dict) and "decoder" not in params

    def spec(path, leaf):
        s = "decoder/" + path if is_subtree else path
        return _spec_for(s, leaf, mesh) if s.startswith("decoder") else ()

    return _map(spec, params)


def shard_params_for_inference(params: dict, mesh: Mesh) -> dict:
    """Serving params on the mesh (decoder TP). A fused serving tree (wqkv /
    w_gateup) is split back to canonical leaves first, as in the JAX
    package: the fused single-device layout and the TP layout exclude each
    other (``model/quantize.py unfuse_decoder_serving``). Per-channel packed
    int4 leaves are placed as their int4 values and packed again on each
    rank (see the module's note)."""
    params, packed = _channel_int4(_unfused(params))
    specs = dict(_leaves(inference_param_shardings(params, mesh)))
    return _repack_int4(_place(params, mesh, lambda path, leaf: specs[path]), packed)


_BATCH_RULES: dict = {
    # frames: batch over data, FRAME axis over model (frame-parallel ViT)
    "frames": ("data", "model"),
    "frame_time_ids": ("data", "model"),
}


def batch_shardings(mesh: Mesh, batch: dict) -> dict:
    """Per-key specs for a batch dict (default: batch axis over 'data')."""
    return {k: _BATCH_RULES.get(k, ("data",)) for k in batch}


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's share of a global batch on its device: rows over 'data',
    the frame axis of frames / frame_time_ids over 'model' too."""
    specs = batch_shardings(mesh, batch)
    out = {}
    for k, v in batch.items():
        t = v if torch.is_tensor(v) else torch.as_tensor(v)
        for dim, name in enumerate(specs[k]):
            if name is None or mesh.shape[name] == 1:
                continue
            if t.shape[dim] % mesh.shape[name]:
                raise ValueError(f"batch[{k!r}] dim {dim} ({t.shape[dim]}) does not "
                                 f"divide over {name!r} ({mesh.shape[name]})")
            n = t.shape[dim] // mesh.shape[name]
            t = t.narrow(dim, mesh.coord(name) * n, n)
        out[k] = t.to(mesh.device)
    return out


def sharded_paths(params: dict, mesh: Mesh) -> frozenset:
    """The paths of the leaves ``shard_params`` splits over 'model' (read on
    the whole tree): their squared norms add up over the 'model' group,
    those of the other leaves do not."""
    params = _unfused(params)
    return frozenset(
        path for path, leaf in _leaves(params)
        if path.startswith("decoder") and torch.is_tensor(leaf)
        and any(name is not None and mesh.shape[name] > 1
                for name in param_spec(path, leaf, mesh)))
