"""Parallelism of the port (trace_tpu/parallel/__init__.py).

* data / tensor / frame-parallel: a ('data', 'model') mesh of ranks and
  the JAX package's sharding rules (runtime/mesh.py, re-exported here); the
  collectives GSPMD inserts there are written out in
  ``parallel/collectives.py`` and called by the model;
* expert parallel: a rank's share of a layer's experts (model/moe.py);
* pipeline parallel: a GPipe microbatch schedule over a 'stage' mesh
  (parallel/pipeline.py).
"""

# Re-exported on first access: the model's modules import
# ``parallel.collectives``, and the mesh and pipeline modules import the
# model, so an eager import here would be circular.
_EXPORTS = {
    "batch_shardings": "trace_tpu_torch.runtime.mesh",
    "build_mesh": "trace_tpu_torch.runtime.mesh",
    "param_shardings": "trace_tpu_torch.runtime.mesh",
    "param_spec": "trace_tpu_torch.runtime.mesh",
    "shard_batch": "trace_tpu_torch.runtime.mesh",
    "shard_params": "trace_tpu_torch.runtime.mesh",
    "build_pp_mesh": "trace_tpu_torch.parallel.pipeline",
    "pp_decoder_forward": "trace_tpu_torch.parallel.pipeline",
    "split_layers_into_stages": "trace_tpu_torch.parallel.pipeline",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(_EXPORTS[name]), name)
