"""The multi-process runtime (trace_tpu/runtime/distributed.py on
``torch.distributed``).

Every process calls :func:`initialize` once; it joins the default process
group through a TCP rendezvous at the coordinator's address. A rank owns one
device: ``local_device`` picks it (the CUDA card of the rank's local index,
or the CPU when asked). Meshes (``runtime/mesh.py``) and pipeline meshes
(``parallel/pipeline.py``) then build their groups inside that world.

* :func:`initialize`: explicit arguments win; otherwise the torchrun-style
  variables ``COORDINATOR_ADDRESS`` (or ``MASTER_ADDR`` + ``MASTER_PORT``),
  ``NUM_PROCESSES`` (or ``WORLD_SIZE``) and ``PROCESS_ID`` (or ``RANK``);
  with none of them, or one process, it does nothing. The JAX package's
  Cloud-TPU pod autodetection has no counterpart: every multi-process
  launch names its coordinator, world size and rank.
* :func:`is_primary`: rank 0 gates logs and artifacts.
* :func:`process_order_shard`: each rank's slice of a global sample order,
  so that the union over ranks of step s is exactly the global batch s.
* :func:`host_local_to_global`: the rank's local batch on its device.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    *,
    backend: Optional[str] = None,
) -> None:
    """Join the multi-process runtime; a no-op for one process.

    ``coordinator_address`` is ``host:port`` of rank 0's rendezvous.
    ``backend=None`` picks ``"nccl"`` when the rank owns a CUDA device and
    ``"gloo"`` on the CPU; several ranks that share one card need
    ``"gloo"`` (NCCL refuses two ranks on one device). ``local_device_ids``
    (the JAX argument) names the CUDA device of this process: its first
    entry becomes the current device."""
    env = os.environ
    coordinator_address = coordinator_address or env.get("COORDINATOR_ADDRESS") or (
        f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        if env.get("MASTER_ADDR") and env.get("MASTER_PORT") else None
    )
    if num_processes is None:
        v = env.get("NUM_PROCESSES") or env.get("WORLD_SIZE")
        num_processes = int(v) if v else None
    if process_id is None:
        v = env.get("PROCESS_ID") or env.get("RANK")
        process_id = int(v) if v else None

    if coordinator_address is None and num_processes is None:
        return  # single process: no-op
    if num_processes is not None and num_processes <= 1:
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process launch needs the coordinator address, the number of "
            f"processes and this process's id; got {coordinator_address!r}, "
            f"{num_processes!r}, {process_id!r}")
    if local_device_ids:
        torch.cuda.set_device(int(local_device_ids[0]))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def _world() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _world() else 0


def process_count() -> int:
    return dist.get_world_size() if _world() else 1


def is_primary() -> bool:
    """True on exactly one process: gate checkpoint, log and artifact writes."""
    return process_index() == 0


def local_device(device=None) -> torch.device:
    """The device of this rank: ``device`` when given (``"cpu"`` for the CPU),
    else the CUDA card of its local index (``LOCAL_RANK``, else the rank,
    modulo the cards present), which must exist."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for this rank; pass device='cpu' explicitly")
    local = int(os.environ.get("LOCAL_RANK", process_index()))
    return torch.device("cuda", local % torch.cuda.device_count())


def local_batch_size(global_batch_size: int) -> int:
    n = process_count()
    if global_batch_size % n:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by {n} processes")
    return global_batch_size // n


def process_order_shard(
    order: Sequence[int], global_batch_size: int,
    *, index: Optional[int] = None, count: Optional[int] = None,
) -> list[int]:
    """This process's sample indices: the p-th sub-chunk of every global
    batch, so step s's union over processes is order[s*B:(s+1)*B] exactly
    (modality-grouped batches stay whole across the fleet). ``index`` /
    ``count`` default to the rank and the world size; a mesh passes its
    'data' coordinate and size, since the ranks of one 'model' group read
    the same samples."""
    p = process_index() if index is None else index
    n = process_count() if count is None else count
    if n == 1:
        return list(order)
    b_local = local_batch_size(global_batch_size) if count is None else (
        global_batch_size // n
    )
    out: list[int] = []
    for s in range(len(order) // global_batch_size):
        chunk = order[s * global_batch_size: (s + 1) * global_batch_size]
        out.extend(chunk[p * b_local: (p + 1) * b_local])
    return out


def host_local_to_global(batch: dict, mesh, shardings: Optional[dict] = None) -> dict:
    """The rank's local batch (leading dim = its 'data' share) on the mesh's
    device. A rank computes on its own shard and the collectives of the
    model combine the shards, so no global array is assembled: where the
    JAX package builds one ``jax.Array`` over every process's rows, each
    rank here keeps its rows. ``shardings`` is accepted for the JAX
    signature and not read."""
    out = {}
    for k, v in batch.items():
        if not torch.is_tensor(v):
            v = torch.as_tensor(v)
        out[k] = v.to(mesh.device)
    return out
