"""Checkpoint save / restore with auto-resume (trace_tpu/checkpoint/io.py,
``torch.save`` in place of orbax).

One file per step, ``<dir>/checkpoint-<step>/state.pt``, holding the params
tree, the optimizer state and the step; written to a temporary name and
renamed, so a run cut during a save leaves the previous checkpoint whole.
Under more than one process each rank writes its own file,
``state-<rank>-of-<world>.pt``, with its shards, and resumes from it on the
same mesh (orbax writes one global checkpoint for the JAX package).
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Optional, Tuple

import torch

_STEP_DIR = re.compile(r"^checkpoint-(\d+)$")


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, list):  # a connector's layers
        return [_detached(v) for v in tree]
    return tree.detach() if torch.is_tensor(tree) else tree


def _copy_into(like, saved):
    """``saved``'s values in ``like``'s tensors (their device, dtype and
    storage), so views of a restored leaf stay valid."""
    if isinstance(like, dict):
        if set(like) != set(saved):
            raise ValueError(f"checkpoint keys {sorted(saved)} != expected {sorted(like)}")
        return {k: _copy_into(v, saved[k]) for k, v in like.items()}
    if isinstance(like, list):
        if len(like) != len(saved):
            raise ValueError(f"checkpoint holds {len(saved)} layers, expected {len(like)}")
        return [_copy_into(v, s) for v, s in zip(like, saved)]
    if torch.is_tensor(like):
        with torch.no_grad():
            like.copy_(saved)
        return like
    return saved


class CheckpointManager:
    """Step-numbered checkpoints: ``<dir>/checkpoint-<step>/state.pt``; the
    ``max_to_keep`` newest stay."""

    def __init__(self, directory: str, max_to_keep: int = 3, *, shard=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        # (rank, world): this rank's file of a multi-process checkpoint
        self.file = "state.pt" if shard is None else f"state-{shard[0]}-of-{shard[1]}.pt"
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_DIR.match(name)
            if m and os.path.exists(os.path.join(self.directory, name, self.file)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"checkpoint-{step}")

    def save(self, step: int, params, opt_state) -> None:
        os.makedirs(self._path(step), exist_ok=True)
        target = os.path.join(self._path(step), self.file)
        tmp = target + ".tmp"
        torch.save({"step": int(step), "params": _detached(params),
                    "opt_state": _detached(opt_state)}, tmp)
        os.replace(tmp, target)
        if self.max_to_keep:
            for old in self._steps()[:-self.max_to_keep]:
                shutil.rmtree(self._path(old), ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_latest(self, params_like, opt_state_like) -> Optional[Tuple]:
        """Restore the newest checkpoint into the given trees (in place: their
        tensors receive the saved values). Returns (params, opt_state, step)
        or None."""
        step = self.latest_step()
        if step is None:
            return None
        saved = torch.load(os.path.join(self._path(step), self.file),
                           map_location="cpu", weights_only=True)
        params = _copy_into(params_like, saved["params"])
        opt_state = _copy_into(opt_state_like, saved["opt_state"])
        return params, opt_state, int(saved["step"])
