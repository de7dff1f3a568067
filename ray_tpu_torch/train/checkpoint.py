"""Checkpoints: directory handles + ``torch.save`` state (the port's copy
of ``ray_tpu/train/checkpoint.py``).

Equivalent of the reference's Checkpoint abstraction
(reference: python/ray/train/_checkpoint.py:55 — a directory/URI handle,
from_directory:158/to_directory:169; CheckpointManager top-k retention in
train/_internal/checkpoint_manager.py). The state is what the reference's
torch path saves: a dict of state dicts of tensors (model, optimizer),
written with ``torch.save`` where the JAX package writes Orbax, into
``<checkpoint>/state.pt`` through a temporary file, so a process killed
mid-write leaves no half a checkpoint under the name.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

_STATE = "state.pt"


class Checkpoint:
    """Handle to an on-disk checkpoint directory."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def to_directory(self, dest: str) -> str:
        if os.path.abspath(dest) != self.path:
            shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    def as_directory(self) -> str:
        return self.path

    # ---- torch state ----

    @classmethod
    def from_state(cls, path: str, state: Any, *, force: bool = True) -> "Checkpoint":
        """Save ``state`` (e.g. ``{"model": model.state_dict(), "optimizer":
        opt.state_dict()}``) with ``torch.save``; a CUDA tensor is written
        with its device, as ``torch.save`` does."""
        import torch

        path = os.path.abspath(path)
        target = os.path.join(path, _STATE)
        if not force and os.path.exists(target):
            raise FileExistsError(target)
        os.makedirs(path, exist_ok=True)
        tmp = target + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, target)
        return cls(path)

    def load_state(self, map_location: Any = None) -> Any:
        """Read the state back; ``map_location`` as ``torch.load`` takes it
        (None: each tensor onto the device it was saved from, "cpu": host
        memory, so a checkpoint written on a card reads on a CPU host)."""
        import torch

        return torch.load(os.path.join(self.path, _STATE),
                          map_location=map_location, weights_only=True)

    def write_metadata(self, meta: dict) -> None:
        with open(os.path.join(self.path, "metadata.json"), "w") as f:
            json.dump(meta, f)

    def read_metadata(self) -> dict:
        p = os.path.join(self.path, "metadata.json")
        if not os.path.exists(p):
            return {}
        with open(p) as f:
            return json.load(f)

    def __repr__(self):
        return f"Checkpoint({self.path})"


class CheckpointManager:
    """Top-k retention scored by a metric (reference:
    train/_internal/checkpoint_manager.py; CheckpointConfig air/config.py:574)."""

    def __init__(self, *, num_to_keep: Optional[int] = None,
                 score_attribute: Optional[str] = None, score_order: str = "max"):
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        self._entries: list[tuple[float, str]] = []  # (score, path)

    def register(self, checkpoint_path: str, metrics: dict) -> None:
        if self.score_attribute and self.score_attribute in metrics:
            score = float(metrics[self.score_attribute])
        else:
            score = float(len(self._entries))  # fallback: recency
        self._entries.append((score, checkpoint_path))
        if self.num_to_keep is None or len(self._entries) <= self.num_to_keep:
            return
        reverse = self.score_order == "max"
        self._entries.sort(key=lambda e: e[0], reverse=reverse)
        while len(self._entries) > self.num_to_keep:
            _, victim = self._entries.pop()
            shutil.rmtree(victim, ignore_errors=True)

    def best(self) -> Optional[str]:
        if not self._entries:
            return None
        reverse = self.score_order == "max"
        return sorted(self._entries, key=lambda e: e[0], reverse=reverse)[0][1]

    def latest(self) -> Optional[str]:
        return self._entries[-1][1] if self._entries else None
