"""Train-layer configs (the port's copy of ``ray_tpu/train/config.py``).

Equivalent of the reference's AIR config surface
(reference: python/ray/air/config.py — ScalingConfig:94, RunConfig:723,
CheckpointConfig:574, FailureConfig:523). ``ScalingConfig`` speaks GPUs
where the JAX package speaks chips: each worker reserves
``gpus_per_worker`` whole cards when ``use_gpu`` (the default: the port's
entry points run on the card unless the caller asks for the CPU with
``use_gpu=False``). A fractional card is refused as ``num_gpus`` is
(``check_whole_gpus``). The JAX package's ``jax_distributed`` and
``slice_aligned`` have no counterpart: the gang always joins one
``torch.distributed`` group, and one host has no ICI domain.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

from ray_tpu_torch._private.task_spec import check_whole_gpus


@dataclass
class ScalingConfig:
    num_workers: int = 1
    use_gpu: bool = True
    gpus_per_worker: int = 1           # whole cards reserved per worker
    cpus_per_worker: float = 1.0
    resources_per_worker: dict[str, float] = field(default_factory=dict)
    placement_strategy: str = "PACK"   # PACK | SPREAD | STRICT_PACK | STRICT_SPREAD

    def __post_init__(self):
        self.worker_resources()

    def worker_resources(self) -> dict[str, float]:
        res = {"CPU": float(self.cpus_per_worker)}
        if self.use_gpu:
            res["GPU"] = float(self.gpus_per_worker)
        res.update(self.resources_per_worker)
        return check_whole_gpus(res)


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None          # None = keep all
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"        # max | min


@dataclass
class FailureConfig:
    max_failures: int = 0  # gang restarts before giving up


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None  # default ~/ray_tpu_torch_results
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    failure_config: FailureConfig = field(default_factory=FailureConfig)

    def resolved_storage_path(self) -> str:
        base = self.storage_path or os.path.expanduser("~/ray_tpu_torch_results")
        name = self.name or "run"
        return os.path.join(base, name)
