"""DataParallelTrainer: gang-scheduled data-parallel training with
report/checkpoint plumbing (the port's counterpart of
``ray_tpu/train/trainer.py``'s ``ray_tpu.train.JaxTrainer``; the port has
no JAX backend, so its base trainer takes the reference's name).

Equivalent of the reference's DataParallelTrainer
(reference: python/ray/train/data_parallel_trainer.py:59, training_loop
:484, the _report polling loop :429-480; BaseTrainer.fit base_trainer.py:608).
The trainer is an actor-gang scheduler + rendezvous + results/checkpoint
pipeline: compute and collectives live in the user's loop.

``fit`` runs attempts until one ends without error or
``FailureConfig.max_failures`` restarts are spent. An attempt fails when a
worker's loop raises, or when a worker dies outright (its actor gone: the
trainer's next poll raises), or when the gang cannot be placed or meet;
each failure tears the whole gang down, and the next attempt starts a new
one. Rank 0's reports drive the results and the checkpoints, kept top-k by
``CheckpointConfig`` across attempts. ``datasets`` (name -> a
``ray_tpu_torch.data`` Dataset or DataIterator) reach each worker as its
shard, through ``get_dataset_shard``; every attempt shards them again.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.worker_group import WorkerGroup


@dataclass
class Result:
    metrics: dict
    checkpoint: Optional[Checkpoint]
    path: str
    error: Optional[str] = None
    metrics_history: list = field(default_factory=list)

    @property
    def best_checkpoints(self):
        return [self.checkpoint] if self.checkpoint else []


class DataParallelTrainer:
    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: dict | None = None,
        scaling_config: ScalingConfig | None = None,
        run_config: RunConfig | None = None,
        datasets: dict | None = None,
    ):
        self.train_loop = train_loop_per_worker
        self.train_loop_config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}

    def fit(self) -> Result:
        storage = self.run_config.resolved_storage_path()
        os.makedirs(storage, exist_ok=True)
        ckpt_cfg = self.run_config.checkpoint_config
        manager = CheckpointManager(
            num_to_keep=ckpt_cfg.num_to_keep,
            score_attribute=ckpt_cfg.checkpoint_score_attribute,
            score_order=ckpt_cfg.checkpoint_score_order,
        )
        failures_left = self.run_config.failure_config.max_failures
        attempt = 0
        while True:
            result = self._run_attempt(storage, manager, attempt)
            if result.error is None or failures_left == 0:
                return result
            failures_left -= 1
            attempt += 1

    def _run_attempt(self, storage: str, manager: CheckpointManager,
                     attempt: int) -> Result:
        group = WorkerGroup(
            self.scaling_config,
            run_name=self.run_config.name or "train",
            storage_path=storage,
        )
        history: list[dict] = []
        latest_metrics: dict = {}
        error: Optional[str] = None
        try:
            group.start(
                experiment_config={
                    "train_loop_config": self.train_loop_config,
                    "attempt": attempt,
                    "datasets": sorted(self.datasets),
                },
                datasets=self.datasets,
            )
            group.run(self.train_loop, self.train_loop_config)
            cursors = [0] * len(group.workers)
            done = [False] * len(group.workers)
            while not all(done):
                polled = group.poll(cursors)
                for i, p in enumerate(polled):
                    for entry in p["reports"]:
                        cursors[i] += 1
                        if i == 0:  # rank-0 reports drive results/checkpoints
                            metrics = entry["metrics"]
                            latest_metrics = metrics
                            history.append(metrics)
                            if "checkpoint_path" in entry:
                                manager.register(entry["checkpoint_path"], metrics)
                    if p["done"]:
                        done[i] = True
                        if p["error"] and error is None:
                            error = f"worker {i} failed:\n{p['error']}"
                if error:
                    break
                time.sleep(0.05)
        except Exception as e:  # gang-level failure (a worker died, PG lost)
            error = f"{type(e).__name__}: {e}"
        finally:
            group.shutdown()

        best = manager.best()
        return Result(
            metrics=latest_metrics,
            checkpoint=Checkpoint(best) if best else None,
            path=storage,
            error=error,
            metrics_history=history,
        )
