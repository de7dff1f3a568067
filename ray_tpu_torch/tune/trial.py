"""Trial state (the port's copy of ``ray_tpu/tune/trial.py``).

Equivalent of the reference's Trial (reference: python/ray/tune/experiment/
trial.py:307 — id, config, status lifecycle PENDING→RUNNING→TERMINATED/
ERROR/PAUSED, last_result, checkpoint bookkeeping).
"""
from __future__ import annotations

import os
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional

PENDING = "PENDING"
RUNNING = "RUNNING"
PAUSED = "PAUSED"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


@dataclass
class Trial:
    config: dict
    experiment_dir: str
    trial_id: str = field(default_factory=lambda: uuid.uuid4().hex[:8])
    status: str = PENDING
    last_result: dict | None = None
    results: list = field(default_factory=list)
    error: str | None = None
    checkpoint_path: str | None = None
    # training_iteration observed so far (monotonic across pauses/restores)
    iteration: int = 0
    # set by PBT when the trial should restore from another trial's checkpoint
    restore_path: str | None = None

    @property
    def trial_dir(self) -> str:
        d = os.path.join(self.experiment_dir, f"trial_{self.trial_id}")
        os.makedirs(d, exist_ok=True)
        return d

    def metric_value(self, metric: str) -> Optional[float]:
        if self.last_result and metric in self.last_result:
            return float(self.last_result[metric])
        return None

    def to_json(self) -> dict:
        return {
            "trial_id": self.trial_id,
            "config": self.config,
            "status": self.status,
            "last_result": self.last_result,
            "error": self.error,
            "checkpoint_path": self.checkpoint_path,
            "iteration": self.iteration,
        }

    @classmethod
    def from_json(cls, d: dict, experiment_dir: str) -> "Trial":
        t = cls(config=d["config"], experiment_dir=experiment_dir,
                trial_id=d["trial_id"])
        t.status = d["status"]
        t.last_result = d.get("last_result")
        t.error = d.get("error")
        t.checkpoint_path = d.get("checkpoint_path")
        t.iteration = d.get("iteration", 0)
        return t
