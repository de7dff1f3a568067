"""Per-trial tune session: report() / get_checkpoint() inside a trainable
(the port's copy of ``ray_tpu/tune/session.py``, on the port's Train
``ReportBuffer`` and ``Checkpoint``).

Equivalent of the reference's tune session (reference: python/ray/tune —
ray.tune.report / ray.train.get_checkpoint inside function trainables).
Reports are buffered in the trial actor and drained by the TuneController;
checkpoints passed to report() are persisted into the trial dir so they
outlive the actor (needed for PBT exploit and resume).
"""
from __future__ import annotations

import os
import shutil
from typing import Any, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.session import ReportBuffer


class _TuneSession(ReportBuffer):
    def __init__(self, trial_id: str, trial_dir: str, restore_path: str | None,
                 start_iteration: int = 0):
        super().__init__()
        self.trial_id = trial_id
        self.trial_dir = trial_dir
        self.restore_path = restore_path
        self._iteration = start_iteration

    def report(self, metrics: dict, checkpoint: Checkpoint | None = None) -> None:
        with self._lock:
            self._iteration += 1
            entry = {"metrics": dict(metrics), "iteration": self._iteration}
        if checkpoint is not None:
            dest = os.path.join(self.trial_dir, f"checkpoint_{self._iteration:06d}")
            if os.path.abspath(checkpoint.path) != dest:
                shutil.copytree(checkpoint.path, dest, dirs_exist_ok=True)
            entry["checkpoint_path"] = dest
        self.append(entry)

    def get_checkpoint(self) -> Optional[Checkpoint]:
        if self.restore_path and os.path.isdir(self.restore_path):
            return Checkpoint(self.restore_path)
        return None


_session: _TuneSession | None = None


def init_session(s: _TuneSession) -> None:
    global _session
    _session = s


def get_session() -> _TuneSession:
    if _session is None:
        raise RuntimeError("No tune session — are you inside a trainable?")
    return _session


def report(metrics: dict, *, checkpoint: Checkpoint | None = None) -> None:
    get_session().report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return get_session().get_checkpoint()
