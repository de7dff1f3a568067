"""Per-worker training session: report(), context, checkpoint plumbing
(the port's copy of ``ray_tpu/train/session.py``).

Equivalent of the reference's _TrainSession
(reference: python/ray/train/_internal/session.py:132 — report at :844→:612
streams metrics+checkpoint through a queue back to the trainer). Here the
session buffers reports in the worker actor; the trainer polls them via an
actor method (our actors execute methods serially, so the user train loop
runs on a background thread and polling stays responsive).

``TrainContext`` has no ``mesh`` (the JAX package's device mesh; the gang
here is one ``torch.distributed`` group). ``get_dataset_shard`` hands a
worker its shard of a trainer dataset, a ``ray_tpu_torch.data``
``DataIterator``.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field

@dataclass
class TrainContext:
    world_size: int = 1
    world_rank: int = 0
    local_rank: int = 0
    node_rank: int = 0
    trial_name: str = ""
    storage_path: str = ""
    trial_dir: str = ""
    experiment_config: dict = field(default_factory=dict)
    # name -> this rank's DataIterator shard (reference: streaming_split
    # outputs delivered to each train worker, data_parallel_trainer.py:59)
    dataset_shards: dict = field(default_factory=dict)

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_trial_dir(self) -> str:
        return self.trial_dir


class ReportBuffer:
    """Thread-safe report queue: the user loop appends on its thread, the
    controller drains via actor polls. ``consumed`` is how many reports
    the controller had already taken at its latest poll."""

    def __init__(self):
        self._lock = threading.Lock()
        self._reports: list[dict] = []
        self._done = False
        self._error: str | None = None
        self.consumed = 0

    def append(self, entry: dict) -> None:
        with self._lock:
            self._reports.append(entry)

    def drain(self, since: int) -> tuple[list[dict], bool, str | None]:
        with self._lock:
            self.consumed = max(self.consumed, since)
            return self._reports[since:], self._done, self._error

    def finish(self, error: str | None = None) -> None:
        with self._lock:
            self._done = True
            self._error = error


class _Session(ReportBuffer):
    def __init__(self, context: TrainContext):
        super().__init__()
        self.context = context

    def report(self, metrics: dict, checkpoint=None) -> None:
        entry = {"metrics": dict(metrics)}
        if checkpoint is not None:
            entry["checkpoint_path"] = checkpoint.path
        self.append(entry)


_session: _Session | None = None


def init_session(context: TrainContext) -> _Session:
    global _session
    _session = _Session(context)
    return _session


def get_session() -> _Session:
    if _session is None:
        raise RuntimeError(
            "No training session active — are you inside train_loop_per_worker?"
        )
    return _session


def report(metrics: dict, *, checkpoint=None) -> None:
    """Stream metrics (and optionally a checkpoint) to the trainer
    (reference: ray.train.report)."""
    get_session().report(metrics, checkpoint)


def get_context() -> TrainContext:
    return get_session().context


def get_dataset_shard(name: str = "train"):
    """This worker's shard of a trainer dataset, as a DataIterator
    (reference: ray.train.get_dataset_shard / session.get_dataset_shard —
    the consumer side of Dataset.streaming_split)."""
    shards = get_session().context.dataset_shards
    if name not in shards:
        raise KeyError(
            f"no dataset shard named {name!r}; trainer datasets: "
            f"{sorted(shards)}"
        )
    return shards[name]
