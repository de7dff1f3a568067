"""Per-dataset execution context (the port's copy of
``ray_tpu/data/context.py``; reference: python/ray/data/context.py
DataContext — global-ish singleton of execution knobs, copied onto each
dataset at creation)."""
from __future__ import annotations

import dataclasses
import threading
from typing import ClassVar, Optional


@dataclasses.dataclass
class DataContext:
    # target size of one block produced by reads/repartitions
    target_max_block_size: int = 128 * 1024 * 1024
    # default read parallelism when the datasource doesn't imply one
    read_parallelism: int = 8
    # max concurrently in-flight block tasks in the streaming executor
    # (backpressure; reference streaming_executor resource-limits this
    # dynamically — we use a fixed window scaled to cluster CPUs at run time)
    max_in_flight_tasks: int = 0  # 0 = auto (2x cluster CPUs)
    # default batch format for map_batches when unspecified
    default_batch_format: str = "numpy"
    # seed for operations that accept none (None = nondeterministic)
    seed: int | None = None

    _current: ClassVar[Optional["DataContext"]] = None
    _lock: ClassVar[threading.Lock] = threading.Lock()

    @staticmethod
    def get_current() -> "DataContext":
        with DataContext._lock:
            if DataContext._current is None:
                DataContext._current = DataContext()
            return DataContext._current
