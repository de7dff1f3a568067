"""Compute strategies for map operators (the port's copy of
``ray_tpu/data/compute.py``; reference:
python/ray/data/_internal/compute.py — TaskPoolStrategy vs ActorPoolStrategy,
and _internal/execution/operators/actor_pool_map_operator.py for the
autoscaling pool semantics).

Tasks are the default. An ``ActorPoolStrategy`` runs the transform on a pool
of long-lived actors so stateful callables (a loaded model, a tokenizer)
are constructed ONCE per actor and reused across blocks — the operator
batch-inference pipelines need.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class TaskPoolStrategy:
    """Stateless per-block tasks (the default)."""


@dataclasses.dataclass
class ActorPoolStrategy:
    """Autoscaling pool of stateful block-transform actors.

    The pool starts at ``min_size`` and grows (up to ``max_size``) whenever
    every live actor already has ``max_tasks_in_flight_per_actor`` blocks
    queued and more input is waiting; it never shrinks mid-stage (actors are
    killed when the stage drains). Mirrors the reference's
    ``ActorPoolMapOperator`` scaling rule without its rate heuristics.

    Resource safety: the executor reserves one upstream task slot when the
    pool feeds from a live stage (capping the pool below the cluster's CPU
    count), and a pool whose configured minimum wouldn't leave that slot
    free runs AFTER upstream materializes instead — a pool sized to the
    whole cluster completes either way (executor.run_actor_stage).
    """

    min_size: int = 1
    max_size: Optional[int] = None  # None = min_size (fixed pool)
    max_tasks_in_flight_per_actor: int = 2
    num_cpus: float = 1.0
    resources: Optional[dict] = None

    def __post_init__(self):
        if self.min_size < 1:
            raise ValueError("min_size must be >= 1")
        if self.max_size is None:
            self.max_size = self.min_size
        if self.max_size < self.min_size:
            raise ValueError("max_size must be >= min_size")
        if self.max_tasks_in_flight_per_actor < 1:
            raise ValueError("max_tasks_in_flight_per_actor must be >= 1")
