"""User-facing exception types (the port's copy of ``ray_tpu/exceptions.py``:
the core's errors and the engine's, with the reference's names and
messages).

Equivalent of the reference's python/ray/exceptions.py error taxonomy
(RayError / RayTaskError / RayActorError / ObjectLostError ...).
"""
from __future__ import annotations

import traceback


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A remote task raised; re-raised at `get` with the remote traceback.

    Reference: python/ray/exceptions.py RayTaskError — the remote traceback
    string is carried so the user sees the worker-side stack.
    """

    def __init__(self, function_name: str, remote_traceback: str, cause: Exception | None = None):
        self.function_name = function_name
        self.remote_traceback = remote_traceback
        self.cause = cause
        super().__init__(
            f"task {function_name} failed:\n{remote_traceback}"
        )

    def __reduce__(self):
        return (TaskError, (self.function_name, self.remote_traceback, self.cause))

    @classmethod
    def from_exception(cls, function_name: str, exc: Exception) -> "TaskError":
        tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
        return cls(function_name, tb, exc)


class ActorError(RayTpuError):
    """The actor died before or while executing this method."""


class ActorDiedError(ActorError):
    def __init__(self, actor_id, reason: str = ""):
        self.actor_id = actor_id
        super().__init__(f"actor {actor_id} died: {reason}")


class EngineDiedError(ActorError):
    """A serving engine failed (step raised) or wedged (step watchdog
    fired); every in-flight stream is dead."""


class ObjectLostError(RayTpuError):
    """Object was evicted/lost and could not be reconstructed from lineage."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """`get(timeout=...)` expired."""


class EngineOverloadedError(RayTpuError):
    """Admission control refused the request: the engine's waiting queue
    (or its worst-case KV-block budget) is full. Retryable."""


class RequestCancelledError(RayTpuError):
    """The request was cancelled (explicit ``cancel()`` or engine shutdown)
    and its KV blocks were returned to the pool."""


class DeadlineExceededError(RayTpuError, TimeoutError):
    """The request's ``deadline_s`` expired before generation completed;
    the sequence was evicted and its KV blocks freed."""


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died unexpectedly."""


class OutOfMemoryError(WorkerCrashedError):
    """The memory monitor killed the worker to relieve node memory pressure
    (reference: ray.exceptions.OutOfMemoryError via worker_killing_policy)."""


class ObjectStoreFullError(RayTpuError):
    """Object store is out of memory and eviction could not make room."""


class RuntimeEnvSetupError(RayTpuError):
    """Preparing the runtime environment for a task/actor failed."""


class PlacementGroupUnavailableError(RayTpuError):
    """Placement group could not be scheduled with current cluster resources."""
