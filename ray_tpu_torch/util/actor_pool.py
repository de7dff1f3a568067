"""ActorPool — load-balanced work distribution over a fixed actor set
(the port's copy of ``ray_tpu/util/actor_pool.py``).

Equivalent of the reference's ray.util.ActorPool
(reference: python/ray/util/actor_pool.py — submit/map/map_unordered with
get_next/get_next_unordered).
"""
from __future__ import annotations

from typing import Any, Callable, Iterable

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors: Iterable):
        self._idle = list(actors)
        if not self._idle:
            raise ValueError("ActorPool needs at least one actor")
        self._future_to_actor: dict[bytes, Any] = {}
        self._pending: list = []  # (fn, value) waiting for a free actor
        self._index_to_future: dict[int, Any] = {}
        self._next_task_index = 0
        self._next_return_index = 0

    def submit(self, fn: Callable, value: Any) -> None:
        """fn(actor, value) -> ObjectRef (e.g. lambda a, v: a.f.remote(v))."""
        if self._idle:
            actor = self._idle.pop()
            ref = fn(actor, value)
            self._future_to_actor[ref.object_id.binary()] = (actor, ref)
            self._index_to_future[self._next_task_index] = ref
            self._next_task_index += 1
        else:
            self._pending.append((fn, value))

    def has_next(self) -> bool:
        return self._next_return_index < self._next_task_index or bool(self._pending)

    def _return_actor(self, ref) -> None:
        actor, _ = self._future_to_actor.pop(ref.object_id.binary())
        if self._pending:
            fn, value = self._pending.pop(0)
            self._idle.append(actor)
            self.submit(fn, value)
        else:
            self._idle.append(actor)

    def get_next(self, timeout: float | None = None) -> Any:
        """Next result in SUBMISSION order."""
        if self._next_return_index >= self._next_task_index:
            raise StopIteration("no pending results")
        # peek — only consume the slot once the result actually resolved,
        # so a timeout is retryable and never skips/leaks a result
        ref = self._index_to_future[self._next_return_index]
        try:
            out = ray_tpu_torch.get(ref, timeout=timeout)
        except ray_tpu_torch.exceptions.GetTimeoutError:
            raise
        except Exception:
            # the task FINISHED (with an error): the actor is free again
            del self._index_to_future[self._next_return_index]
            self._next_return_index += 1
            self._return_actor(ref)
            raise
        del self._index_to_future[self._next_return_index]
        self._next_return_index += 1
        self._return_actor(ref)
        return out

    def get_next_unordered(self, timeout: float | None = None) -> Any:
        """Whichever pending result lands first."""
        refs = [r for _, r in self._future_to_actor.values()]
        if not refs:
            raise StopIteration("no pending results")
        ready, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("get_next_unordered timed out")
        ref = ready[0]
        # drop it from the ordered map too
        for idx, f in list(self._index_to_future.items()):
            if f.object_id == ref.object_id:
                del self._index_to_future[idx]
                if idx == self._next_return_index:
                    self._next_return_index += 1
                break
        # the task FINISHED (ready): free the actor BEFORE the get, which
        # re-raises task errors — otherwise a failed task leaks the actor and
        # map_unordered re-selects the same ready-failed ref forever
        self._return_actor(ref)
        return ray_tpu_torch.get(ref)

    def map(self, fn: Callable, values: Iterable) -> Iterable:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable) -> Iterable:
        for v in values:
            self.submit(fn, v)
        while self._future_to_actor or self._pending:
            yield self.get_next_unordered()
