"""Distributed FIFO queue backed by a named actor (the port's copy of
``ray_tpu/util/queue.py``).

Equivalent of the reference's ray.util.queue.Queue
(reference: python/ray/util/queue.py — actor-backed queue with
put/get/qsize and blocking variants).
"""
from __future__ import annotations

import time
from typing import Any

import ray_tpu_torch
from ray_tpu_torch.actor import ActorClass


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        from collections import deque

        self._maxsize = maxsize
        self._q = deque()

    def put(self, item) -> bool:
        if self._maxsize > 0 and len(self._q) >= self._maxsize:
            return False
        self._q.append(item)
        return True

    def get(self):
        if not self._q:
            return False, None
        return True, self._q.popleft()

    def qsize(self) -> int:
        return len(self._q)


class Queue:
    def __init__(self, maxsize: int = 0, name: str | None = None):
        self._actor = ActorClass(_QueueActor, num_cpus=0.01, name=name).remote(maxsize)

    def put(self, item: Any, block: bool = True, timeout: float | None = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if ray_tpu_torch.get(self._actor.put.remote(item), timeout=60):
                return
            if not block:
                raise Full
            if deadline is not None and time.monotonic() > deadline:
                raise Full
            time.sleep(0.01)

    def get(self, block: bool = True, timeout: float | None = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ok, item = ray_tpu_torch.get(self._actor.get.remote(), timeout=60)
            if ok:
                return item
            if not block:
                raise Empty
            if deadline is not None and time.monotonic() > deadline:
                raise Empty
            time.sleep(0.01)

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self._actor.qsize.remote(), timeout=60)

    def empty(self) -> bool:
        return self.qsize() == 0

    def shutdown(self) -> None:
        ray_tpu_torch.kill(self._actor)
