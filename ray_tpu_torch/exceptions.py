"""Errors the port's engine raises into token streams (its own copies of
the ``ray_tpu.exceptions`` classes of the same names)."""
from __future__ import annotations


class RequestCancelledError(Exception):
    """The request was cancelled (explicit ``cancel()`` or engine shutdown)
    and its KV blocks were returned to the pool."""


class EngineDiedError(Exception):
    """An engine step raised; every in-flight stream is dead."""


class DeadlineExceededError(TimeoutError):
    """The request's ``deadline_s`` expired before generation completed;
    the sequence was evicted and its KV blocks freed."""


class EngineOverloadedError(Exception):
    """Admission control refused the request: the engine's waiting queue
    (or its worst-case KV-block budget) is full. Retryable."""
