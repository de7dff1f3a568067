"""Tracing spans, process-local (the port's copy of
``ray_tpu/util/tracing.py``).

A span is a named, timed block; spans nest through a context variable, and
a stored trace context (``current_context()``) re-enters on another thread
(``attach_context``) or parents spans recorded after the fact
(``record_span``: the engine turns a finished request's timeline into
spans this way). Every span lands in a bounded ring of this process
(``drain_buffered_spans``), and ``spans_to_chrome`` renders spans as
chrome://tracing events. In a process of the distributed core (a driver
after ``init``, a worker) each span is also recorded as a ``SPAN`` task
event, and a task whose submitter carried a trace context runs inside
``task_span``, so its spans parent under the submitter's.
``span_if_active`` opens a span only under an active trace.
``get_trace`` reads one trace's spans back from the GCS, and
``trace_to_chrome`` renders them as ``state.timeline()`` renders tasks.

    from ray_tpu_torch.util import tracing

    with tracing.span("ingest", source="s3"):
        ...
    events = tracing.spans_to_chrome(tracing.drain_buffered_spans())
"""
from __future__ import annotations

import contextvars
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Optional

# (trace_id_hex, span_id_hex) of the innermost active span
_current: contextvars.ContextVar[Optional[tuple[str, str]]] = (
    contextvars.ContextVar("ray_tpu_torch_span", default=None)
)

# every recorded span, newest last; the oldest drop first
_BUFFER_MAX = 2048
_buffer_lock = threading.Lock()
_buffer: deque = deque(maxlen=_BUFFER_MAX)


def drain_buffered_spans() -> list[dict]:
    """Take (and clear) this process's buffered spans, each a flat dict:
    {name, kind, trace_id, span_id, parent_span_id, start, end, attrs}."""
    with _buffer_lock:
        out = list(_buffer)
        _buffer.clear()
    return out


def current_context() -> Optional[dict]:
    """The active span's context ({trace_id, parent_span_id}), or None
    when no span is active (untraced work pays nothing)."""
    cur = _current.get()
    if cur is None:
        return None
    return {"trace_id": cur[0], "parent_span_id": cur[1]}


@contextmanager
def attach_context(ctx: dict | None):
    """Re-enter a stored trace context on a thread that did not inherit
    it: spans opened inside parent under ``ctx['parent_span_id']``. A
    no-op for None."""
    if not ctx:
        yield
        return
    token = _current.set((ctx["trace_id"], ctx["parent_span_id"]))
    try:
        yield
    finally:
        _current.reset(token)


def _record(name: str, trace_id: str, span_id: str,
            parent_span_id: str | None, start: float, end: float,
            attrs: dict | None, kind: str) -> None:
    from ray_tpu_torch._private.worker import global_worker_or_none

    with _buffer_lock:
        _buffer.append({
            "name": name, "kind": kind, "trace_id": trace_id,
            "span_id": span_id, "parent_span_id": parent_span_id,
            "start": start, "end": end, "attrs": attrs or {},
        })
    w = global_worker_or_none()
    if w is None:
        return
    w.task_events.record(
        task_id=w.task_id.binary(), job_id=w.job_id.binary(), name=name,
        event="SPAN", task_type=kind,
        extra={
            "trace_id": trace_id,
            "span_id": span_id,
            "parent_span_id": parent_span_id,
            "start": start,
            "end": end,
            "attrs": attrs or {},
        },
    )


def record_span(
    name: str,
    *,
    trace_id: str,
    parent_span_id: str | None = None,
    start: float,
    end: float,
    attrs: dict | None = None,
    kind: str = "span",
) -> str:
    """Record a finished span from an explicitly carried context and its
    measured wall times; -> the new span id (children recorded in the
    same batch parent under it)."""
    span_id = os.urandom(8).hex()
    _record(name, trace_id, span_id, parent_span_id, start, end, attrs, kind)
    return span_id


@contextmanager
def span(name: str, **attrs: Any):
    """Open a span under the active one (or a new trace); records on
    exit."""
    parent = _current.get()
    trace_id = parent[0] if parent else os.urandom(8).hex()
    span_id = os.urandom(8).hex()
    token = _current.set((trace_id, span_id))
    start = time.time()
    try:
        yield {"trace_id": trace_id, "span_id": span_id}
    finally:
        _current.reset(token)
        _record(name, trace_id, span_id, parent[1] if parent else None,
                start, time.time(), attrs, kind="span")


@contextmanager
def span_if_active(name: str, **attrs: Any):
    """Like ``span`` but a no-op when no trace is active: hot paths
    instrument with this so untraced work pays one contextvar read."""
    if _current.get() is None:
        yield None
        return
    with span(name, **attrs) as ctx:
        yield ctx


@contextmanager
def task_span(spec: dict):
    """Worker-side: run a task as a child span of its submitter's trace
    context (the spec's ``trace_ctx``); a no-op without one."""
    ctx = spec.get("trace_ctx")
    if not ctx:
        yield
        return
    span_id = os.urandom(8).hex()
    token = _current.set((ctx["trace_id"], span_id))
    start = time.time()
    try:
        yield
    finally:
        _current.reset(token)
        _record(spec["name"], ctx["trace_id"], span_id,
                ctx.get("parent_span_id"), start, time.time(),
                {"task_id": spec["task_id"].hex()}, kind="task")


def get_trace(trace_id: str, limit: int | None = None) -> list[dict]:
    """All recorded spans of one trace (driver-side, via the GCS). The
    GCS applies the trace-id filter and the optional ``limit`` on the
    newest spans itself."""
    from ray_tpu_torch.util.state import _task_events

    return [
        e for e in _task_events(trace_id=trace_id, limit=limit)
        if e.get("event") == "SPAN" and e.get("trace_id") == trace_id
    ]


def spans_to_chrome(spans: list[dict]) -> list[dict]:
    """Span dicts (the buffered shape) as chrome://tracing events."""
    events = []
    for e in sorted(spans, key=lambda e: e["start"]):
        events.append({
            "name": e["name"],
            "cat": (e.get("type") or e.get("task_type")
                    or e.get("kind") or "span"),
            "ph": "X",
            "ts": e["start"] * 1e6,
            "dur": (e["end"] - e["start"]) * 1e6,
            "pid": e.get("node_id", e.get("source", ""))[:8],
            "tid": e.get("worker_id", "")[:8],
            "args": {
                "span_id": e["span_id"],
                "parent_span_id": e.get("parent_span_id"),
                **(e.get("attrs") or {}),
            },
        })
    return events


def trace_to_chrome(trace_id: str, filename: str | None = None,
                    limit: int | None = None):
    """Export one trace as chrome://tracing events (the same consumer as
    state.timeline())."""
    import json

    events = spans_to_chrome(get_trace(trace_id, limit=limit))
    if filename is None:
        return events
    with open(filename, "w") as f:
        json.dump(events, f)
    return None
