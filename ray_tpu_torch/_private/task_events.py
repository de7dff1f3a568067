"""Task-event buffering: per-worker event log flushed to the GCS.

Equivalent of the reference's core-worker task event buffer
(reference: src/ray/core_worker/task_event_buffer.cc — events buffered
in-process, flushed periodically to GcsTaskManager
src/ray/gcs/gcs_server/gcs_task_manager.h:326). Events power the state API
(`list_tasks`, `summarize_tasks`) and the chrome timeline.

The port's copy of ``ray_tpu/_private/task_events.py``.
"""
from __future__ import annotations

import threading
import time
from typing import Any

_FLUSH_INTERVAL_S = 0.5
_MAX_BUFFER = 1000


class TaskEventBuffer:
    def __init__(self, gcs_client, worker_id_hex: str, node_id_hex: str):
        self._gcs = gcs_client
        self._worker_id = worker_id_hex
        self._node_id = node_id_hex
        self._lock = threading.Lock()
        self._buffer: list[dict] = []
        self._stopped = threading.Event()
        self._thread = threading.Thread(
            target=self._flush_loop, daemon=True, name="task-events"
        )
        self._thread.start()

    def record(
        self,
        *,
        task_id: bytes,
        job_id: bytes,
        name: str,
        event: str,  # SUBMITTED | RUNNING | FINISHED | FAILED
        task_type: str,
        extra: dict[str, Any] | None = None,
    ) -> None:
        e = {
            "task_id": task_id.hex(),
            "job_id": job_id.hex(),
            "name": name,
            "event": event,
            "type": task_type,
            "worker_id": self._worker_id,
            "node_id": self._node_id,
            "ts": time.time(),
        }
        if extra:
            e.update(extra)
        with self._lock:
            self._buffer.append(e)
            if len(self._buffer) >= _MAX_BUFFER:
                buf, self._buffer = self._buffer, []
            else:
                buf = None
        if buf:
            self._send(buf)

    def _flush_loop(self) -> None:
        while not self._stopped.wait(_FLUSH_INTERVAL_S):
            self.flush()

    def flush(self) -> None:
        with self._lock:
            buf, self._buffer = self._buffer, []
        if buf:
            self._send(buf)

    def _send(self, events: list[dict]) -> None:
        try:
            self._gcs.call("add_task_events", {"events": events})
        except Exception:  # noqa: BLE001 — observability must never kill work
            pass

    def stop(self) -> None:
        self._stopped.set()
        self.flush()
