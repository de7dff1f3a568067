"""The engine's instrumentation: one clock, the serving-latency histograms
and the flight recorder (the port's copy of ``ray_tpu/serve/llm/obs.py``,
with the reference's metric names, descriptions and buckets).

- **One clock.** Every duration the engine records (step histograms,
  flight records, event stats, deadlines and preemption ages) reads
  ``clock()``, and every timestamp (timelines, spans) ``wall()``.
  ``tests/test_torch_obs.py`` lints ``serve/llm`` for raw
  ``time.time`` / ``time.perf_counter`` / ``time.monotonic`` reads
  outside this module.
- **No device work.** Nothing here reads a tensor; the engine's syncs
  stay what they were.
- **O(1) a step.** The flight recorder is a bounded ring: one dict append
  a step. A dump copies the ring, which is safe from the watchdog thread
  while a wedged step holds the scheduler lock.
"""
from __future__ import annotations

import json
import logging
import os
import tempfile
import time
from collections import deque

import numpy as np

from ray_tpu_torch._private import event_stats
from ray_tpu_torch.util import metrics

logger = logging.getLogger("ray_tpu_torch.serve.llm")

# the two clocks: monotonic for durations, wall for timestamps
clock = time.perf_counter
wall = time.time

# TTFT spans a prefix hit on a tiny model (ms) to a cold long prefill (tens
# of seconds); per-output-token tracks the decode step; queue wait tracks
# admission backpressure
TTFT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)
TPOT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0)
QUEUE_WAIT_BUCKETS = (0.0005, 0.002, 0.01, 0.05, 0.2, 1.0, 5.0, 20.0)
# the step's device->host id sync: sub-ms on the pipelined steady state,
# a device step when the lag collapses
HOST_SYNC_BUCKETS = (
    0.00005, 0.0002, 0.001, 0.005, 0.02, 0.1, 0.5, 2.0,
)


def ttft_histogram() -> metrics.Histogram:
    return metrics.histogram(
        "llm_ttft_seconds",
        "Time from submit() to the first generated token",
        boundaries=TTFT_BUCKETS,
    )


def tpot_histogram() -> metrics.Histogram:
    return metrics.histogram(
        "llm_time_per_output_token_seconds",
        "Gap between consecutive generated tokens of one request",
        boundaries=TPOT_BUCKETS,
    )


def queue_wait_histogram() -> metrics.Histogram:
    return metrics.histogram(
        "llm_queue_wait_seconds",
        "Time a request waited for admission (submit -> admitted)",
        boundaries=QUEUE_WAIT_BUCKETS,
    )


def host_sync_histogram() -> metrics.Histogram:
    return metrics.histogram(
        "llm_host_sync_seconds",
        "Time blocked in the engine's single device->host token sync",
        boundaries=HOST_SYNC_BUCKETS,
    )


def sync_bytes_counter() -> metrics.Counter:
    return metrics.counter(
        "llm_sync_bytes",
        "Bytes crossed device->host at the engine's token sync point "
        "(O(batch) int32 per step under fused sampling)",
    )


def goodput_gauge() -> metrics.Gauge:
    return metrics.gauge(
        "llm_goodput_tokens_per_sec",
        "Windowed serving goodput: tokens retired per second of "
        "attributed device time, by step kind",
        tag_keys=("kind",),
    )


def mfu_gauge() -> metrics.Gauge:
    return metrics.gauge(
        "llm_serving_mfu",
        "Windowed serving model-FLOPs utilization: goodput x 2*n_params "
        "FLOPs/token over the executor's peak FLOP rate, by step kind",
        tag_keys=("kind",),
    )


def compile_counter() -> metrics.Counter:
    return metrics.counter(
        "llm_compile_events",
        "New jit signatures seen by this engine's DecodeFns, by shape key",
        tag_keys=("shape",),
    )


def shape_key(sig: tuple) -> str:
    """Label of one (kind, tokens shape, tables shape) signature, e.g.
    ``prefill_chunk:4x32:4x8``; bounded by the bucket ladders."""
    kind, tok, tbl = sig
    return (
        f"{kind}:{'x'.join(str(d) for d in tok)}:"
        f"{'x'.join(str(d) for d in tbl)}"
    )


class FlightRecorder:
    """Bounded ring of per-step records for post-mortems.

    ``record()`` appends one dict (built by the engine under its lock);
    ``dump()`` packages the ring and the process's event stats into one
    dict. Dumped when the engine dies, on a watchdog timeout, on
    ``shutdown(dump=...)`` and by ``engine.debug_dump()``.
    """

    def __init__(self, capacity: int = 256):
        self.capacity = max(1, int(capacity))
        self._ring: deque[dict] = deque(maxlen=self.capacity)
        self._steps = 0

    def __len__(self) -> int:
        return len(self._ring)

    def record(self, rec: dict) -> None:
        """O(1): one append; the ring drops its oldest record."""
        self._steps += 1
        rec["step"] = self._steps
        self._ring.append(rec)

    def snapshot(self) -> list[dict]:
        # list(deque) is one GIL-atomic copy: safe without the engine lock
        return list(self._ring)

    def dump(self, reason: str, extra: dict | None = None) -> dict:
        out = {
            "reason": reason,
            "ts": wall(),
            "pid": os.getpid(),
            "steps_total": self._steps,
            "capacity": self.capacity,
            "steps": self.snapshot(),
            "event_stats": event_stats.snapshot(),
        }
        if extra:
            out.update(extra)
        return out


def dump_dir(explicit: str | None = None) -> str:
    """Where dumps land: the engine's configured dir, else
    ``RAY_TPU_FLIGHT_DIR``, else ``<tmp>/ray_tpu_flight``."""
    return (
        explicit
        or os.environ.get("RAY_TPU_FLIGHT_DIR")
        or os.path.join(tempfile.gettempdir(), "ray_tpu_flight")
    )


# keep the newest N auto-named dumps: an engine that dies again and again
# writes one dump per death, and unbounded that fills the disk the
# post-mortem needs
FLIGHT_KEEP_ENV = "RAY_TPU_FLIGHT_KEEP"
_FLIGHT_KEEP_DEFAULT = 20


def _prune_dumps(d: str) -> None:
    """Keep the newest RAY_TPU_FLIGHT_KEEP (default 20; <= 0 keeps all)
    auto-named dumps in ``d``, by mtime. Never raises."""
    try:
        keep = int(os.environ.get(FLIGHT_KEEP_ENV, _FLIGHT_KEEP_DEFAULT))
    except ValueError:
        keep = _FLIGHT_KEEP_DEFAULT
    if keep <= 0:
        return
    try:
        names = [
            n
            for n in os.listdir(d)
            if n.startswith("llm_flight_") and n.endswith(".json")
        ]
        if len(names) <= keep:
            return
        paths = sorted(
            (os.path.join(d, n) for n in names),
            key=lambda p: os.stat(p).st_mtime,
        )
        for p in paths[:-keep]:
            os.unlink(p)
    except OSError as e:
        logger.warning("flight-recorder dir prune failed: %r", e)


def _json_default(o):
    """What ``json`` cannot write itself: numpy scalars and arrays as
    numbers, a tensor as its metadata only (its values would need a
    device read), anything else (a ``torch.device``) as its string."""
    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    if type(o).__name__ == "Tensor" and hasattr(o, "device"):
        return f"<tensor {tuple(o.shape)} {o.dtype} on {o.device}>"
    return str(o)


def write_dump(
    dump: dict, *, dir: str | None = None, path: str | None = None
) -> str | None:
    """Write one dump as JSON; -> its path, or None when the write failed
    (the engine is dying: a dump must never raise). Auto-named dumps
    rotate (``_prune_dumps``); an explicit ``path`` is the caller's."""
    auto = path is None
    try:
        if path is None:
            d = dump_dir(dir)
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d,
                f"llm_flight_{os.getpid()}_{int(wall() * 1000)}.json",
            )
        with open(path, "w") as f:
            json.dump(dump, f, indent=1, default=_json_default)
        if auto:
            _prune_dumps(os.path.dirname(path))
        return path
    except Exception as e:  # noqa: BLE001 — never fail the failure path
        logger.warning("flight-recorder dump failed: %r", e)
        return None
