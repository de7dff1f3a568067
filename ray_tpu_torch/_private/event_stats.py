"""Event stats: count and latency of named control-loop operations (the
port's copy of ``ray_tpu/_private/event_stats.py``).

Each timed block records under a dotted name (``"llm.engine.step.decode"``);
``snapshot()`` feeds the engine's flight-recorder dumps. Process-local.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager

_lock = threading.Lock()
_stats: dict[str, dict] = {}


def record(name: str, duration_s: float) -> None:
    with _lock:
        s = _stats.get(name)
        if s is None:
            s = _stats[name] = {"count": 0, "total_ms": 0.0, "max_ms": 0.0}
        s["count"] += 1
        ms = duration_s * 1000.0
        s["total_ms"] += ms
        if ms > s["max_ms"]:
            s["max_ms"] = ms


@contextmanager
def timed(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record(name, time.perf_counter() - t0)


def snapshot(prefix: str | None = None) -> dict[str, dict]:
    """Current stats, with ``mean_ms``; ``prefix`` keeps one dotted
    namespace (``"llm."``)."""
    with _lock:
        out = {}
        for k, v in _stats.items():
            if prefix is not None and not k.startswith(prefix):
                continue
            d = dict(v)
            d["mean_ms"] = d["total_ms"] / d["count"] if d["count"] else 0.0
            out[k] = d
        return out


def reset() -> None:
    with _lock:
        _stats.clear()


def summary_string(limit: int = 30) -> str:
    """Human-readable table, busiest first."""
    snap = snapshot()
    rows = sorted(snap.items(), key=lambda kv: -kv[1]["total_ms"])[:limit]
    lines = [f"{'event':<40} {'count':>8} {'mean_ms':>9} {'max_ms':>9} "
             f"{'total_ms':>10}"]
    for name, s in rows:
        lines.append(
            f"{name:<40} {s['count']:>8} {s['mean_ms']:>9.2f} "
            f"{s['max_ms']:>9.2f} {s['total_ms']:>10.1f}"
        )
    return "\n".join(lines)
