"""Memory pressure detection for the raylet's OOM-killing policy.

Equivalent of the reference's MemoryMonitor
(reference: src/ray/common/memory_monitor.h:52 — kernel memory usage vs a
threshold triggers worker-killing policies, worker_killing_policy.cc:116).
Reads cgroup v2 limits when present (containers) and falls back to
/proc/meminfo; the reader is injectable for tests and policies.

The port's copy of ``ray_tpu/_private/memory_monitor.py``.
"""
from __future__ import annotations

import os
from typing import Callable


def _read_cgroup_v2() -> tuple[int, int] | None:
    """(used_bytes, limit_bytes) from cgroup v2, or None."""
    try:
        with open("/sys/fs/cgroup/memory.max") as f:
            raw = f.read().strip()
        if raw == "max":
            return None  # unlimited: defer to system meminfo
        limit = int(raw)
        with open("/sys/fs/cgroup/memory.current") as f:
            used = int(f.read().strip())
        return used, limit
    except (OSError, ValueError):
        return None


def _read_meminfo() -> tuple[int, int] | None:
    """(used_bytes, total_bytes) from /proc/meminfo, or None."""
    try:
        fields = {}
        with open("/proc/meminfo") as f:
            for line in f:
                k, _, rest = line.partition(":")
                fields[k] = int(rest.strip().split()[0]) * 1024
        total = fields["MemTotal"]
        avail = fields.get("MemAvailable", fields.get("MemFree", 0))
        return total - avail, total
    except (OSError, KeyError, ValueError, IndexError):
        return None


def system_memory_usage() -> tuple[int, int] | None:
    """(used, limit) preferring the container's cgroup over the host."""
    return _read_cgroup_v2() or _read_meminfo()


def process_rss_bytes(pid: int) -> int:
    """Resident set size of one process (0 if unreadable/gone)."""
    try:
        with open(f"/proc/{pid}/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


class MemoryMonitor:
    """Threshold check over an injectable reading (reference:
    memory_monitor.h IsUsageAboveThreshold)."""

    def __init__(
        self,
        usage_threshold: float,
        read_fn: Callable[[], tuple[int, int] | None] | None = None,
    ):
        self.usage_threshold = usage_threshold
        self._read = read_fn or system_memory_usage

    def usage_fraction(self) -> float | None:
        r = self._read()
        if not r or r[1] <= 0:
            return None
        used, limit = r
        return used / limit

    def is_over_threshold(self) -> bool:
        frac = self.usage_fraction()
        return frac is not None and frac > self.usage_threshold
