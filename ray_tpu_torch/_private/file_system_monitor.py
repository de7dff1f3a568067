"""Disk-capacity monitoring for node health.

Equivalent of the reference's FileSystemMonitor (reference:
src/ray/common/file_system_monitor.h — periodic statvfs over the session
paths; OverCapacity() makes the raylet refuse new work so a disk-full node
degrades instead of corrupting spills/checkpoints). The reader is
injectable for tests.

The port's copy of ``ray_tpu/_private/file_system_monitor.py``.
"""
from __future__ import annotations

import os
from typing import Callable, Iterable


def disk_usage(path: str) -> tuple[int, int] | None:
    """(used_bytes, total_bytes) for the filesystem holding `path`."""
    try:
        st = os.statvfs(path)
    except OSError:
        return None
    total = st.f_frsize * st.f_blocks
    free = st.f_frsize * st.f_bavail
    return total - free, total


class FileSystemMonitor:
    """Threshold check over one or more paths (reference:
    file_system_monitor.h OverCapacity)."""

    def __init__(
        self,
        paths: Iterable[str],
        capacity_threshold: float = 0.95,
        read_fn: Callable[[str], tuple[int, int] | None] | None = None,
        cache_ttl_s: float = 0.0,
    ):
        self.paths = [p for p in paths if p]
        self.capacity_threshold = capacity_threshold
        self._read = read_fn or disk_usage
        # cache_ttl_s > 0: amortize the statvfs syscalls for callers on hot
        # paths (the raylet dispatch loop runs per task wakeup; the
        # reference monitor likewise polls on an interval)
        self._ttl = cache_ttl_s
        self._cached: float | None = None
        self._cached_at = float("-inf")

    def usage_fraction(self) -> float | None:
        """Max used/total across the watched paths (None if unreadable)."""
        import time

        if self._ttl > 0 and time.monotonic() - self._cached_at < self._ttl:
            return self._cached
        worst = None
        for p in self.paths:
            r = self._read(p)
            if not r or r[1] <= 0:
                continue
            frac = r[0] / r[1]
            worst = frac if worst is None else max(worst, frac)
        if self._ttl > 0:
            self._cached = worst
            self._cached_at = time.monotonic()
        return worst

    def over_capacity(self) -> bool:
        if self.capacity_threshold <= 0:
            return False
        frac = self.usage_fraction()
        return frac is not None and frac > self.capacity_threshold
