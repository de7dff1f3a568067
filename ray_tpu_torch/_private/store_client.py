"""GCS metadata persistence backends.

Equivalent of the reference's pluggable GCS store
(reference: src/ray/gcs/store_client/ — InMemoryStoreClient default
in_memory_store_client.h:31, RedisStoreClient redis_store_client.h:33 for
GCS fault tolerance). The file-backed store plays Redis's role on one host:
the GCS snapshots its tables into it, and a restarted GCS rehydrates from
it (head restart tolerance, SURVEY.md §5.3 GCS FT).

The port's copy of ``ray_tpu/_private/store_client.py``.
"""
from __future__ import annotations

import os
import pickle
import tempfile


class InMemoryStoreClient:
    """Default: no persistence (reference default)."""

    persistent = False

    def load(self) -> dict | None:
        return None

    def save(self, snapshot: dict) -> None:
        pass


class FileStoreClient:
    """Atomic pickle snapshots at a fixed path."""

    persistent = True

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def load(self) -> dict | None:
        try:
            with open(self.path, "rb") as f:
                return pickle.load(f)
        except FileNotFoundError:
            return None
        except Exception:  # noqa: BLE001 — torn write from a crash: start fresh
            return None

    def save(self, snapshot: dict) -> None:
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(self.path) or ".", prefix=".gcs_snap_"
        )
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(snapshot, f)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
