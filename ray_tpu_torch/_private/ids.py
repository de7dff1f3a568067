"""Binary unique identifiers for the distributed core.

A rebuild of the reference's ID layer (reference: src/ray/common/id.h —
JobID 4B, ActorID 16B, TaskID 24B, ObjectID 28B with embedded task + index).
We keep the same *structural* idea — ObjectIDs embed their creating TaskID plus a
return/put index so ownership and lineage can be derived from the ID alone — but
use a simpler uniform layout: every ID is raw bytes with a type-tagged hex repr.

The port's copy of ``ray_tpu/_private/ids.py``.
"""
from __future__ import annotations

import os
import threading

_rand_lock = threading.Lock()


def _random_bytes(n: int) -> bytes:
    return os.urandom(n)


class BaseID:
    SIZE = 16
    __slots__ = ("_bytes", "_hash")

    def __init__(self, id_bytes: bytes):
        if len(id_bytes) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(id_bytes)}"
            )
        self._bytes = id_bytes
        self._hash = hash(id_bytes)

    @classmethod
    def from_random(cls):
        return cls(_random_bytes(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\xff" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\xff" * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class UniqueID(BaseID):
    SIZE = 16


class JobID(BaseID):
    SIZE = 4

    _counter = 0

    @classmethod
    def next(cls) -> "JobID":
        with _rand_lock:
            cls._counter += 1
            return cls(cls._counter.to_bytes(4, "little"))


class NodeID(BaseID):
    SIZE = 16


class WorkerID(BaseID):
    SIZE = 16


class ActorID(BaseID):
    """12 random bytes + 4-byte job id."""

    SIZE = 16

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(_random_bytes(12) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[12:16])


class TaskID(BaseID):
    """8 random bytes + 16-byte parent/actor scope."""

    SIZE = 24

    @classmethod
    def for_task(cls, job_id: JobID) -> "TaskID":
        return cls(_random_bytes(20) + job_id.binary())

    @classmethod
    def for_actor_task(cls, actor_id: ActorID) -> "TaskID":
        return cls(_random_bytes(8) + actor_id.binary())

    @classmethod
    def for_driver(cls, job_id: JobID) -> "TaskID":
        return cls(b"\x00" * 20 + job_id.binary())


class ObjectID(BaseID):
    """TaskID (24B) + 4-byte little-endian index.

    Index 0..2**31 are task returns; indices with the high bit set are
    `put` objects. The creating task — hence the owner — is recoverable
    from the ID (reference: ObjectID::ForTaskReturn semantics).
    """

    SIZE = 28
    PUT_BIT = 1 << 31

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + index.to_bytes(4, "little"))

    @classmethod
    def for_put(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + (index | cls.PUT_BIT).to_bytes(4, "little"))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:24])

    def index(self) -> int:
        return int.from_bytes(self._bytes[24:28], "little") & ~self.PUT_BIT

    def is_put(self) -> bool:
        return bool(int.from_bytes(self._bytes[24:28], "little") & self.PUT_BIT)


class PlacementGroupID(BaseID):
    SIZE = 16

    @classmethod
    def of(cls, job_id: JobID) -> "PlacementGroupID":
        return cls(_random_bytes(12) + job_id.binary())
