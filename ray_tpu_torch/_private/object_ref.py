"""ObjectRef: the user-facing future/handle to an object in the store.

Equivalent of the reference's ObjectRef (reference: python/ray/_raylet.pyx:252
— C-extension class wrapping an ObjectID with owner metadata; `ray.get`
resolves it, passing it to tasks forms dependencies). Refs are picklable;
deserializing one in another process yields a usable handle because object
resolution goes through the shared store + lineage in the owner.

The port's copy of ``ray_tpu/_private/object_ref.py``.
"""
from __future__ import annotations

from ray_tpu_torch._private.ids import ObjectID

# Reference-counting hooks, installed by worker.set_global_worker: every
# live ObjectRef instance counts as one local reference in the hosting
# CoreWorker (reference: reference_count.h — local refs tracked per ref
# instance; a deserialized ref counts on the borrower's side).
_on_ref_created = None
_on_ref_deleted = None


class ObjectRef:
    __slots__ = ("object_id", "_owner_hint")

    def __init__(self, object_id: ObjectID, owner_hint: str = ""):
        self.object_id = object_id
        self._owner_hint = owner_hint
        cb = _on_ref_created
        if cb is not None:
            try:
                cb(object_id.binary())
            except Exception:  # noqa: BLE001 — never break ref construction
                pass

    def __del__(self):
        cb = _on_ref_deleted
        if cb is not None:
            try:
                cb(self.object_id.binary())
            except Exception:  # noqa: BLE001 — interpreter may be tearing down
                pass

    def hex(self) -> str:
        return self.object_id.hex()

    def binary(self) -> bytes:
        return self.object_id.binary()

    def task_id(self):
        return self.object_id.task_id()

    def __hash__(self):
        return hash(self.object_id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.object_id == self.object_id

    def __repr__(self):
        return f"ObjectRef({self.object_id.hex()})"

    def __reduce__(self):
        return (ObjectRef, (self.object_id, self._owner_hint))

    def future(self):
        """concurrent.futures.Future resolving to the object's value."""
        import ray_tpu_torch

        return ray_tpu_torch.worker.global_worker().as_future(self)

    def __await__(self):
        import asyncio

        return asyncio.wrap_future(self.future()).__await__()


class _ErrorPayload:
    """Stored in place of a return value when the task raised/died.

    Reference analog: RayError stored as the object value so every getter
    of any downstream ref observes the failure.
    """

    __slots__ = ("error",)

    def __init__(self, error: Exception):
        self.error = error

    def __reduce__(self):
        return (_ErrorPayload, (self.error,))
