"""Streaming generator returns: refs yielded as the producer produces them.

Equivalent of the reference's streaming ObjectRefGenerator
(reference: python/ray/_raylet.pyx:957-1043 — num_returns="streaming" tasks
yield; each yielded value becomes its own return object the consumer can
get before the task finishes). Protocol here: the task's return index 0 is
the COMPLETION MARKER (sealed last, holding the yield count — or the error
payload), and yielded values seal at indices 1..n as they are produced, so
the consumer streams by polling value presence and finishes/raises via the
marker.

The port's copy of ``ray_tpu/_private/generator.py``.
"""
from __future__ import annotations


from ray_tpu_torch._private.ids import ObjectID, TaskID
from ray_tpu_torch._private.object_ref import ObjectRef


class ObjectRefGenerator:
    """Iterator of ObjectRefs for one streaming task. Yields each value's
    ref as soon as the producer seals it; raises the task's error (from the
    completion marker) and stops after `count` values."""

    def __init__(self, completed_ref: ObjectRef, spec: dict):
        self._completed_ref = completed_ref
        self._task_id = TaskID(spec["task_id"])
        self._spec = spec
        self._i = 1
        self._count: int | None = None

    def __iter__(self) -> "ObjectRefGenerator":
        return self

    def __next__(self) -> ObjectRef:
        from ray_tpu_torch._private.worker import global_worker

        w = global_worker()
        if self._count is not None and self._i > self._count:
            raise StopIteration
        oid_i = ObjectID.for_task_return(self._task_id, self._i)
        oid_0 = self._completed_ref.object_id
        while self._count is None:
            # remote producers: keep pulls triggered for both the value and
            # the completion marker
            w._maybe_fetch(oid_i)
            w._maybe_fetch(oid_0)
            # block in the daemon until the value (stream it out eagerly)
            # or the completion marker (count / producer error) seals —
            # the OP_WAIT cv replaces any status busy-polling
            present = w.store.wait_objects([oid_i, oid_0], 1, timeout_ms=200)
            if oid_i.binary() in present:
                break
            if oid_0.binary() in present:
                self._count = int(w.get(self._completed_ref))  # raises errors
                if self._i > self._count:
                    raise StopIteration
                break
        ref = ObjectRef(oid_i)
        # the consumer now owns this value like any task return: lineage for
        # reconstruction, ownership for zero-ref freeing
        with w._task_lock:
            w._lineage[oid_i.binary()] = self._spec
        with w._ref_lock:
            w._owned.add(oid_i.binary())
        self._i += 1
        return ref

    @property
    def completed_ref(self) -> ObjectRef:
        """Ref of the completion marker (count; raises the task's error)."""
        return self._completed_ref
