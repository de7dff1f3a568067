"""Core worker — the in-process runtime of every driver and worker (the
port's copy of ``ray_tpu/_private/worker.py``; a task's GPU slots reach it
as ``CUDA_VISIBLE_DEVICES``).

Equivalent of the reference's CoreWorker
(reference: src/ray/core_worker/core_worker.h — task submission, put/get,
ownership bookkeeping, lineage for reconstruction; Python surface
python/ray/_private/worker.py ray.get/put/wait at :2461/:2590/:2653).

Ownership model (round-1 simplification, documented deviation): results and
errors are sealed into the shared store keyed by deterministic return
ObjectIDs, so `get` is a blocking store read; the owner keeps the task spec
(lineage) for every object it created and resubmits the creating task when
the store reports the object EVICTED (reference: object_recovery_manager.h:41
lineage reconstruction; task specs pinned via reference_count.h lineage
pinning).
"""
from __future__ import annotations

import os
import sys
import threading
import time
from concurrent.futures import Future
from typing import Any, Sequence

from ray_tpu_torch._private import object_store as osmod
from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private import task_spec as ts
from ray_tpu_torch._private.config import global_config
from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.object_ref import ObjectRef, _ErrorPayload
from ray_tpu_torch._private.object_store import ObjectStoreClient
from ray_tpu_torch._private.rpc import RpcClient
from ray_tpu_torch._private.task_spec import _RefMarker
from ray_tpu_torch.exceptions import (
    GetTimeoutError,
    ObjectLostError,
    TaskError,
)

_GET_POLL_MS = 2000  # per-attempt blocking window; between attempts we check
                     # for eviction + lineage reconstruction


class CoreWorker:
    """One per process. mode: 'driver' or 'worker'."""

    def __init__(
        self,
        *,
        mode: str,
        gcs_address: str,
        raylet_address: str,
        store_socket: str,
        job_id: JobID,
        node_id: NodeID,
        worker_id: WorkerID | None = None,
    ):
        self.mode = mode
        self.job_id = job_id
        self.node_id = node_id
        self.worker_id = worker_id or WorkerID.from_random()
        self.task_id = TaskID.for_driver(job_id)  # current task context
        self.store = ObjectStoreClient(store_socket)
        # auto_reconnect: the GCS may restart in place (GCS FT) — the raylet
        # heals its own client in its heartbeat loop; the worker's client
        # must heal too or actor resolution and task events latch dead
        self.gcs = RpcClient(
            gcs_address, notify_handler=self._on_notify, auto_reconnect=True
        )
        self.raylet = RpcClient(raylet_address, notify_handler=self._on_notify)
        self._put_counter = 0
        self._task_lock = threading.Lock()
        # lineage: object_id bytes -> creating task spec (owner-side),
        # LRU-bounded (reference bounds this via lineage ref-counting,
        # reference_count.h lineage pinning; here oldest entries age out and
        # their objects simply become non-reconstructible)
        from collections import OrderedDict

        self._lineage: "OrderedDict[bytes, dict]" = OrderedDict()
        self._lineage_cap = 100_000
        self._inflight_resubmits: set[bytes] = set()
        # ---- ownership & local reference counting ----
        # (reference: reference_count.h:61-115 — local refs per ObjectRef
        # instance, submitted-task argument references, lineage pinned for
        # live refs, zero refs on the owner → free copies cluster-wide)
        self._ref_lock = threading.RLock()  # RLock: __del__ may re-enter
        self._local_refs: dict[bytes, int] = {}
        self._owned: set[bytes] = set()  # oids created by this worker's
        #                                  puts/submits (it may free them)
        self._dep_holds: dict[bytes, int] = {}  # arg refs of in-flight tasks
        self._task_dep_holds: dict[bytes, list[bytes]] = {}  # task -> deps
        # actor bookkeeping (submitter side)
        self._actor_seqnos: dict[bytes, int] = {}
        self._actor_raylet: dict[bytes, str] = {}  # actor_id -> raylet addr
        self._actor_raylet_clients: dict[str, RpcClient] = {}
        self._notify_handlers: dict[str, list] = {}
        self._current_gpus: list[int] = []
        # the GPU slots ("0,1") this process initialized CUDA under (None:
        # not yet); CUDA reads CUDA_VISIBLE_DEVICES once, so they bind it
        self._cuda_devices: str | None = None
        # the node's own CUDA_VISIBLE_DEVICES (None: every card): GPU slot
        # i of an assignment is its i-th entry
        base = os.environ.get("CUDA_VISIBLE_DEVICES")
        self._device_ids = (None if base is None else
                            [d.strip() for d in base.split(",") if d.strip()])
        self.current_actor_id: ActorID | None = None
        from ray_tpu_torch._private.task_events import TaskEventBuffer

        self.task_events = TaskEventBuffer(
            self.gcs, self.worker_id.hex(), node_id.hex()
        )
        self._stopped = threading.Event()
        threading.Thread(
            target=self._dep_hold_sweep_loop, daemon=True, name="dep-hold-sweep"
        ).start()

    # ---------------- notifications ----------------

    def _on_notify(self, topic: str, payload: Any) -> None:
        for h in self._notify_handlers.get(topic, []):
            h(payload)
        for h in self._notify_handlers.get("*", []):
            h(topic, payload)

    def add_notify_handler(self, topic: str, handler) -> None:
        self._notify_handlers.setdefault(topic, []).append(handler)

    # ---------------- reference counting ----------------

    def add_local_ref(self, oid: bytes) -> None:
        with self._ref_lock:
            self._local_refs[oid] = self._local_refs.get(oid, 0) + 1

    def remove_local_ref(self, oid: bytes) -> None:
        free = False
        with self._ref_lock:
            n = self._local_refs.get(oid, 0) - 1
            if n > 0:
                self._local_refs[oid] = n
            else:
                self._local_refs.pop(oid, None)
                if n == 0 and oid in self._owned and not self._dep_holds.get(oid):
                    self._owned.discard(oid)
                    free = True
        if free:
            self._free_object(oid)

    def _add_dep_holds(self, task_id: bytes, deps: list[bytes]) -> None:
        """Pin task arguments until the task is observed complete — a ref
        the user dropped must survive for the task that consumes it
        (reference: submitted-task references in reference_count.h)."""
        if not deps:
            return
        with self._ref_lock:
            self._task_dep_holds.setdefault(task_id, []).extend(deps)
            for d in deps:
                self._dep_holds[d] = self._dep_holds.get(d, 0) + 1

    def _release_task_dep_holds(self, task_id: bytes) -> None:
        """Called when a task's result is observed (its deps are consumed)."""
        with self._ref_lock:
            deps = self._task_dep_holds.pop(task_id, None)
        if not deps:
            return
        to_free = []
        with self._ref_lock:
            for d in deps:
                n = self._dep_holds.get(d, 0) - 1
                if n > 0:
                    self._dep_holds[d] = n
                else:
                    self._dep_holds.pop(d, None)
                    if (
                        n == 0
                        and not self._local_refs.get(d)
                        and d in self._owned
                    ):
                        self._owned.discard(d)
                        to_free.append(d)
        for d in to_free:
            self._free_object(d)

    def _free_object(self, oid: bytes) -> None:
        """Zero references on the owner: release copies cluster-wide."""
        try:
            self.gcs.call_async("free_object", {"object_id": oid})
        except Exception:  # noqa: BLE001 — shutting down
            pass

    def _dep_hold_sweep_loop(self) -> None:
        """Fire-and-forget tasks are never observed via get()/wait(); their
        argument holds would pin objects forever. Lazily ask the directory
        whether each held task's first return has ever been sealed (or
        freed) and release the holds then."""
        while not self._stopped.wait(5.0):
            with self._ref_lock:
                held = list(self._task_dep_holds)
            for task_id in held:
                oid = ObjectID.for_task_return(TaskID(task_id), 0)
                try:
                    r = self.gcs.call(
                        "get_object_locations", {"object_id": oid.binary()}
                    )
                except Exception:  # noqa: BLE001 — GCS restarting
                    break
                if r.get("known"):
                    self._release_task_dep_holds(task_id)

    # ---------------- object API ----------------

    def put(self, value: Any) -> ObjectRef:
        with self._task_lock:
            self._put_counter += 1
            oid = ObjectID.for_put(self.task_id, self._put_counter)
        self.put_object(oid, value)
        with self._ref_lock:
            self._owned.add(oid.binary())
        return ObjectRef(oid)

    def put_object(self, oid: ObjectID, value: Any, pin: bool = True) -> None:
        chunks = ser.serialize(value)
        size = ser.serialized_size(chunks)
        try:
            buf = self.store.create(oid, size)
        except ValueError:
            # Already exists: a retried task re-putting under the same
            # deterministic id (its crashed predecessor sealed it first) —
            # idempotent success, keep the existing object.
            return
        try:
            ser.write_chunks(chunks, buf)
            # primary copy: pinned atomically at seal so eviction can never
            # lose an object whose owner still holds references; the raylet
            # unpins it when the owner's refs hit zero (free_object).
            # pin=False (streamed values): nobody may ever claim the ref, so
            # they stay LRU-evictable and recover via lineage if consumed.
            self.store.seal(oid, pin=pin)
        except BaseException:
            self.store.discard_pending(oid)
            raise

    def get(self, refs: ObjectRef | Sequence[ObjectRef], timeout: float | None = None):
        single = isinstance(refs, ObjectRef)
        ref_list = [refs] if single else list(refs)
        deadline = None if timeout is None else time.monotonic() + timeout
        values = [self._get_one(r, deadline) for r in ref_list]
        return values[0] if single else values

    def _maybe_fetch(self, oid: ObjectID, status: str | None = None) -> str | None:
        """If the object is not in the LOCAL store, ask the raylet to pull it
        from a peer node's store (reference: ray.get triggers the raylet's
        PullManager for remote plasma objects). Pass `status` when the caller
        already polled the local store to save the duplicate round-trip.
        Returns the raylet's fetch status ('fetching'|'evicted'|'unknown'|
        'present') or None when no fetch is needed/possible."""
        try:
            st = status if status is not None else self.store.status(oid)
            if st == "present":
                return None
            # "missing" AND "evicted" both go to the raylet: a local
            # tombstone may hide a live copy on another node
            r = self.raylet.call("fetch_object", {"object_id": oid.binary()})
            return r.get("status")
        except Exception:  # noqa: BLE001 — raylet unreachable; keep polling
            return None

    def _get_one(self, ref: ObjectRef, deadline: float | None):
        oid = ref.object_id
        reconstruct_attempts = 0
        if self._maybe_fetch(oid) == "evicted":
            # evicted cluster-wide before we ever saw it
            self._reconstruct(oid)
            time.sleep(0.05)
        while True:
            remaining_ms = _GET_POLL_MS
            if deadline is not None:
                left = (deadline - time.monotonic()) * 1000
                if left <= 0:
                    raise GetTimeoutError(f"get({ref}) timed out")
                remaining_ms = min(remaining_ms, max(1, int(left)))
            try:
                view = self.store.get(oid, timeout_ms=remaining_ms)
            except GetTimeoutError:
                if self._maybe_fetch(oid) == "evicted":
                    self._reconstruct(oid)
                    time.sleep(0.05)
                continue
            if view is osmod.EVICTED:
                # prefer re-pulling a live copy from another node over
                # re-executing the creating task
                st = self._maybe_fetch(oid, status="evicted")
                if st in ("fetching", "present"):
                    time.sleep(0.01)
                    continue
                self._reconstruct(oid)
                # the resubmitted task needs time to run; don't hammer the
                # store socket while it does
                time.sleep(0.05)
                continue
            if view is None:
                continue
            value = ser.deserialize(view)
            if isinstance(value, _ErrorPayload):
                err = value.error
                if (
                    isinstance(err, ObjectLostError)
                    and oid.binary() in self._lineage
                    and reconstruct_attempts < 3
                ):
                    # NOTE: dep holds are NOT released on this branch — the
                    # resubmitted task still needs its argument objects
                    # A dependency of the creating task was evicted and the
                    # raylet failed the task; clear the error payloads and
                    # re-run the lineage (deps reconstructed recursively).
                    reconstruct_attempts += 1
                    spec = self._lineage[oid.binary()]
                    for ret_oid in ts.return_object_ids(spec):
                        self.store.release(ret_oid)
                        self.store.delete(ret_oid)
                    self._reconstruct(oid)
                    time.sleep(0.05)
                    continue
                # terminal error: the creating task is done for good — its
                # argument references can be released
                self._release_task_dep_holds(oid.task_id().binary())
                if isinstance(err, TaskError) and err.cause is not None:
                    raise err.cause from None
                raise err
            # real result observed: the creating task finished
            self._release_task_dep_holds(oid.task_id().binary())
            return value

    def _reconstruct(self, oid: ObjectID) -> None:
        """Resubmit the creating task for an evicted object (lineage
        reconstruction). Recurses through evicted dependencies."""
        spec = self._lineage.get(oid.binary())
        if spec is None:
            raise ObjectLostError(
                f"object {oid} was evicted and this process has no lineage for it"
            )
        key = spec["task_id"]
        with self._task_lock:
            if key in self._inflight_resubmits:
                return
            self._inflight_resubmits.add(key)
        try:
            for dep in spec["arg_deps"]:
                dep_oid = ObjectID(dep)
                # status() rather than get(): our own cached mapping of the
                # dep doesn't help the executing worker — the store must
                # actually hold it again
                if self.store.status(dep_oid) == "evicted":
                    self._reconstruct(dep_oid)
            self.raylet.call("submit_task", {"spec": dict(spec)})
        finally:
            # allow future reconstructions once this one lands
            def _clear():
                time.sleep(1.0)
                with self._task_lock:
                    self._inflight_resubmits.discard(key)

            threading.Thread(target=_clear, daemon=True).start()

    def wait(
        self,
        refs: Sequence[ObjectRef],
        *,
        num_returns: int = 1,
        timeout: float | None = None,
    ) -> tuple[list[ObjectRef], list[ObjectRef]]:
        if num_returns > len(refs):
            raise ValueError("num_returns exceeds number of refs")
        deadline = None if timeout is None else time.monotonic() + timeout
        pending = list(refs)
        ready: list[ObjectRef] = []
        # trigger remote pulls BEFORE the first blocking window: a short
        # (or zero) timeout must still initiate fetches or repeated polls
        # of a remote object would never make progress
        for r in pending:
            self._maybe_fetch(r.object_id)
        while True:
            # one BLOCKING store-side wait per window (the daemon's seal cv
            # wakes us the instant an object lands — no busy-polling); the
            # window bounds how often we re-trigger fetches of objects that
            # live on other nodes
            window_ms = 200
            if deadline is not None:
                left_ms = int((deadline - time.monotonic()) * 1000)
                if left_ms <= 0:
                    window_ms = 0
                else:
                    window_ms = min(window_ms, left_ms)
            present = self.store.wait_objects(
                [r.object_id for r in pending],
                max(1, num_returns - len(ready)),
                timeout_ms=window_ms,
            )
            for r in list(pending):
                if r.object_id.binary() in present:
                    ready.append(r)
                    pending.remove(r)
                    # observed completion releases the task's argument refs
                    # (same as get(); fire-and-forget is swept lazily)
                    self._release_task_dep_holds(r.object_id.task_id().binary())
            if len(ready) >= num_returns:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            for r in pending:
                self._maybe_fetch(r.object_id)
        return ready, pending

    def as_future(self, ref: ObjectRef) -> Future:
        fut: Future = Future()

        def waiter():
            try:
                fut.set_result(self.get(ref))
            except Exception as e:
                fut.set_exception(e)

        threading.Thread(target=waiter, daemon=True).start()
        return fut

    # ---------------- task submission ----------------

    def new_task_id(self) -> TaskID:
        return TaskID.for_task(self.job_id)

    def submit_task(self, spec: dict) -> list[ObjectRef]:
        """Submit a normal or actor-creation task to the local raylet."""
        refs = [ObjectRef(o) for o in ts.return_object_ids(spec)]
        self.task_events.record(
            task_id=spec["task_id"], job_id=spec["job_id"], name=spec["name"],
            event="SUBMITTED", task_type=spec["type"],
        )
        with self._ref_lock:
            self._owned.update(r.object_id.binary() for r in refs)
        self._add_dep_holds(spec["task_id"], list(spec["arg_deps"]))
        with self._task_lock:
            for r in refs:
                self._lineage[r.object_id.binary()] = spec
            self._trim_lineage_locked()
        self.raylet.call("submit_task", {"spec": spec})
        return refs

    def _trim_lineage_locked(self) -> None:
        """LRU-bound the lineage, but PIN entries whose objects still have
        live references — those must stay reconstructible (reference:
        lineage pinning, reference_count.h:67-115)."""
        attempts = len(self._lineage)
        while len(self._lineage) > self._lineage_cap and attempts > 0:
            attempts -= 1
            oid, spec = self._lineage.popitem(last=False)
            with self._ref_lock:
                live = any(
                    self._local_refs.get(r.binary())
                    or self._dep_holds.get(r.binary())
                    for r in ts.return_object_ids(spec)
                )
            if live:
                self._lineage[oid] = spec  # reinsert at the fresh end

    def submit_actor_task(self, spec: dict, raylet_address: str | None) -> list[ObjectRef]:
        refs = [ObjectRef(o) for o in ts.return_object_ids(spec)]
        # actor tasks get the same SUBMITTED timeline event as normal tasks
        # (reference: task_events cover every task type; without this the
        # state API showed actor calls springing into RUNNING from nowhere)
        self.task_events.record(
            task_id=spec["task_id"], job_id=spec["job_id"], name=spec["name"],
            event="SUBMITTED", task_type=spec["type"],
        )
        with self._ref_lock:
            self._owned.update(r.object_id.binary() for r in refs)
        self._add_dep_holds(spec["task_id"], list(spec["arg_deps"]))
        client = self.raylet
        if raylet_address and raylet_address != self.raylet.address:
            client = self._peer(raylet_address)
        client.call("submit_task", {"spec": spec})
        return refs

    def _peer(self, address: str) -> RpcClient:
        c = self._actor_raylet_clients.get(address)
        if c is None:
            c = RpcClient(address)
            self._actor_raylet_clients[address] = c
        return c

    def next_actor_seqno(self, actor_id: ActorID) -> int:
        with self._task_lock:
            n = self._actor_seqnos.get(actor_id.binary(), 0)
            self._actor_seqnos[actor_id.binary()] = n + 1
            return n

    def actor_raylet_address(self, actor_id: ActorID, timeout: float = None) -> str:
        """Resolve (and cache) which raylet hosts the actor."""
        cfg = global_config()
        timeout = timeout if timeout is not None else cfg.actor_creation_timeout_s
        cached = self._actor_raylet.get(actor_id.binary())
        if cached:
            return cached
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            r = self.gcs.call("get_actor", {"actor_id": actor_id.binary()})
            actor = r["actor"]
            if actor and actor["state"] == "ALIVE" and actor["raylet_address"]:
                self._actor_raylet[actor_id.binary()] = actor["raylet_address"]
                return actor["raylet_address"]
            if actor and actor["state"] == "DEAD":
                from ray_tpu_torch.exceptions import ActorDiedError

                raise ActorDiedError(actor_id.hex(), "actor is dead")
            time.sleep(0.02)
        raise TimeoutError(f"actor {actor_id} not ALIVE within {timeout}s")

    def invalidate_actor_cache(self, actor_id: ActorID) -> None:
        self._actor_raylet.pop(actor_id.binary(), None)

    # ---------------- task execution (worker mode) ----------------

    # method thread pool for max_concurrency > 1 actors (reference:
    # threaded actors via concurrency_group_manager.cc); created at
    # actor creation, None for ordinary serial actors
    _method_pool = None

    def execute_task(self, spec: dict, gpus: list[int]) -> None:
        """Run one task and seal its results. Called on the worker's
        execution thread (reference: _raylet.pyx:1457 execute_task)."""
        if spec["type"] == ts.ACTOR_TASK and self._method_pool is not None:
            # concurrent actor: methods overlap on the pool; shared task
            # context (task_id, GPU env) stays that of the creation task
            self._method_pool.submit(self._execute_actor_method_concurrent, spec)
            return
        if spec["type"] != ts.ACTOR_TASK:
            # an actor's methods keep its creation task's assignment
            slots = ",".join(str(g) for g in gpus)
            if gpus and self._cuda_devices not in (None, slots):
                self._refuse_gpu_task(spec, slots)
                return
            ids = self._device_ids
            os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(
                ids[g] if ids and g < len(ids) else str(g) for g in gpus)
            self._current_gpus = gpus
        os.environ["RT_TASK_RESOURCES"] = repr(spec["resources"])
        prev_task = self.task_id
        self.task_id = TaskID(spec["task_id"])
        self.task_events.record(
            task_id=spec["task_id"], job_id=spec["job_id"], name=spec["name"],
            event="RUNNING", task_type=spec["type"],
        )
        self._last_task_failed = False
        from ray_tpu_torch._private.runtime_env import applied_runtime_env

        from ray_tpu_torch.util.tracing import task_span

        try:
            with applied_runtime_env(
                spec.get("runtime_env"),
                permanent=spec["type"] == ts.ACTOR_CREATION,
            ), task_span(spec):
                if spec["type"] == ts.ACTOR_CREATION:
                    self._execute_actor_creation(spec)
                elif spec["type"] == ts.ACTOR_TASK:
                    self._execute_actor_method(spec)
                else:
                    self._execute_normal(spec)
        finally:
            self.task_events.record(
                task_id=spec["task_id"], job_id=spec["job_id"],
                name=spec["name"],
                event="FAILED" if self._last_task_failed else "FINISHED",
                task_type=spec["type"],
            )
            self.task_id = prev_task
            done = {"task_id": spec["task_id"]}
            if self._cuda_bound():
                done["cuda_devices"] = self._cuda_devices
            self.raylet.call("task_done", done)

    def _cuda_bound(self) -> bool:
        """Whether this process has initialized CUDA; the first time it is
        seen, the GPU slots in effect are recorded as its binding."""
        if self._cuda_devices is None:
            # a thread of this process (an actor's, started by its
            # __init__) may be importing torch right now: a module without
            # its ``cuda`` yet has not initialized CUDA
            cuda = getattr(sys.modules.get("torch"), "cuda", None)
            if cuda is None or not cuda.is_initialized():
                return False
            self._cuda_devices = ",".join(str(g) for g in self._current_gpus)
        return True

    def _refuse_gpu_task(self, spec: dict, slots: str) -> None:
        """A GPU task assigned other cards than the ones this process's
        CUDA was made under would run on the wrong card: fail it loudly."""
        self._store_error(spec, RuntimeError(
            f"task {spec['name']} was assigned GPU slots {slots!r}, but "
            f"this worker initialized CUDA under slots "
            f"{self._cuda_devices!r}; CUDA reads CUDA_VISIBLE_DEVICES once"))
        self.raylet.call("task_done", {"task_id": spec["task_id"],
                                       "cuda_devices": self._cuda_devices})

    def _resolve_args(self, spec: dict) -> tuple[tuple, dict]:
        args, kwargs = ser.deserialize(spec["args_blob"])

        def resolve(v):
            if isinstance(v, _RefMarker):
                return self._get_one(ObjectRef(ObjectID(v.object_id_bytes)), None)
            return v

        return tuple(resolve(a) for a in args), {k: resolve(v) for k, v in kwargs.items()}

    def _store_returns(self, spec: dict, result: Any) -> None:
        n = spec["num_returns"]
        oids = ts.return_object_ids(spec)
        if n == 1:
            values = [result]
        else:
            values = list(result)
            if len(values) != n:
                raise ValueError(
                    f"task {spec['name']} declared num_returns={n} but returned "
                    f"{len(values)} values"
                )
        for oid, v in zip(oids, values):
            try:
                self.put_object(oid, v)
            except ValueError:
                pass  # duplicate execution (retry landed first) — keep first

    _last_task_failed = False

    def _store_error(self, spec: dict, exc: Exception) -> None:
        self._last_task_failed = True
        err = TaskError.from_exception(spec["name"], exc)
        for oid in ts.return_object_ids(spec):
            try:
                self.put_object(oid, _ErrorPayload(err))
            except ValueError:
                pass

    _function_cache: dict[bytes, Any] = {}

    def _load_function(self, spec: dict):
        fid = spec["function_id"]
        fn = self._function_cache.get(fid)
        if fn is None:
            desc = spec.get("function_desc")
            if spec.get("function_blob"):
                fn = ts.loads_function(spec["function_blob"])
            elif desc:
                # cross-language submission: "module:callable" descriptor
                # instead of a pickled blob (reference:
                # function_descriptor.h PythonFunctionDescriptor)
                import importlib

                mod_name, _, attr = desc.partition(":")
                fn = getattr(importlib.import_module(mod_name), attr)
            else:
                raise ValueError(
                    f"task {spec['name']} has neither function_blob nor "
                    f"function_desc")
            self._function_cache[fid] = fn
        return fn

    def _execute_normal(self, spec: dict) -> None:
        try:
            fn = self._load_function(spec)
            args, kwargs = self._resolve_args(spec)
            if spec.get("streaming"):
                self._execute_streaming(spec, fn, args, kwargs)
                return
            result = fn(*args, **kwargs)
            self._store_returns(spec, result)
        except Exception as e:  # noqa: BLE001 — user code may raise anything
            self._store_error(spec, e)

    def _execute_streaming(self, spec: dict, fn, args, kwargs) -> None:
        """Generator task: seal each yielded value as return index i (the
        consumer's ObjectRefGenerator streams them), then the completion
        marker (count) at index 0 — errors seal into index 0 instead."""
        tid = TaskID(spec["task_id"])
        try:
            n = 0
            for value in fn(*args, **kwargs):
                n += 1
                # unpinned: an unclaimed streamed value must not stay pinned
                # forever — it is LRU-evictable and lineage-recoverable
                self.put_object(ObjectID.for_task_return(tid, n), value, pin=False)
            self._store_returns(spec, n)
        except Exception as e:  # noqa: BLE001
            self._store_error(spec, e)

    # actor instance lives on the worker singleton
    actor_instance: Any = None

    def _execute_actor_creation(self, spec: dict) -> None:
        try:
            cls = self._load_function(spec)
            args, kwargs = self._resolve_args(spec)
            self.actor_instance = cls(*args, **kwargs)
            self.current_actor_id = ActorID(spec["actor_id"])
            n = int(spec.get("max_concurrency", 1) or 1)
            if n > 1:
                from concurrent.futures import ThreadPoolExecutor

                self._method_pool = ThreadPoolExecutor(
                    max_workers=n, thread_name_prefix="actor-method"
                )
            self._store_returns(spec, None)
            self.raylet.call(
                "actor_started",
                {"actor_id": spec["actor_id"], "worker_id": self.worker_id.binary()},
            )
        except Exception as e:  # noqa: BLE001
            self._store_error(spec, e)
            # record the terminal event NOW: os._exit skips every finally
            # and the buffer's flush thread
            self.task_events.record(
                task_id=spec["task_id"], job_id=spec["job_id"],
                name=spec["name"], event="FAILED", task_type=spec["type"],
            )
            self.task_events.stop()
            # leave the actor unstarted; raylet worker-death/timeout paths
            # surface the failure to callers
            os._exit(1)

    def _execute_actor_method(self, spec: dict) -> None:
        try:
            method = getattr(self.actor_instance, spec["method_name"])
            args, kwargs = self._resolve_args(spec)
            if spec.get("streaming"):
                self._execute_streaming(spec, method, args, kwargs)
                return
            result = method(*args, **kwargs)
            self._store_returns(spec, result)
        except Exception as e:  # noqa: BLE001
            self._store_error(spec, e)

    def _execute_actor_method_concurrent(self, spec: dict) -> None:
        """One method on the concurrency pool. Self-contained: no shared
        task-context mutation (other methods are running), its own events,
        its own task_done."""
        self.task_events.record(
            task_id=spec["task_id"], job_id=spec["job_id"], name=spec["name"],
            event="RUNNING", task_type=spec["type"],
        )
        from ray_tpu_torch.util.tracing import task_span

        failed = False
        try:
            method = getattr(self.actor_instance, spec["method_name"])
            args, kwargs = self._resolve_args(spec)
            # task_span: concurrent methods run on pool threads, so each
            # gets its own contextvar scope — a submitter's trace context
            # propagates into streaming replica methods (serve/llm) exactly
            # as it does on the serial path
            with task_span(spec):
                if spec.get("streaming"):
                    # _execute_streaming seals its own error marker, so the
                    # FINISHED/FAILED event below reports FINISHED; the
                    # consumer still sees the error through the completion
                    # marker
                    self._execute_streaming(spec, method, args, kwargs)
                else:
                    result = method(*args, **kwargs)
                    self._store_returns(spec, result)
        except Exception as e:  # noqa: BLE001 — user code may raise anything
            failed = True
            self._store_error(spec, e)
        self.task_events.record(
            task_id=spec["task_id"], job_id=spec["job_id"], name=spec["name"],
            event="FAILED" if failed else "FINISHED", task_type=spec["type"],
        )
        try:
            self.raylet.call("task_done", {"task_id": spec["task_id"]})
        except Exception:  # noqa: BLE001 — raylet shutting down
            pass

    # ---------------- shutdown ----------------

    def shutdown(self) -> None:
        self._stopped.set()
        self.task_events.stop()
        for c in self._actor_raylet_clients.values():
            c.close()
        self.gcs.close()
        self.raylet.close()
        self.store.close()


_global_worker: CoreWorker | None = None
_global_lock = threading.Lock()


def set_global_worker(w: CoreWorker | None) -> None:
    global _global_worker
    from ray_tpu_torch._private import object_ref as _or

    with _global_lock:
        _global_worker = w
        if w is None:
            _or._on_ref_created = None
            _or._on_ref_deleted = None
        else:
            _or._on_ref_created = w.add_local_ref
            _or._on_ref_deleted = w.remove_local_ref


def global_worker() -> CoreWorker:
    if _global_worker is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called in this process")
    return _global_worker


def global_worker_or_none() -> CoreWorker | None:
    return _global_worker
