"""Actor API: ActorClass (decorated class) and ActorHandle (the port's copy
of ``ray_tpu/actor.py``; ``num_gpus`` claims whole cards for the actor's
lifetime, and a fraction raises ``ValueError``).

Equivalent of the reference's actor layer
(reference: python/ray/actor.py — ActorClass:384, ActorHandle:1025,
ActorClass._remote:667 builds the creation TaskSpec; actor method calls
become ordered actor tasks). Handles are picklable: a deserialized handle
routes through the GCS actor table to the hosting raylet.
"""
from __future__ import annotations

from typing import Any

from ray_tpu_torch._private import task_spec as ts
from ray_tpu_torch._private.config import global_config as _global_config
from ray_tpu_torch._private.ids import ActorID
from ray_tpu_torch._private.worker import global_worker
from ray_tpu_torch.exceptions import ActorDiedError


class ActorClass:
    def __init__(self, cls, *, num_cpus=1, num_gpus=0, resources=None,
                 max_restarts=None, name=None, lifetime=None,
                 scheduling_strategy=None, runtime_env=None, max_concurrency=1):
        self._cls = cls
        self._class_name = cls.__name__
        self._class_blob = ts.dumps_function(cls)
        self._resources = dict(resources or {})
        self._resources.setdefault("CPU", float(num_cpus))
        if num_gpus:
            self._resources["GPU"] = float(num_gpus)
        ts.check_whole_gpus(self._resources)
        self._max_restarts = max_restarts  # None -> cluster default at .remote()
        self._name = name
        self._lifetime = lifetime
        self._scheduling_strategy = scheduling_strategy
        from ray_tpu_torch._private.runtime_env import validate_runtime_env

        validate_runtime_env(runtime_env)
        self._runtime_env = runtime_env
        self._max_concurrency = max(1, int(max_concurrency))

    def __call__(self, *a, **k):
        raise TypeError(
            f"Actor class {self._class_name} cannot be instantiated directly; "
            f"use {self._class_name}.remote(...)"
        )

    def options(self, **opts) -> "ActorClass":
        clone = ActorClass.__new__(ActorClass)
        clone.__dict__.update(self.__dict__)
        res = dict(clone._resources)
        if "num_cpus" in opts:
            res["CPU"] = float(opts["num_cpus"])
        if "num_gpus" in opts:
            res["GPU"] = float(opts["num_gpus"])
        if "resources" in opts:
            res.update(opts["resources"])
        clone._resources = ts.check_whole_gpus(res)
        for key in ("max_restarts", "name", "lifetime", "scheduling_strategy",
                    "runtime_env", "max_concurrency"):
            if key in opts:
                setattr(clone, "_" + key, opts[key])
        clone._max_concurrency = max(1, int(clone._max_concurrency))
        if "runtime_env" in opts:
            from ray_tpu_torch._private.runtime_env import validate_runtime_env

            validate_runtime_env(clone._runtime_env)
        return clone

    def remote(self, *args, **kwargs) -> "ActorHandle":
        worker = global_worker()
        actor_id = ActorID.of(worker.job_id)
        # cluster-wide default (config.max_actor_restarts_default) when the
        # decorator didn't pin one; resolved at CREATION so a later
        # init(_system_config=...) override reaches already-decorated classes
        max_restarts = (self._max_restarts if self._max_restarts is not None
                        else _global_config().max_actor_restarts_default)
        worker.gcs.call(
            "register_actor",
            {
                "actor_id": actor_id.binary(),
                "class_name": self._class_name,
                "name": self._name,
                "max_restarts": max_restarts,
            },
        )
        from ray_tpu_torch.remote_function import _strategy_fields

        placement, scheduling = _strategy_fields(self._scheduling_strategy)
        spec = ts.make_task_spec(
            task_id=worker.new_task_id(),
            job_id=worker.job_id,
            name=f"{self._class_name}.__init__",
            task_type=ts.ACTOR_CREATION,
            function_blob=self._class_blob,
            args=args,
            kwargs=kwargs,
            num_returns=1,
            resources=self._resources,
            actor_id=actor_id,
            max_restarts=max_restarts,
            placement=placement,
            scheduling=scheduling,
            runtime_env=self._runtime_env,
            max_concurrency=self._max_concurrency,
        )
        worker.submit_task(spec)
        return ActorHandle(actor_id, self._class_name)


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str, num_returns=1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def options(self, *, num_returns=1) -> "ActorMethod":
        return ActorMethod(self._handle, self._method_name, num_returns)

    def remote(self, *args, **kwargs):
        worker = global_worker()
        h = self._handle
        raylet_addr = worker.actor_raylet_address(h._actor_id)
        # generator methods stream exactly like normal tasks (reference:
        # _raylet.pyx streaming generators work for actor tasks too)
        streaming = self._num_returns == "streaming"
        spec = ts.make_task_spec(
            task_id=ts.TaskID.for_actor_task(h._actor_id),
            job_id=worker.job_id,
            name=f"{h._class_name}.{self._method_name}",
            task_type=ts.ACTOR_TASK,
            method_name=self._method_name,
            args=args,
            kwargs=kwargs,
            num_returns=1 if streaming else self._num_returns,
            streaming=streaming,
            resources={},
            actor_id=h._actor_id,
            seqno=worker.next_actor_seqno(h._actor_id),
        )
        from ray_tpu_torch.util.tracing import current_context

        trace_ctx = current_context()
        if trace_ctx is not None:
            spec["trace_ctx"] = trace_ctx
        try:
            refs = worker.submit_actor_task(spec, raylet_addr)
        except ConnectionError:
            worker.invalidate_actor_cache(h._actor_id)
            raise ActorDiedError(h._actor_id.hex(), "raylet connection lost")
        if streaming:
            from ray_tpu_torch._private.generator import ObjectRefGenerator

            return ObjectRefGenerator(refs[0], spec)
        return refs[0] if self._num_returns == 1 else refs


class ActorHandle:
    def __init__(self, actor_id: ActorID, class_name: str = ""):
        self._actor_id = actor_id
        self._class_name = class_name

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()})"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._class_name))

    @property
    def actor_id(self) -> ActorID:
        return self._actor_id


def get_actor(name: str) -> ActorHandle:
    """Look up a named actor (reference: ray.get_actor)."""
    worker = global_worker()
    r = worker.gcs.call("get_named_actor", {"name": name})
    if r["actor_id"] is None:
        raise ValueError(f"no actor named {name!r}")
    return ActorHandle(ActorID(r["actor_id"]), r["actor"].get("class_name", ""))


def kill(handle: ActorHandle) -> None:
    """Forcefully terminate an actor (reference: ray.kill)."""
    worker = global_worker()
    try:
        addr = worker.actor_raylet_address(handle._actor_id, timeout=5)
    except (TimeoutError, ActorDiedError):
        return
    client = worker._peer(addr) if addr != worker.raylet.address else worker.raylet
    client.call("kill_actor", {"actor_id": handle._actor_id.binary()})
    worker.invalidate_actor_cache(handle._actor_id)
