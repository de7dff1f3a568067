"""@ray_tpu_torch.remote functions (the port's copy of
``ray_tpu/remote_function.py``; ``num_gpus`` claims whole cards: a
fraction raises ``ValueError``).

Equivalent of the reference's RemoteFunction
(reference: python/ray/remote_function.py:40, _remote at :257 — wraps the
user function, pickles it once, builds TaskSpecs per call, supports
.options(...) overrides).
"""
from __future__ import annotations

from typing import Any

from ray_tpu_torch._private import task_spec as ts
from ray_tpu_torch._private.worker import global_worker


class RemoteFunction:
    def __init__(self, func, *, num_cpus=1, num_gpus=0, num_returns=1,
                 max_retries=0, resources=None, scheduling_strategy=None,
                 runtime_env=None, name=None):
        self._function = func
        self._name = name or getattr(func, "__name__", "anonymous")
        self._function_blob = ts.dumps_function(func)
        self._num_returns = num_returns
        self._max_retries = max_retries
        self._resources = dict(resources or {})
        if num_cpus is not None:
            self._resources.setdefault("CPU", float(num_cpus))
        if num_gpus:
            self._resources["GPU"] = float(num_gpus)
        ts.check_whole_gpus(self._resources)
        self._scheduling_strategy = scheduling_strategy
        from ray_tpu_torch._private.runtime_env import validate_runtime_env

        validate_runtime_env(runtime_env)
        self._runtime_env = runtime_env

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self._name}' cannot be called directly; "
            f"use {self._name}.remote(...)"
        )

    def options(self, **opts) -> "RemoteFunction":
        clone = RemoteFunction.__new__(RemoteFunction)
        clone.__dict__.update(self.__dict__)
        if "num_returns" in opts:
            clone._num_returns = opts["num_returns"]
        if "max_retries" in opts:
            clone._max_retries = opts["max_retries"]
        if "name" in opts:
            clone._name = opts["name"]
        if "scheduling_strategy" in opts:
            clone._scheduling_strategy = opts["scheduling_strategy"]
        if "runtime_env" in opts:
            from ray_tpu_torch._private.runtime_env import validate_runtime_env

            validate_runtime_env(opts["runtime_env"])
            clone._runtime_env = opts["runtime_env"]
        res = dict(clone._resources)
        if "num_cpus" in opts:
            res["CPU"] = float(opts["num_cpus"])
        if "num_gpus" in opts:
            res["GPU"] = float(opts["num_gpus"])
        if "resources" in opts:
            res.update(opts["resources"])
        clone._resources = ts.check_whole_gpus(res)
        return clone

    def remote(self, *args, **kwargs):
        worker = global_worker()
        placement, scheduling = _strategy_fields(self._scheduling_strategy)
        streaming = self._num_returns == "streaming"
        spec = ts.make_task_spec(
            task_id=worker.new_task_id(),
            job_id=worker.job_id,
            name=self._name,
            task_type=ts.NORMAL,
            function_blob=self._function_blob,
            args=args,
            kwargs=kwargs,
            num_returns=1 if streaming else self._num_returns,
            streaming=streaming,
            resources=self._resources,
            max_retries=self._max_retries,
            placement=placement,
            scheduling=scheduling,
            runtime_env=self._runtime_env,
        )
        from ray_tpu_torch.util.tracing import current_context

        trace_ctx = current_context()
        if trace_ctx is not None:
            spec["trace_ctx"] = trace_ctx
        refs = worker.submit_task(spec)
        if streaming:
            from ray_tpu_torch._private.generator import ObjectRefGenerator

            return ObjectRefGenerator(refs[0], spec)
        return refs[0] if self._num_returns == 1 else refs


def _strategy_fields(strategy: Any) -> tuple[dict | None, dict]:
    """Translate a scheduling-strategy object into spec fields."""
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
        PlacementGroupSchedulingStrategy,
    )

    if strategy is None:
        return None, {"type": ts.SCHED_DEFAULT}
    if strategy == "SPREAD":
        return None, {"type": ts.SCHED_SPREAD}
    if strategy == "DEFAULT":
        return None, {"type": ts.SCHED_DEFAULT}
    if isinstance(strategy, PlacementGroupSchedulingStrategy):
        return (
            {
                "pg": strategy.placement_group.id.binary(),
                "bundle": strategy.placement_group_bundle_index,
            },
            {"type": ts.SCHED_DEFAULT},
        )
    if isinstance(strategy, NodeAffinitySchedulingStrategy):
        return None, {
            "type": ts.SCHED_NODE_AFFINITY,
            "node_id": strategy.node_id,
            "soft": strategy.soft,
        }
    raise ValueError(f"unknown scheduling strategy: {strategy!r}")


def remote_decorator(*args, **kwargs):
    """Implements @ray_tpu_torch.remote / @ray_tpu_torch.remote(**options) for both
    functions and classes (reference: python/ray/_private/worker.py:3027)."""
    from ray_tpu_torch.actor import ActorClass
    import inspect

    def wrap(target):
        if inspect.isclass(target):
            return ActorClass(target, **kwargs)
        return RemoteFunction(target, **kwargs)

    if len(args) == 1 and not kwargs and (callable(args[0]) or inspect.isclass(args[0])):
        return wrap(args[0])
    if args:
        raise TypeError("@remote accepts only keyword options")
    return wrap
