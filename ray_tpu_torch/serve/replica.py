"""Replica actor wrapper around the user's deployment callable (the
port's copy of ``ray_tpu/serve/replica.py``).

Equivalent of the reference's RayServeReplica
(reference: python/ray/serve/_private/replica.py — user-code wrapper actor;
health check + reconfigure surface). The wrapper resolves deployment-handle
placeholder args (model composition), dispatches plain and batched calls,
and reports lifecycle state.
"""
from __future__ import annotations

import inspect
import threading
import time
from concurrent.futures import Future
from typing import Any

import ray_tpu_torch
from ray_tpu_torch._private import task_spec as ts
from ray_tpu_torch.serve.batching import get_batch_config, pad_to_bucket
from ray_tpu_torch.util import metrics


class _ReplicaBatchQueue:
    """REPLICA-side batch coalescing (reference: serve/batching.py:337
    _BatchQueue — all callers of a replica share ONE queue, so requests from
    different driver/proxy processes batch together). Shape-aware
    addition: batches pad to fixed size buckets so a model step sees a
    closed set of shapes. Caller method-threads park in submit() while
    sibling concurrent calls (max_ongoing_requests method pool) fill the
    batch; the thread that completes a batch (or the wait timer) flushes."""

    def __init__(self, fn, config):
        self._fn = fn
        self._config = config
        self._max_batch = config.max_batch_size
        if config.size_buckets:
            # a batch may never exceed the largest bucket or padding breaks
            self._max_batch = min(self._max_batch, config.size_buckets[-1])
        self._lock = threading.Lock()
        self._pending: list[tuple[Any, Future]] = []
        self._timer: threading.Timer | None = None

    def submit(self, payload: Any):
        fut: Future = Future()
        flush_now = None
        with self._lock:
            self._pending.append((payload, fut))
            if len(self._pending) >= self._max_batch:
                flush_now = self._take_locked()
            elif self._timer is None:
                self._timer = threading.Timer(
                    self._config.batch_wait_timeout_s, self._flush_timeout
                )
                self._timer.daemon = True
                self._timer.start()
        if flush_now:
            self._flush(flush_now)
        return fut.result()  # parks this method thread until the batch runs

    def _take_locked(self):
        items, self._pending = self._pending, []
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        return items

    def _flush_timeout(self) -> None:
        with self._lock:
            items = self._take_locked()
        if items:
            self._flush(items)

    def _flush(self, items) -> None:
        payloads = [p for p, _ in items]
        n = len(payloads)
        if self._config.size_buckets:
            target = pad_to_bucket(n, self._config.size_buckets)
            payloads = payloads + [None] * (target - n)
        try:
            results = self._fn(payloads)
            if self._config.size_buckets:
                results = list(results)[:n]  # strip padding results
            if len(results) != n:
                raise ValueError(
                    f"batched method returned {len(results)} results for "
                    f"{n} inputs"
                )
        except Exception as e:  # noqa: BLE001 — fan the error out per call
            for _, f in items:
                f.set_exception(e)
            return
        for (_, f), r in zip(items, results):
            f.set_result(r)


class HandleArg:
    """Placeholder for a DeploymentHandle argument, resolved replica-side
    (model composition: Model.bind(other_app) — reference:
    serve/_private/deployment_graph_build.py)."""

    def __init__(self, deployment_name: str, app_name: str):
        self.deployment_name = deployment_name
        self.app_name = app_name


def _resolve_handle_args(value):
    from ray_tpu_torch.serve.handle import DeploymentHandle

    if isinstance(value, HandleArg):
        return DeploymentHandle(value.deployment_name, value.app_name)
    if isinstance(value, (list, tuple)):
        return type(value)(_resolve_handle_args(v) for v in value)
    if isinstance(value, dict):
        return {k: _resolve_handle_args(v) for k, v in value.items()}
    return value


class ReplicaActor:
    """One serving replica. Created by the controller with the serialized
    user callable and its bind arguments (read here, never in the
    controller); methods are invoked by routers via rt_call.
    The replica actor runs up to max_ongoing_requests methods concurrently
    on its worker's method pool (reference: async replicas bounded by
    max_ongoing_requests), so I/O-bound callables overlap; a GPU-bound
    model still serializes on the card itself."""

    def __init__(
        self,
        deployment_name: str,
        callable_blob: bytes,
        init_blob: bytes,
        user_config: dict | None = None,
        max_ongoing_requests: int = 8,
    ):
        self.deployment_name = deployment_name
        self._max_ongoing = max(1, int(max_ongoing_requests))
        factory = ts.loads_function(callable_blob)
        init_args, init_kwargs = ts.loads_function(init_blob)
        init_args = _resolve_handle_args(init_args)
        init_kwargs = _resolve_handle_args(init_kwargs)
        if inspect.isclass(factory):
            self._instance = factory(*init_args, **init_kwargs)
            self._is_function = False
        else:
            self._instance = factory
            self._is_function = True
        if user_config is not None:
            self.reconfigure(user_config)
        self._batch_queues: dict[str, "_ReplicaBatchQueue"] = {}

    # -- control surface --

    def ping(self) -> str:
        """Liveness probe (reference: replica health check)."""
        check = getattr(self._instance, "check_health", None)
        if check is not None and not self._is_function:
            check()
        return "ok"

    def reconfigure(self, user_config: dict) -> None:
        fn = getattr(self._instance, "reconfigure", None)
        if fn is not None:
            fn(user_config)

    def batch_configs(self) -> dict[str, dict]:
        """method name -> BatchConfig fields, discovered from markers."""
        out = {}
        target = self._instance if not self._is_function else None
        if target is None:
            cfg = get_batch_config(self._instance)
            if cfg is not None:
                out["__call__"] = cfg.__dict__
            return out
        for name, member in inspect.getmembers(target, callable):
            if name.startswith("_") and name != "__call__":
                continue
            cfg = get_batch_config(member)
            if cfg is not None:
                out[name] = cfg.__dict__
        return out

    def stream_methods(self) -> list[str]:
        """Generator methods — routers dispatch these via the streaming
        call path so chunks flow out as they are produced (reference:
        serve/_private/replica.py streaming user callables)."""
        if self._is_function:
            return ["__call__"] if inspect.isgeneratorfunction(
                self._instance) else []
        out = []
        for name, member in inspect.getmembers(self._instance, callable):
            if name.startswith("_") and name != "__call__":
                continue
            fn = getattr(member, "__func__", member)
            if inspect.isgeneratorfunction(fn):
                out.append(name)
        return out

    def replica_metadata(self) -> dict:
        """One readiness probe carrying everything the controller needs."""
        return {
            "batch_configs": self.batch_configs(),
            "stream_methods": self.stream_methods(),
            # engine-signal autoscaling + graceful drain are opt-in by
            # capability: the controller only polls/drains deployments
            # whose instances expose the hooks (serve.llm LLMDeployment)
            "has_autoscaling_snapshot": (
                not self._is_function
                and callable(getattr(self._instance, "autoscaling_snapshot", None))
            ),
            "has_drain": (
                not self._is_function
                and callable(getattr(self._instance, "prepare_drain", None))
            ),
            "has_metrics_report": True,
        }

    def metrics_report(self) -> dict:
        """Cheap snapshot for the controller's fleet metrics plane: this
        replica process's whole registry as kind-preserving families plus
        a freshness stamp. Same clocks as serve/llm obs — perf_counter
        for the monotonic stamp, wall time for display. Actor-level (not
        rt_call), so the poll never queues behind user traffic. The
        process's buffered trace spans ride the same payload — one poll
        feeds both the FleetAggregator and the TraceStore."""
        from ray_tpu_torch.util import tracing

        return {
            "clock": time.perf_counter(),
            "wall": time.time(),
            "families": metrics.collect_families(),
            "spans": tracing.drain_buffered_spans(),
        }

    # -- data surface --

    def rt_call(self, method_name: str, args: tuple, kwargs: dict):
        queue = self._batch_queue(method_name)
        if queue is not None:
            # one positional payload per call (router enforces); this method
            # thread parks in the queue while sibling concurrent calls fill
            # the batch — ALL callers of this replica share one queue
            return queue.submit(args[0])
        return self._method(method_name)(*args, **kwargs)

    def rt_call_stream(self, method_name: str, args: tuple, kwargs: dict):
        """Streaming dispatch: a generator the router invokes with
        num_returns='streaming' so every yielded chunk seals as its own
        object the consumer can fetch before the method finishes."""
        yield from self._method(method_name)(*args, **kwargs)

    def _batch_queue(self, method_name: str):
        q = self._batch_queues.get(method_name)
        if q is None:
            cfg = self.batch_configs().get(method_name)
            if cfg is None:
                return None
            from ray_tpu_torch.serve.config import BatchConfig

            bc = BatchConfig(**cfg)
            if bc.max_batch_size > self._max_ongoing:
                # callers park in the bounded method pool, so a batch can
                # never exceed the concurrency — without the clamp every
                # batch would stall for the full wait timeout (the reference
                # warns on this misconfiguration too)
                print(
                    f"[serve] {self.deployment_name}.{method_name}: "
                    f"max_batch_size={bc.max_batch_size} exceeds "
                    f"max_ongoing_requests={self._max_ongoing}; clamping — "
                    f"raise max_ongoing_requests to batch larger",
                    flush=True,
                )
                bc.max_batch_size = self._max_ongoing
            q = self._batch_queues.setdefault(
                method_name,
                _ReplicaBatchQueue(self._method(method_name), bc),
            )
        return q

    def _method(self, name: str):
        if self._is_function:
            if name != "__call__":
                raise AttributeError(
                    f"function deployment {self.deployment_name} only supports "
                    f"__call__, got {name}"
                )
            return self._instance
        return getattr(self._instance, name)
