"""DeploymentHandle + router: client-side replica scheduling (the port's
copy of ``ray_tpu/serve/handle.py``; prompt digests for prefix-aware
routing use the port's ``serve/llm/kv_cache._block_key``).

Equivalent of the reference's handle/router pair
(reference: python/ray/serve/handle.py:298 DeploymentHandle;
serve/_private/router.py:922 Router, :308 PowerOfTwoChoicesReplicaScheduler,
assign_replica :278). The handle tracks its own in-flight counts per replica
and picks the lower-loaded of two random replicas. Batched methods ship as
ordinary single-payload calls: coalescing happens REPLICA-side (replica.py
_ReplicaBatchQueue, matching the reference's serve/batching.py:337), so
callers from different processes share one padded batch.
"""
from __future__ import annotations

import logging
import os
import random
import threading
import time
import uuid
import zlib
from concurrent.futures import Future
from typing import Any

import ray_tpu_torch
from ray_tpu_torch._private import chaos
from ray_tpu_torch.exceptions import EngineOverloadedError
from ray_tpu_torch.util import metrics, tracing

logger = logging.getLogger("ray_tpu_torch.serve.handle")

_TABLE_REFRESH_S = 0.25
# controller-outage survival: a failed routing-table RPC keeps serving
# the cached table (the controller only ever removes entries the
# failover path already tolerates), bounded by a short per-RPC timeout
# so one refresh can't stall a dispatch for the whole outage
_TABLE_RPC_TIMEOUT_S = 5.0
# the shed flag is only as fresh as the table that carried it: once the
# table is older than this, fail OPEN (engines still shed engine-side)
# instead of rejecting all traffic on a flag the dead controller can no
# longer retract
_SHED_MAX_AGE_S = 3.0
# how long a mid-stream failover RESUME keeps retrying through transient
# EngineOverloadedError (draining-replica race, momentary saturation)
# before failing the half-delivered stream
_RESUME_OVERLOAD_RETRY_S = 10.0
# resume-retry backoff schedule (resume_backoff_s): first retry ~base,
# doubling per attempt up to cap, each jittered into [span/2, span]
_RESUME_BACKOFF_BASE_S = 0.05
_RESUME_BACKOFF_CAP_S = 1.0
# --- prefix-aware routing (fleet-scale KV caching) ---
# compute at most this many leading chain digests per dispatch: deeper
# matches are indistinguishable to the router, and the per-replica
# summary the controller ships is itself bounded
_PREFIX_MATCH_BLOCKS = 16
# load-balance escape hatch: honor the longest prefix match only while
# the target's tracked in-flight load is within this many requests of
# the least-loaded candidate — past that, fall back to power-of-two so
# a hot prefix cannot hotspot one replica
_PREFIX_MAX_SKEW = 4
# "0" disables prefix preference (the bench's private-cache baseline);
# re-read at every table refresh, so flipping it needs no new router
_PREFIX_ROUTING_ENV = "RAY_TPU_PREFIX_ROUTING"


def resume_backoff_s(seed: int, attempt: int, *,
                     base: float = _RESUME_BACKOFF_BASE_S,
                     cap: float = _RESUME_BACKOFF_CAP_S) -> float:
    """Seeded exponential backoff with jitter for the mid-stream RESUME
    retry loop: attempt N sleeps in [span/2, span] where
    span = min(cap, base * 2**N). A replica kill failing dozens of
    streams at once must not re-dispatch them in lockstep — the fixed
    cadence it replaces hammered the survivor with a thundering herd —
    so the jitter spreads resumes out while the per-stream seed keeps
    any one stream's schedule deterministic and testable. The OVERALL
    retry window (_RESUME_OVERLOAD_RETRY_S) is unchanged."""
    span = min(cap, base * (2.0 ** min(attempt, 30)))
    jitter = random.Random((int(seed) << 20) ^ int(attempt)).random()
    return span * (0.5 + 0.5 * jitter)


class DeploymentResponse:
    """Result of handle.method.remote(): resolve with .result()
    (reference: serve/handle.py DeploymentResponse)."""

    def __init__(self, ref=None, future: Future | None = None, on_done=None):
        self._ref = ref
        self._future = future
        self._on_done = on_done
        self._done = False

    def result(self, timeout: float | None = 60.0) -> Any:
        import concurrent.futures

        from ray_tpu_torch.exceptions import GetTimeoutError

        try:
            if self._future is not None:
                out = self._future.result(timeout)
            else:
                out = ray_tpu_torch.get(self._ref, timeout=timeout)
        except (GetTimeoutError, concurrent.futures.TimeoutError):
            # the request is STILL running on the replica — keep the
            # in-flight count until it actually finishes (the router sweep
            # reclaims it then)
            raise
        except BaseException:
            self._mark_done()
            raise
        self._mark_done()
        return out

    def _mark_done(self) -> None:
        if not self._done:
            self._done = True
            if self._on_done:
                self._on_done()

    @property
    def ref(self):
        return self._ref


class DeploymentResponseGenerator:
    """Result of calling a GENERATOR deployment method: iterate to receive
    chunks as the replica produces them (reference: serve/handle.py
    DeploymentResponseGenerator). Values (not refs) are yielded — the
    handle resolves each chunk as it arrives."""

    def __init__(self, ref_gen, on_done=None,
                 chunk_timeout_s: float | None = 120.0):
        self._ref_gen = ref_gen
        self._on_done = on_done
        self._done = False
        # actor id (bytes) of the replica serving this stream; set by the
        # router at dispatch so failover can exclude the dead replica
        self.replica_actor_id: bytes | None = None
        # per-chunk fetch budget; None = wait forever (slow LLM prefill /
        # long tool calls can legitimately exceed any fixed gap). Set via
        # handle.options(stream_chunk_timeout_s=...).
        self._timeout = chunk_timeout_s

    def __iter__(self):
        return self

    def __next__(self) -> Any:
        try:
            ref = next(self._ref_gen)
        except StopIteration:
            self._mark_done()
            raise
        except BaseException:
            self._mark_done()
            raise
        return ray_tpu_torch.get(ref, timeout=self._timeout)

    def _mark_done(self) -> None:
        if not self._done:
            self._done = True
            if self._on_done:
                self._on_done()

    @property
    def completed_ref(self):
        return self._ref_gen.completed_ref


def _failover_cause(e: BaseException) -> BaseException:
    """Unwrap a TaskError to the replica-side exception for retryability
    classification (worker.py re-raises .cause where picklable, but the
    streaming marker path can still surface the wrapper)."""
    from ray_tpu_torch.exceptions import TaskError

    if isinstance(e, TaskError) and e.cause is not None:
        return e.cause
    return e


class ResumableStreamGenerator:
    """A streamed call that survives replica death mid-stream.

    Wraps dispatch-to-one-replica (``dispatch(payload, exclude)``): when
    the serving replica dies (ActorError — including the engine watchdog's
    EngineDiedError — worker crash, lost chunk, dropped connection), it
    builds a resume payload from every chunk already delivered
    (``resume(chunks)``), excludes the dead replica, and re-dispatches to
    a survivor. Chunks must be dicts carrying ``index_key`` with the
    ABSOLUTE chunk index; duplicates from the resumed stream are dropped
    so the caller sees each index exactly once, gap-free.
    """

    def __init__(self, dispatch, payload, resume, *, index_key: str = "index",
                 max_failovers: int = 2):
        self._dispatch = dispatch
        self._payload = payload
        self._resume = resume
        self._index_key = index_key
        self._max_failovers = max_failovers
        self._inner = None
        self.chunks: list = []   # every chunk delivered to the caller
        self.failovers = 0
        self._exclude: set[bytes] = set()
        self._overload_deadline: float | None = None
        self._overload_attempt = 0
        # per-stream backoff seed: request_id when the payload carries one
        # (so a stream's retry schedule is reproducible), else the payload
        # repr — distinct streams land on distinct jitter either way
        rid = (payload.get("request_id")
               if isinstance(payload, dict) else None)
        self._backoff_seed = zlib.crc32(
            str(rid if rid is not None else repr(payload)).encode())
        # chunks are pulled on pump threads that don't inherit the
        # caller's contextvars, so the trace context (if any) is captured
        # HERE — construction happens under the proxy's root span — and
        # failover spans are recorded from it explicitly
        self._trace_ctx = tracing.current_context()

    def __iter__(self):
        return self

    def __next__(self):
        from ray_tpu_torch.exceptions import (
            ActorError,
            ObjectLostError,
            WorkerCrashedError,
        )

        retryable = (ActorError, WorkerCrashedError, ObjectLostError,
                     ConnectionError)
        while True:
            try:
                if self._inner is None:
                    # re-attach the stored trace context: after a failover
                    # this runs on a pump thread with no inherited
                    # contextvars, and the resume dispatch must still
                    # parent the survivor's spans under the original trace
                    with tracing.attach_context(self._trace_ctx):
                        self._inner = self._dispatch(
                            self._payload, frozenset(self._exclude)
                        )
                chunk = next(self._inner)
            except StopIteration:
                raise
            except BaseException as e:  # noqa: BLE001 — classify below
                cause = _failover_cause(e)
                if (isinstance(cause, EngineOverloadedError)
                        and self.failovers > 0):
                    # a resume re-dispatch raced a draining/overloaded
                    # replica. The FIRST dispatch propagates overload (the
                    # caller gets 503 + Retry-After), but once chunks have
                    # been delivered the lossless-failover contract says
                    # this stream must finish — retry briefly instead of
                    # failing a half-delivered stream.
                    now = time.monotonic()
                    if self._overload_deadline is None:
                        self._overload_deadline = (
                            now + _RESUME_OVERLOAD_RETRY_S)
                    if now > self._overload_deadline:
                        raise
                    self._inner = None
                    self._payload = self._resume(list(self.chunks))
                    time.sleep(resume_backoff_s(
                        self._backoff_seed, self._overload_attempt))
                    self._overload_attempt += 1
                    continue
                if (
                    not isinstance(cause, retryable)
                    or self.failovers >= self._max_failovers
                ):
                    raise
                self._overload_deadline = None
                self._overload_attempt = 0
                self.failovers += 1
                aid = getattr(self._inner, "replica_actor_id", None)
                if aid is not None:
                    self._exclude.add(aid)
                if self._trace_ctx is not None:
                    # stitch the failover into the request's trace: the
                    # resume re-dispatch below opens a fresh dispatch span
                    # on the surviving replica, and this marker explains
                    # WHY there are two engine subtrees in one trace
                    tracing.record_span(
                        "handle.resume",
                        trace_id=self._trace_ctx["trace_id"],
                        parent_span_id=self._trace_ctx["parent_span_id"],
                        start=time.time(),
                        end=time.time(),
                        attrs={
                            "failover": self.failovers,
                            "excluded_replica": (aid.hex()[:12]
                                                 if aid else None),
                            "delivered_chunks": len(self.chunks),
                            "cause": type(cause).__name__,
                        },
                    )
                self._payload = self._resume(list(self.chunks))
                self._inner = None
                continue
            idx = chunk.get(self._index_key) if isinstance(chunk, dict) else None
            if idx is None:
                self.chunks.append(chunk)
                return chunk
            if idx < len(self.chunks):
                continue  # duplicate from the resumed stream — drop
            if idx > len(self.chunks):
                raise RuntimeError(
                    f"stream gap: expected chunk {len(self.chunks)}, "
                    f"got {idx}"
                )
            self.chunks.append(chunk)
            return chunk


class _Router:
    """Shared per-process router state: routing table cache + in-flight
    accounting + batchers. One per (app, deployment)."""

    _instances: dict = {}
    _instances_lock = threading.Lock()

    @classmethod
    def get(cls, app_name: str, deployment_name: str) -> "_Router":
        key = (app_name, deployment_name)
        with cls._instances_lock:
            r = cls._instances.get(key)
            if r is None:
                r = cls(app_name, deployment_name)
                cls._instances[key] = r
            return r

    @classmethod
    def reset_all(cls) -> None:
        with cls._instances_lock:
            cls._instances.clear()

    def __init__(self, app_name: str, deployment_name: str):
        self.app_name = app_name
        self.deployment_name = deployment_name
        self.router_id = uuid.uuid4().hex[:12]
        self._lock = threading.Lock()
        # serializes the FIRST table fetch (see _refresh)
        self._first_fetch = threading.Lock()
        self._replicas: list = []
        self._batch_configs: dict[str, dict] = {}
        self._stream_methods: set[str] = set()
        self._max_ongoing = 8
        self._inflight: dict[bytes, int] = {}  # actor_id -> count
        self._outstanding: dict[bytes, bytes] = {}  # object_id -> actor_id
        self._last_refresh = 0.0
        self._controller = None
        # monotonic stamp of the last SUCCESSFUL table fetch (shed aging)
        self._table_at = 0.0
        # controller re-resolution backoff (seeded like the resume path:
        # every router in the process must not hammer the GCS in lockstep
        # when a restarted controller comes back)
        self._ctrl_attempt = 0
        self._next_ctrl_retry = 0.0
        self._ctrl_backoff_seed = zlib.crc32(self.router_id.encode())
        # cluster-wide admission: the controller marks the deployment shed
        # when the whole fleet is saturated (fleet_saturated); data-plane
        # dispatches then fail fast with EngineOverloadedError instead of
        # queuing doomed work (proxies map it to 503 + Retry-After)
        self._shed = False
        # class-aware partial shed: when preemption is exhausted fleet-wide
        # but capacity remains for higher classes, the controller names the
        # priority classes to reject (batch first) instead of flipping the
        # whole-deployment shed bit
        self._shed_classes: tuple = ()
        self._m_shed = metrics.counter(
            "llm_requests_shed",
            "Requests shed at admission while the fleet is saturated, "
            "by priority class",
            tag_keys=("app", "deployment", "priority"),
        )
        # Seeded tie-break RNG: routers replay identical choice sequences
        # under the chaos harness (module-level random would interleave
        # with every other consumer in the process).
        self._rng = random.Random(zlib.crc32(self.router_id.encode()))
        # prefix-aware routing state, refreshed with the table:
        # actor id -> frozenset of hex chain digests its caches hold
        self._prefix_summaries: dict[bytes, frozenset] = {}
        self._prefix_block_size: int | None = None
        self._prefix_vocab_size: int | None = None
        self._prefix_routing = (
            os.environ.get(_PREFIX_ROUTING_ENV, "1") != "0"
        )
        self._m_prefix_hits = metrics.counter(
            "llm_router_prefix_hits",
            "Dispatches routed to the replica holding the longest "
            "matching prefix chain",
            tag_keys=("app", "deployment"),
        )

    # -- table management --

    def _controller_handle(self):
        if self._controller is None:
            from ray_tpu_torch.serve.controller import CONTROLLER_NAME

            self._controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        return self._controller

    def _invalidate_controller(self) -> None:
        """Forget the cached controller handle after a failed RPC. A
        controller restarted in place (the raylet supervisor path) keeps
        its actor id, but a recreated one does not — re-resolving by
        name on the next attempt covers both, and the seeded backoff
        spreads the re-resolve attempts of every router in the process."""
        with self._lock:
            self._controller = None
            self._next_ctrl_retry = time.monotonic() + resume_backoff_s(
                self._ctrl_backoff_seed, self._ctrl_attempt
            )
            self._ctrl_attempt += 1

    def _refresh(self, force: bool = False) -> None:
        """Refresh the routing table. During a controller outage this
        DEGRADES instead of failing: the cached table keeps serving and
        the controller handle is re-resolved under backoff once the
        supervisor restarts it. 'app/deployment not found' is only
        raised on a SUCCESSFUL fetch that proves the absence.

        Until a first table has arrived, callers wait for the fetch in
        flight instead of returning at once: the reference's router lets
        a call that races a fresh router's first fetch read the empty
        table, and so dispatch a generator method as a unary call."""
        if not self._table_at:
            with self._first_fetch:
                if not self._table_at:
                    self._refresh_once(force=True)
                    return
        self._refresh_once(force)

    def _refresh_once(self, force: bool) -> None:
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_refresh < _TABLE_REFRESH_S:
                return
            if self._controller is None and now < self._next_ctrl_retry:
                return  # outage backoff: keep serving the cached table
            self._last_refresh = now
            load_report = {
                (self.app_name, self.deployment_name): sum(self._inflight.values())
            }
        self._sweep()
        try:
            table = ray_tpu_torch.get(
                self._controller_handle().get_routing_table.remote(
                    self.router_id,
                    {tuple(k): v for k, v in load_report.items()},
                ),
                timeout=_TABLE_RPC_TIMEOUT_S,
            )
        except Exception as e:  # noqa: BLE001 — controller outage
            self._invalidate_controller()
            logger.warning(
                "routing-table refresh for %s/%s failed (controller "
                "down?); serving cached table: %r",
                self.app_name, self.deployment_name, e,
            )
            return
        app = table["apps"].get(self.app_name)
        if app is None:
            raise RuntimeError(f"serve application {self.app_name!r} not found")
        dep = app["deployments"].get(self.deployment_name)
        if dep is None:
            raise RuntimeError(
                f"deployment {self.deployment_name!r} not found in app "
                f"{self.app_name!r}"
            )
        with self._lock:
            self._replicas = dep["replicas"]
            self._batch_configs = dep["batch_configs"]
            self._stream_methods = set(dep.get("stream_methods", ()))
            self._max_ongoing = dep["max_ongoing_requests"]
            self._shed = bool(dep.get("shed", False))
            self._shed_classes = tuple(dep.get("shed_classes", ()))
            self._prefix_summaries = {
                aid: frozenset(digests)
                for aid, digests in (dep.get("prefix_summaries") or {}).items()
            }
            self._prefix_block_size = dep.get("prefix_block_size")
            self._prefix_vocab_size = dep.get("prefix_vocab_size")
            self._prefix_routing = (
                os.environ.get(_PREFIX_ROUTING_ENV, "1") != "0"
            )
            self._table_at = time.monotonic()
            self._ctrl_attempt = 0
            self._next_ctrl_retry = 0.0

    # -- in-flight accounting --

    def _decrement(self, oid: bytes) -> None:
        """Primary decrement path: DeploymentResponse.result() on_done."""
        with self._lock:
            aid = self._outstanding.pop(oid, None)
            if aid is not None:
                self._inflight[aid] = max(0, self._inflight.get(aid, 1) - 1)

    def _sweep(self) -> None:
        """Safety net for responses whose .result() is never called: drop
        outstanding entries whose result landed (or was evicted). Runs at
        most once per table refresh — NOT per dispatch (a per-dispatch sweep
        would cost O(outstanding) store round-trips per call)."""
        worker = ray_tpu_torch.worker.global_worker()
        from ray_tpu_torch._private.ids import ObjectID

        with self._lock:
            snapshot = list(self._outstanding.items())
        for oid, aid in snapshot:
            # status(): 'present' OR 'evicted' both mean the call finished
            if worker.store.status(ObjectID(oid)) != "missing":
                self._decrement(oid)

    def _pick_replica(self, deadline: float, exclude: frozenset = frozenset(),
                      prefix_digests: tuple | None = None,
                      route_info: dict | None = None):
        """Prefix-aware placement over power-of-two load balancing.
        ``exclude`` holds actor ids (bytes) of replicas the caller knows
        are dead — the failover path skips them until the controller's
        reconcile removes them from the routing table; it COMPOSES with
        the prefix preference (dead replicas are filtered first, then the
        prefix scorer runs over the survivors) rather than bypassing it.
        When ``prefix_digests`` names the prompt's leading chain digests,
        the replica whose advertised caches hold the longest matching
        chain wins — unless its load skew trips the escape hatch
        (_PREFIX_MAX_SKEW), in which case plain power-of-two resumes.
        Tie-breaking samples from the router's seeded RNG so choice
        sequences replay deterministically under the chaos harness.
        ``route_info`` (when given) is filled with the decision the
        dispatch span reports: strategy, candidate count, prefix match
        length, and whether the skew escape hatch fired."""
        info = route_info if route_info is not None else {}
        while True:
            self._refresh()
            with self._lock:
                replicas = [
                    r for r in self._replicas
                    if r._actor_id.binary() not in exclude
                ]
                if replicas:
                    info["candidates"] = len(replicas)
                    if len(replicas) == 1:
                        info["strategy"] = "single"
                        return replicas[0]
                    if prefix_digests:
                        info["prefix_blocks"] = len(prefix_digests)
                        choice = self._prefix_choice_locked(
                            replicas, prefix_digests, info
                        )
                        if choice is not None:
                            self._m_prefix_hits.inc(
                                tags={"app": self.app_name,
                                      "deployment": self.deployment_name}
                            )
                            info["strategy"] = "prefix"
                            return choice
                    a, b = self._rng.sample(replicas, 2)
                    la = self._inflight.get(a._actor_id.binary(), 0)
                    lb = self._inflight.get(b._actor_id.binary(), 0)
                    info["strategy"] = "p2c"
                    return a if la <= lb else b
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"no RUNNING replicas for {self.app_name}/"
                    f"{self.deployment_name}"
                )
            time.sleep(0.1)

    def _prefix_choice_locked(self, replicas: list,
                              prefix_digests: tuple,
                              route_info: dict | None = None):
        """Score each candidate by how many LEADING digests of the
        prompt's chain its advertised summary holds; -> the best replica,
        or None to fall back to power-of-two (no replica matches, or the
        winner is too loaded relative to the least-loaded candidate).
        Ties prefer the less-loaded replica, then table order — fully
        deterministic given one routing table."""
        if route_info is None:
            route_info = {}
        best = None
        best_match = 0
        best_load = 0
        min_load: int | None = None
        for r in replicas:
            aid = r._actor_id.binary()
            load = self._inflight.get(aid, 0)
            if min_load is None or load < min_load:
                min_load = load
            resident = self._prefix_summaries.get(aid)
            if not resident:
                continue
            match = 0
            for d in prefix_digests:
                if d not in resident:
                    break
                match += 1
            if match > best_match or (
                match == best_match and match > 0 and load < best_load
            ):
                best, best_match, best_load = r, match, load
        route_info["matched_blocks"] = best_match
        if best is None or best_match == 0:
            return None
        if best_load - (min_load or 0) > _PREFIX_MAX_SKEW:
            route_info["skew_escape"] = True
            return None  # escape hatch: hot prefix must not hotspot
        return best

    def _prompt_digests(self, payload: dict) -> tuple | None:
        """Leading chain digests (hex) of a fresh ``__call__`` prompt,
        computed in the SAME digest space as the replicas' block chains
        (kv_cache._block_key over encode_text-style tokens). Returns
        None whenever the prefix path should not apply: routing disabled,
        no summaries advertised yet, a failover resume (``prior_tokens``
        payloads keep today's dispatch path), or a payload the router
        cannot tokenize."""
        if payload.get("prior_tokens"):
            return None
        with self._lock:
            if not self._prefix_routing:
                return None
            bs = self._prefix_block_size
            vocab = self._prefix_vocab_size
            have_summaries = any(self._prefix_summaries.values())
        if not bs or not have_summaries:
            return None
        prompt = payload.get("prompt")
        try:
            if isinstance(prompt, str):
                if not vocab:
                    return None
                # mirror serve.llm.api.encode_text byte-for-byte
                tokens = [b % vocab for b in prompt.encode("utf-8")]
            else:
                tokens = list(prompt or ())
            if len(tokens) < bs:
                return None
            from ray_tpu_torch.serve.llm.kv_cache import _block_key

            digest = b""
            out = []
            for i in range(min(len(tokens) // bs, _PREFIX_MATCH_BLOCKS)):
                digest = _block_key(digest, tokens[i * bs:(i + 1) * bs])
                out.append(digest.hex())
            return tuple(out) or None
        except Exception as e:  # noqa: BLE001 — unroutable payload shape
            logger.debug(
                "prefix digests skipped for %s/%s: %r",
                self.app_name, self.deployment_name, e,
            )
            return None

    # -- call paths --

    def call(self, method_name: str, args: tuple, kwargs: dict,
             options: dict | None = None,
             exclude: frozenset = frozenset()) -> DeploymentResponse:
        options = options or {}
        chaos.fire("handle.dispatch", method=method_name)
        self._refresh()
        with self._lock:
            bc = self._batch_configs.get(method_name)
        if bc is not None and (len(args) != 1 or kwargs):
            # the @serve.batch contract is one positional payload per call
            # (the method receives the list); extra args/kwargs would be
            # silently dropped replica-side, so reject them here
            raise TypeError(
                f"batched method {self.deployment_name}.{method_name} "
                f"takes exactly one positional argument per call, got "
                f"args={len(args)} kwargs={sorted(kwargs)}"
            )
        with self._lock:
            is_stream = method_name in self._stream_methods
            shed = self._shed
            shed_classes = self._shed_classes
            if ((shed or shed_classes)
                    and time.monotonic() - self._table_at > _SHED_MAX_AGE_S):
                # stale flag during a controller outage: age it out and
                # fail open — the saturated engines still shed for
                # themselves, but an unreachable controller must not keep
                # rejecting traffic it can no longer observe
                shed = self._shed = False
                shed_classes = self._shed_classes = ()
        req_priority = "default"
        if args and isinstance(args[0], dict):
            req_priority = str(args[0].get("priority", "default"))
        shed_this = shed or req_priority in shed_classes
        if shed_this and not exclude and (is_stream or method_name == "__call__"):
            # fleet-wide saturation: reject NEW data-plane work before it
            # queues — either the whole deployment (shed) or just the named
            # priority classes once preemption is exhausted (shed_classes;
            # batch first). Control methods — cancel, stats, debug — still
            # pass; failover resumes carry ``exclude`` and are never shed
            # so a half-delivered stream always finishes.
            self._m_shed.inc(tags={"app": self.app_name,
                                   "deployment": self.deployment_name,
                                   "priority": req_priority})
            detail = ("all replicas saturated (queue backlog + KV pressure "
                      "on every replica)" if shed else
                      f"preemption exhausted fleet-wide; class "
                      f"{req_priority!r} is being shed")
            # traced callers get a shed span (recorded on the exception
            # exit) so the TraceStore's tail sampler retains the trace
            with tracing.span_if_active(
                "handle.shed",
                deployment=f"{self.app_name}/{self.deployment_name}",
                priority=req_priority,
                class_shed=not shed,
            ):
                raise EngineOverloadedError(
                    f"{self.app_name}/{self.deployment_name}: {detail}; "
                    "shedding at admission — retry later"
                )
        # prefix-aware placement applies to fresh generation dispatches
        # only: __call__ with a dict payload and no prior_tokens (resumes
        # and control methods keep the plain path — but still compose
        # with ``exclude`` inside _pick_replica)
        prefix_digests = None
        if method_name == "__call__" and args and isinstance(args[0], dict):
            prefix_digests = self._prompt_digests(args[0])
        route_info: dict = {}
        replica = self._pick_replica(
            time.monotonic() + 30, exclude, prefix_digests, route_info
        )
        aid = replica._actor_id.binary()
        # when the caller carries a trace, open a dispatch span so the
        # replica task (whose trace_ctx is captured at .remote() time)
        # parents under it; no-op for untraced callers. The routing
        # decision rides the span: which replica won, by which strategy,
        # how much of the prompt's prefix it advertised, and whether the
        # load-skew escape hatch overrode a prefix match.
        dispatch_span = tracing.span_if_active(
            "handle.dispatch",
            deployment=f"{self.app_name}/{self.deployment_name}",
            method=method_name,
            replica=aid.hex()[:12],
            strategy=route_info.get("strategy"),
            candidates=route_info.get("candidates", 0),
            matched_blocks=route_info.get("matched_blocks", 0),
            skew_escape=route_info.get("skew_escape", False),
            excluded=len(exclude),
        )
        if is_stream:
            # generator replica method: dispatch through the streaming
            # call path so chunks seal (and are fetchable) as produced
            with dispatch_span:
                gen = replica.rt_call_stream.options(
                    num_returns="streaming"
                ).remote(method_name, args, kwargs)
            oid = gen.completed_ref.object_id.binary()
            with self._lock:
                self._inflight[aid] = self._inflight.get(aid, 0) + 1
                self._outstanding[oid] = aid
            out = DeploymentResponseGenerator(
                gen, on_done=lambda: self._decrement(oid),
                chunk_timeout_s=options.get("stream_chunk_timeout_s", 120.0))
            out.replica_actor_id = aid
            return out
        with dispatch_span:
            ref = replica.rt_call.remote(method_name, args, kwargs)
        oid = ref.object_id.binary()
        with self._lock:
            self._inflight[aid] = self._inflight.get(aid, 0) + 1
            self._outstanding[oid] = aid
        resp = DeploymentResponse(ref=ref, on_done=lambda: self._decrement(oid))
        # same contract as the stream path: callers running their own
        # retry loop (e.g. the prefill-handoff seal) need to know which
        # replica served — or died serving — this call so they can
        # exclude it on the next attempt
        resp.replica_actor_id = aid
        return resp

    def broadcast(self, method_name: str, args: tuple = (),
                  kwargs: dict | None = None, timeout: float = 30.0) -> list:
        """Dispatch a unary method to EVERY running replica and collect the
        results (None where a replica failed). Used for operations that
        must reach whichever replica owns some state — e.g. cancelling a
        stream that power-of-two routing placed on an unknown replica."""
        self._refresh(force=True)
        with self._lock:
            replicas = list(self._replicas)
        refs = []
        for replica in replicas:
            try:
                refs.append(replica.rt_call.remote(
                    method_name, tuple(args), kwargs or {}))
            except Exception:  # noqa: BLE001 — dead replica: skip it
                refs.append(None)
        results = []
        for ref in refs:
            if ref is None:
                results.append(None)
                continue
            try:
                results.append(ray_tpu_torch.get(ref, timeout=timeout))
            except Exception:  # noqa: BLE001 — dead replica: skip it
                results.append(None)
        return results

class _HandleMethod:
    def __init__(self, router: _Router, method_name: str,
                 options: dict | None = None):
        self._router = router
        self._method_name = method_name
        self._options = options

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._router.call(self._method_name, args, kwargs,
                                 options=self._options)


class DeploymentHandle:
    """Callable handle to a deployment; picklable (rebuilds its router from
    the named controller on the other side)."""

    _OPTION_KEYS = frozenset({"stream_chunk_timeout_s"})

    def __init__(self, deployment_name: str, app_name: str = "default",
                 _options: dict | None = None):
        self.deployment_name = deployment_name
        self.app_name = app_name
        self._handle_options = _options or {}

    def __reduce__(self):
        return (DeploymentHandle,
                (self.deployment_name, self.app_name, self._handle_options))

    def options(self, **kwargs) -> "DeploymentHandle":
        """Per-call options on a derived handle (reference:
        serve/handle.py DeploymentHandle.options). Supported:
        stream_chunk_timeout_s — per-chunk fetch budget for generator
        methods (None waits forever)."""
        unknown = set(kwargs) - self._OPTION_KEYS
        if unknown:
            raise TypeError(f"unknown handle options: {sorted(unknown)}")
        return DeploymentHandle(self.deployment_name, self.app_name,
                                {**self._handle_options, **kwargs})

    @property
    def _router(self) -> _Router:
        return _Router.get(self.app_name, self.deployment_name)

    def __getattr__(self, name: str) -> _HandleMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return _HandleMethod(self._router, name, self._handle_options)

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._router.call("__call__", args, kwargs,
                                 options=self._handle_options)

    def stream_methods(self, force: bool = False) -> set:
        """Names of the deployment's generator (streaming) methods
        (cached routing table unless ``force``)."""
        router = self._router
        router._refresh(force=force)
        with router._lock:
            return set(router._stream_methods)

    def broadcast(self, method_name: str, *args, **kwargs) -> list:
        """Call a unary method on EVERY running replica; -> list of results
        (None where a replica failed). For state that lives on an unknown
        replica — e.g. ``handle.broadcast("cancel", request_id)`` reaches
        whichever replica is serving the stream (cancel is idempotent)."""
        return self._router.broadcast(method_name, args, kwargs)

    def stream_with_failover(self, payload: dict, *, resume,
                             method: str = "__call__",
                             index_key: str = "index",
                             max_failovers: int = 2):
        """Stream ``method(payload)`` with mid-stream replica failover:
        on replica death, ``resume(chunks_so_far)`` builds the re-submit
        payload and the call is re-dispatched to a surviving replica,
        deduplicating by ``index_key``. See serve.llm.stream_tokens for
        the LLM resume recipe (prior_tokens + deterministic sampling)."""
        def dispatch(p, exclude):
            return self._router.call(method, (p,), {},
                                     options=self._handle_options,
                                     exclude=exclude)

        return ResumableStreamGenerator(
            dispatch, payload, resume,
            index_key=index_key, max_failovers=max_failovers,
        )
