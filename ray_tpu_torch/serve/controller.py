"""ServeController — the deployment reconciler actor (the port's copy of
``ray_tpu/serve/controller.py``; a replica takes whole cards with
``ray_actor_options={"num_gpus": n}``, as the port's raylet gives them).

Equivalent of the reference's ServeController + DeploymentStateManager
(reference: python/ray/serve/_private/controller.py:88 controller actor;
deployment_state.py:1155,2258 replica-set reconciler state machine;
application_state.py app lifecycle; autoscaling decisions fed by replica
metrics). One named actor; a background thread drives reconciliation:
desired replicas vs. live replicas, health checks, autoscaling.

Crash restartability (reference: the controller checkpoints to the GCS
internal KV and `_recover_state_from_checkpoint` on boot): after every
state mutation the controller writes a small versioned JSON checkpoint
of desired state + replica roster to the GCS internal KV; the raylet
restarts the named actor in place on worker death (api.py spawns it
with max_restarts > 0), and ``_recover`` rebuilds from the checkpoint —
adopting live replicas through the normal ping path, reaping orphans
the checkpoint doesn't know, and resuming in-flight drains. The data
plane (handles/proxies) keeps serving from cached routing tables for
the duration of the outage.
"""
from __future__ import annotations

import base64
import json
import logging
import threading
import time
from typing import Any

import ray_tpu_torch
from ray_tpu_torch._private import chaos, serialization
from ray_tpu_torch._private.gcs import kv_del, kv_get, kv_put
from ray_tpu_torch._private.ids import ActorID
from ray_tpu_torch.actor import ActorClass, ActorHandle
from ray_tpu_torch.serve.autoscaling_policy import (
    AutoscalingDecider,
    fleet_saturated,
    shed_classes,
)
from ray_tpu_torch.serve import slo as slo_mod
from ray_tpu_torch.serve.config import DeploymentConfig
from ray_tpu_torch.serve.llm import obs
from ray_tpu_torch.serve.replica import ReplicaActor
from ray_tpu_torch.serve.trace_store import TraceStore
from ray_tpu_torch.util import metrics, tracing

logger = logging.getLogger("ray_tpu_torch.serve.controller")

CONTROLLER_NAME = "RT_SERVE_CONTROLLER"
# crash-recovery checkpoint location in the GCS internal KV
CHECKPOINT_KEY = b"RT_SERVE_CONTROLLER_CKPT"
CHECKPOINT_NS = "serve"
# bump on ANY incompatible change to the checkpoint payload shape;
# decode_checkpoint refuses (loudly) to recover from a version it does
# not understand — guessing at an unknown layout could adopt or reap
# the wrong replicas
CHECKPOINT_VERSION = 1
_METRIC_TTL_S = 5.0
# cadence of per-replica autoscaling_snapshot pulls (signal-capable
# deployments only) and the patience per pull
_SNAPSHOT_PERIOD_S = 0.5
_SNAPSHOT_TIMEOUT_S = 30.0
# fleet metrics plane: cadence of metrics_report pulls (EVERY replica
# and proxy, not capability-gated), patience per pull, and ring depth
# per fleet series (~3 minutes of history at the poll cadence)
_FLEET_PERIOD_S = 0.5
_FLEET_TIMEOUT_S = 30.0
_FLEET_HISTORY_SAMPLES = 360
# SLO burn-rate evaluation cadence over the history rings (each tick
# re-reads whole rings, so it runs a touch slower than the poll)
_SLO_EVAL_PERIOD_S = 1.0
# extra actor method threads beyond max_ongoing_requests, so control-plane
# calls (ping / autoscaling_snapshot / drain_status) never park behind a
# data plane running at full concurrency — a saturated replica must still
# report that it IS saturated
_CONTROL_SLOTS = 3


# ---------------- checkpoint codec ----------------
#
# The checkpoint is a small JSON envelope (human-inspectable via
# `kv_get`) with one non-JSON island: each deployment spec carries a
# pickled callable_blob / init_blob, so specs ride base64(pickle)
# inside the envelope. Encoding is pure — unit-testable without a
# controller or a cluster.


def encode_spec(spec: dict) -> str:
    """Deployment spec -> base64 text safe to embed in the JSON envelope
    (specs hold bytes blobs and dataclasses JSON can't carry)."""
    return base64.b64encode(serialization.dumps(spec)).decode("ascii")


def decode_spec(blob: str) -> dict:
    return serialization.deserialize(base64.b64decode(blob))


def encode_checkpoint(payload: dict) -> bytes:
    return json.dumps(payload, separators=(",", ":")).encode()


def decode_checkpoint(blob: bytes) -> dict:
    """Parse + validate a checkpoint. Raises ValueError on an unknown
    version or a structurally broken payload — recovery must refuse to
    guess (a misread roster would reap live replicas as orphans)."""
    try:
        payload = json.loads(blob.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"serve controller checkpoint is not JSON: {e}")
    if not isinstance(payload, dict):
        raise ValueError(
            f"serve controller checkpoint must be a JSON object, "
            f"got {type(payload).__name__}"
        )
    version = payload.get("version")
    if version != CHECKPOINT_VERSION:
        raise ValueError(
            f"serve controller checkpoint version {version!r} is not "
            f"supported (this binary speaks version {CHECKPOINT_VERSION})"
        )
    for field in ("seq", "apps"):
        if field not in payload:
            raise ValueError(
                f"serve controller checkpoint missing field {field!r}"
            )
    return payload


class _ReplicaState:
    def __init__(self, handle):
        self.handle = handle
        self.actor_id = handle._actor_id
        self.state = "STARTING"  # STARTING | RUNNING | DRAINING | STOPPING
        self.started_at = time.monotonic()
        self.ping_ref = None
        self.ping_deadline = 0.0
        self.next_ping_at = 0.0
        self.probe_ref = None  # in-flight batch_configs readiness probe
        self.probe_deadline = 0.0
        # autoscaling_snapshot polling (obs.clock timeline — one-clock rule)
        self.snapshot_ref = None
        self.snapshot_deadline = 0.0
        self.next_snapshot_at = 0.0
        # fleet metrics_report polling (same obs.clock ref discipline)
        self.metrics_ref = None
        self.metrics_deadline = 0.0
        self.next_metrics_at = 0.0
        # graceful drain state machine (DRAINING replicas only)
        self.drain_ref = None   # in-flight prepare_drain / drain_status poll
        self.finish_ref = None  # in-flight finish_drain (release_all)
        self.drain_deadline = 0.0


# consecutive replica deaths before __rt first became RUNNING that flip the
# deployment UNHEALTHY and stop the respawn loop (reference: deployment_state
# CrashLoopBackoff / DEPLOY_FAILED)
_MAX_CONSECUTIVE_START_FAILURES = 3


class _DeploymentState:
    def __init__(self, spec: dict):
        self.spec = spec
        self.config: DeploymentConfig = spec["config"]
        self.target = self.config.target_num_replicas
        self.replicas: list[_ReplicaState] = []
        self.batch_configs: dict[str, dict] = {}
        self.stream_methods: list[str] = []
        self.decider = (
            AutoscalingDecider(self.config.autoscaling_config)
            if self.config.autoscaling_config
            else None
        )
        self.status = "UPDATING"  # UPDATING | HEALTHY | UNHEALTHY
        self.last_error: str | None = None
        self.consecutive_start_failures = 0
        self.deleted = False
        # engine-signal autoscaling (set from replica_metadata capability
        # flags once the first replica probes ready)
        self.signal_capable = False
        self.drain_capable = False
        # actor_id bytes -> (obs.clock pull time, AutoscalingSnapshot dict)
        self.snapshots: dict[bytes, tuple[float, dict]] = {}
        # cluster-wide admission: routers shed new work while True
        self.shed = False
        # graduated degradation: priority classes routers reject while
        # preemption is exhausted fleet-wide (batch first); independent of
        # the binary shed bit, which rejects everything
        self.shed_classes: tuple = ()


class _ProxyState:
    """One node's proxy actor (reference: proxy_state.py ProxyState —
    STARTING -> HEALTHY with ping-based health and restart-on-death)."""

    def __init__(self, handle):
        self.handle = handle
        self.state = "STARTING"  # STARTING | HEALTHY | UNHEALTHY
        self.addresses: dict = {}
        self.ping_ref = None
        self.ping_deadline = 0.0
        self.next_ping_at = 0.0
        # fleet metrics_report polling (obs.clock timeline)
        self.metrics_ref = None
        self.metrics_deadline = 0.0
        self.next_metrics_at = 0.0


class ServeController:
    """State-reconciling controller (runs as a named actor; methods are the
    RPC surface, a daemon thread is the control loop)."""

    def __init__(self, reconcile_period_s: float = 0.2):
        self._lock = threading.RLock()
        # app_name -> {"deployments": {name: _DeploymentState}, "ingress": str,
        #              "route_prefix": str|None}
        self._apps: dict[str, dict] = {}
        self._version = 0
        # router_id -> (ts, {(app, deployment): inflight})
        self._router_metrics: dict[str, tuple[float, dict]] = {}
        # per-node ingress proxies (None until start_proxies): node_id(bytes)
        # -> _ProxyState
        self._proxy_cfg: tuple[dict | None, dict | None] | None = None
        self._proxies: dict[bytes, _ProxyState] = {}
        self._proxy_failures: dict[bytes, int] = {}
        self._stopped = threading.Event()
        self._reconcile_period_s = reconcile_period_s
        self._m_desired = metrics.gauge(
            "llm_autoscale_desired_replicas",
            "Autoscaler's current replica target per deployment",
            tag_keys=("app", "deployment"),
        )
        self._m_draining = metrics.gauge(
            "llm_replicas_draining",
            "Replicas currently draining for graceful scale-down",
            tag_keys=("app", "deployment"),
        )
        self._m_restarts = metrics.counter(
            "serve_controller_restarts_total",
            "Controller boots that recovered state from a checkpoint "
            "(i.e. crash restarts; a fresh start does not count)",
        )
        self._m_recovery = metrics.histogram(
            "serve_controller_recovery_seconds",
            "Wall time of _recover(): checkpoint read -> state rebuilt, "
            "replicas adopted, orphans reaped",
            boundaries=(0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0),
        )
        self._m_orphans = metrics.counter(
            "serve_orphan_replicas_reaped",
            "Live replica actors killed at recovery because the "
            "checkpoint did not know them (mutation crashed before its "
            "checkpoint landed, or their app was deleted mid-outage)",
        )
        # fleet metrics plane: per-source collect_families()
        # snapshots merged + ring-buffered here. Deliberately NOT in the
        # crash checkpoint — the history's job is surviving REPLICA death
        # (the aggregator never forgets a source), while a controller
        # restart re-primes it within one poll period anyway.
        self._fleet = metrics.FleetAggregator(
            history_samples=_FLEET_HISTORY_SAMPLES
        )
        self._next_self_ingest = 0.0
        # fleet trace plane: spans drained from every polled
        # process assemble here; bounded + tail-sampled, and (like the
        # history rings) deliberately NOT checkpointed — a recovered
        # controller re-collects from live traffic within one poll.
        self._traces = TraceStore()
        self._m_spans_ingested = metrics.counter(
            "serve_trace_spans_ingested_total",
            "Spans drained from replica/proxy/controller span buffers "
            "into the fleet TraceStore",
        )
        self._m_trace_ingest_errors = metrics.counter(
            "serve_trace_ingest_errors_total",
            "Polled span drains the TraceStore failed to ingest "
            "(malformed report or store error; spans dropped, logged)",
        )
        self._m_trace_store = metrics.gauge(
            "serve_trace_store_traces",
            "Traces currently resident in the controller's TraceStore",
        )
        # SLO burn-rate monitor (serve/slo.py) over the history rings
        self._slo_specs = tuple(slo_mod.default_slos())
        self._slo_results: list[dict] = []
        self._slo_burning: set[str] = set()
        self._next_slo_eval = 0.0
        self._m_slo_burn = metrics.gauge(
            "serve_slo_burn_rate",
            "Multi-window SLO burn rate (bad_fraction / error budget) "
            "per SLO and evaluation window",
            tag_keys=("slo", "window"),
        )
        self._m_slo_violations = metrics.counter(
            "serve_slo_violations_total",
            "SLO burn alarms raised (every window over its burn "
            "threshold); counted on the not-burning -> burning edge",
            tag_keys=("slo",),
        )
        # crash-recovery checkpointing: _ckpt_io_lock serializes writers
        # (RPC threads + reconciler) so a slow write can't be overtaken
        # by a staler snapshot; _ckpt_dirty marks a failed write for the
        # reconcile loop to retry
        self._ckpt_io_lock = threading.Lock()
        self._ckpt_seq = 0
        self._ckpt_dirty = False
        self._restarts = 0
        self._recovered_at: float | None = None
        self._recovery_s: float | None = None
        try:
            self._recover()
        except Exception:  # noqa: BLE001 — recovery must never brick boot
            logger.exception(
                "serve controller recovery failed; starting fresh"
            )
        self._thread = threading.Thread(
            target=self._reconcile_loop, daemon=True, name="serve-reconciler"
        )
        self._thread.start()

    # ---------------- RPC surface ----------------

    def deploy_application(
        self,
        app_name: str,
        deployment_specs: list[dict],
        ingress: str,
        route_prefix: str | None,
    ) -> None:
        """Set target state for an app (reference: controller.py:635
        deploy_application → reconciler convergence)."""
        with self._lock:
            old = self._apps.get(app_name, {"deployments": {}})
            new_deps: dict[str, _DeploymentState] = {}
            removed: list[_DeploymentState] = []
            for spec in deployment_specs:
                name = spec["name"]
                prev = old["deployments"].get(name)
                ds = _DeploymentState(spec)
                if prev is not None:
                    if self._same_spec(prev.spec, spec):
                        ds.replicas = prev.replicas  # adopt live replicas
                        ds.batch_configs = prev.batch_configs
                        ds.stream_methods = prev.stream_methods
                        ds.signal_capable = prev.signal_capable
                        ds.drain_capable = prev.drain_capable
                        ds.snapshots = prev.snapshots
                        if prev.decider is not None and ds.decider is not None:
                            ds.decider = prev.decider
                    else:
                        # spec changed: the old replicas run stale code —
                        # they must die, not leak
                        removed.append(prev)
                new_deps[name] = ds
            removed.extend(
                d for n, d in old["deployments"].items() if n not in new_deps
            )
            for d in removed:
                d.deleted = True
            self._apps[app_name] = {
                "deployments": new_deps,
                "ingress": ingress,
                "route_prefix": route_prefix,
            }
            self._version += 1
        for d in removed:
            self._stop_replicas(d, len(d.replicas))
        self._checkpoint("deploy")

    def delete_application(self, app_name: str) -> None:
        with self._lock:
            app = self._apps.pop(app_name, None)
            self._version += 1
            if app:
                for d in app["deployments"].values():
                    d.deleted = True
        if app:
            for d in app["deployments"].values():
                self._stop_replicas(d, len(d.replicas))
        self._checkpoint("delete")

    def list_applications(self) -> list[str]:
        with self._lock:
            return list(self._apps)

    def get_routing_table(
        self, router_id: str | None = None, metrics: dict | None = None
    ) -> dict:
        """Routing snapshot for handles/proxies; piggybacks router load
        metrics for autoscaling (reference: long-poll config push,
        serve/_private/long_poll.py — ours is versioned pull)."""
        if router_id is not None and metrics is not None:
            with self._lock:
                self._router_metrics[router_id] = (
                    obs.clock(),
                    {tuple(k): v for k, v in metrics.items()},
                )
        out: dict[str, Any] = {"version": None, "apps": {}}
        with self._lock:
            out["version"] = self._version
            for app_name, app in self._apps.items():
                deps = {}
                for name, ds in app["deployments"].items():
                    # Prefix-aware routing piggyback: each LLM replica's
                    # autoscaling snapshot carries a bounded digest
                    # summary of the prefixes its two cache tiers can
                    # serve (engine.prefix_digest_summary), plus the
                    # block_size/vocab_size constants a router needs to
                    # hash raw prompts into the same chain-digest space.
                    # Non-LLM deployments never report the field, so
                    # their tables stay exactly as before.
                    running = {
                        r.actor_id.binary()
                        for r in ds.replicas if r.state == "RUNNING"
                    }
                    summaries = {}
                    prefix_block = prefix_vocab = None
                    for aid, (_, snap) in ds.snapshots.items():
                        digests = snap.get("prefix_digests")
                        if digests is None or aid not in running:
                            continue
                        summaries[aid] = list(digests)
                        prefix_block = snap.get("block_size", prefix_block)
                        prefix_vocab = snap.get("vocab_size", prefix_vocab)
                    deps[name] = {
                        "replicas": [
                            r.handle for r in ds.replicas if r.state == "RUNNING"
                        ],
                        "max_ongoing_requests": ds.config.max_ongoing_requests,
                        "batch_configs": ds.batch_configs,
                        "stream_methods": ds.stream_methods,
                        # cluster-wide admission: routers raise
                        # EngineOverloadedError pre-dispatch while set, so
                        # doomed requests shed at the edge (503+Retry-After)
                        # instead of queueing behind a saturated fleet
                        "shed": ds.shed,
                        "shed_classes": list(ds.shed_classes),
                        "prefix_summaries": summaries,
                        "prefix_block_size": prefix_block,
                        "prefix_vocab_size": prefix_vocab,
                    }
                out["apps"][app_name] = {
                    "ingress": app["ingress"],
                    "route_prefix": app["route_prefix"],
                    "deployments": deps,
                }
        return out

    def status(self) -> dict:
        with self._lock:
            out: dict[str, Any] = {
                app_name: {
                    name: {
                        "status": ds.status,
                        "target_replicas": ds.target,
                        "running_replicas": sum(
                            1 for r in ds.replicas if r.state == "RUNNING"
                        ),
                        "draining_replicas": sum(
                            1 for r in ds.replicas if r.state == "DRAINING"
                        ),
                        "shedding": ds.shed,
                        "shed_classes": list(ds.shed_classes),
                        "message": ds.last_error or "",
                    }
                    for name, ds in app["deployments"].items()
                }
                for app_name, app in self._apps.items()
            }
            # reserved key (consumers index by app name, so it can't
            # collide): crash-recovery provenance for the load harness /
            # operators — did this controller restart, from what
            # checkpoint, and how long did recovery take
            out["_controller"] = {
                "restarts": self._restarts,
                "recovered_at": self._recovered_at,
                "recovery_seconds": self._recovery_s,
                "checkpoint_version": CHECKPOINT_VERSION,
                "checkpoint_seq": self._ckpt_seq,
            }
            # reserved like _controller: the SLO monitor's latest verdict
            out["slo"] = {
                "burning": sorted(self._slo_burning),
                "results": list(self._slo_results),
            }
            return out

    def scale_deployment(
        self, app_name: str, deployment_name: str, target: int
    ) -> bool:
        """Operator/test surface: set the replica target directly, clamped
        to the autoscaling bounds when configured. Scale-downs go through
        the same graceful drain as policy-driven ones. The chaos load
        harness uses this to schedule a deterministic drain event."""
        with self._lock:
            app = self._apps.get(app_name)
            ds = (app or {"deployments": {}})["deployments"].get(deployment_name)
            if ds is None:
                return False
            target = int(target)
            cfg = ds.config.autoscaling_config
            if cfg is not None:
                target = max(cfg.min_replicas, min(cfg.max_replicas, target))
            ds.target = target
            self._version += 1
        self._checkpoint("target_change")
        return True

    def start_proxies(self, http_options: dict | None,
                      grpc_options: dict | None) -> None:
        """Enable per-node ingress: the reconcile loop keeps one proxy
        actor on every alive node (reference: ProxyStateManager.update).
        Ports should be 0 (ephemeral) unless every node is a distinct
        host; read the bound ports back via proxy_addresses(). Calling
        again clears UNHEALTHY tombstones (crash-looped nodes retry)."""
        with self._lock:
            self._proxy_cfg = (http_options, grpc_options)
            self._proxy_failures.clear()
            for nid in [n for n, ps in self._proxies.items()
                        if ps.state == "UNHEALTHY"]:
                self._proxies.pop(nid)
        self._checkpoint("proxy_cfg")

    def proxy_addresses(self) -> dict:
        """hex node_id -> {"http": (host, port), "grpc": (host, port)}
        for HEALTHY proxies."""
        with self._lock:
            return {
                nid.hex(): dict(ps.addresses)
                for nid, ps in self._proxies.items()
                if ps.state == "HEALTHY"
            }

    def proxy_status(self) -> dict:
        with self._lock:
            return {nid.hex(): ps.state
                    for nid, ps in self._proxies.items()}

    def fleet_metrics(self) -> dict:
        """Fleet metrics plane snapshot: merged families (per-source
        relabeled series first, then rollups with ``replica_id`` dropped)
        plus the Prometheus text rendering — the dashboard serves the
        text at ``/metrics/fleet`` verbatim — and source provenance."""
        fams = self._fleet.fleet_families()
        return {
            "families": fams,
            "text": metrics.render_prometheus(fams),
            "sources": self._fleet.sources(),
        }

    def fleet_history(
        self, series: str | None = None, prefix: str | None = None
    ) -> dict:
        """Ring-buffer time series ``{series_key: [(stamp, value), ...]}``
        stamped on the controller's obs.clock. Sources are never
        forgotten, so series of killed replicas stay queryable — the
        post-mortem counterpart of the live scrape."""
        return self._fleet.history(series=series, prefix=prefix)

    # ---------------- trace plane + SLO RPC surface ----------------

    def trace_list(self, app: str | None = None,
                   status: str | None = None,
                   min_duration_s: float | None = None,
                   limit: int = 100) -> list[dict]:
        """Summaries of collected traces, newest first (the dashboard's
        ``/api/traces``). Filterable by app, tail-retention status
        (error/deadline/shed/preempted/failover/handoff-retry/slow/
        sampled) and minimum duration."""
        return self._traces.list_traces(
            app=app, status=status, min_duration_s=min_duration_s,
            limit=int(limit),
        )

    def trace_get(self, trace_id: str) -> dict | None:
        """One assembled trace tree spanning every collected process
        (``/api/traces/<id>``); None when the store never saw (or has
        evicted) the id."""
        return self._traces.assemble(str(trace_id))

    def trace_spans(self, trace_id: str) -> list[dict] | None:
        """Flat span list of one trace — the chrome-export input."""
        return self._traces.spans_of(str(trace_id))

    def trace_store_stats(self) -> dict:
        return self._traces.stats()

    def trace_push(self, spans: list[dict], source: str = "client") -> int:
        """Driver-side span delivery. The controller cannot poll the
        driver (same asymmetry as the router-side shed counters), so
        clients push their ``tracing.drain_buffered_spans()`` here to
        join the fleet assembly. Returns the number of spans ingested."""
        return self._ingest_trace_report(
            str(source), {"spans": list(spans or ())}, stamp=obs.clock())

    def slo_status(self) -> dict:
        """Latest burn-rate evaluation (``/api/slo``): every spec's
        config plus its multi-window result and exemplar trace ids."""
        return {
            "specs": [
                {
                    "name": s.name, "kind": s.kind,
                    "objective": s.objective,
                    "windows_s": list(s.windows_s),
                    "burn_threshold": s.burn_threshold,
                    "description": s.description,
                }
                for s in self._slo_specs
            ],
            "burning": sorted(self._slo_burning),
            "results": list(self._slo_results),
        }

    def shutdown(self) -> None:
        self._stopped.set()
        # drop the checkpoint FIRST: an intentional teardown must not be
        # resurrected by the next controller boot (crash recovery is for
        # crashes; shutdown means "forget everything")
        try:
            kv_del(CHECKPOINT_KEY, ns=CHECKPOINT_NS)
        except Exception as e:  # noqa: BLE001 — best-effort on teardown
            logger.warning(
                "serve controller checkpoint delete failed: %r", e
            )
        with self._lock:
            apps = list(self._apps.values())
            self._apps.clear()
            proxies = list(self._proxies.values())
            self._proxies.clear()
            self._proxy_cfg = None
        for app in apps:
            for d in app["deployments"].values():
                self._stop_replicas(d, len(d.replicas))
        for ps in proxies:
            if ps.handle is None:
                continue
            try:
                ray_tpu_torch.kill(ps.handle)
            except Exception:  # noqa: BLE001 — already dead is fine
                pass

    # ---------------- reconciliation ----------------

    @staticmethod
    def _ref_ready(ref) -> bool:
        """Non-blocking readiness check that works for results living on
        OTHER nodes: wait() triggers the remote pull, where a bare local
        store.status() would report 'missing' forever. A locally-EVICTED
        result also counts as ready — the call ran; get() reconstructs
        from lineage."""
        ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=0)
        if ready:
            return True
        worker = ray_tpu_torch.worker.global_worker()
        return worker.store.status(ref.object_id) == "evicted"

    @staticmethod
    def _same_spec(a: dict, b: dict) -> bool:
        return (
            a["callable_blob"] == b["callable_blob"]
            and a["init_blob"] == b["init_blob"]
            and a["config"] == b["config"]
        )

    def _reconcile_loop(self) -> None:
        while not self._stopped.wait(self._reconcile_period_s):
            try:
                self._reconcile_once()
            except Exception:  # noqa: BLE001 — the loop must survive
                import traceback

                traceback.print_exc()

    def _reconcile_once(self) -> None:
        with self._lock:
            work = [
                (app_name, name, ds)
                for app_name, app in self._apps.items()
                for name, ds in app["deployments"].items()
            ]
            proxy_cfg = self._proxy_cfg
        changed = False
        for app_name, name, ds in work:
            changed |= self._reconcile_deployment(app_name, name, ds)
        if proxy_cfg is not None:
            self._reconcile_proxies(proxy_cfg)
            self._poll_proxy_metrics()
        self._ingest_self_metrics()
        self._evaluate_slos()
        with self._lock:
            if changed:
                self._version += 1
            dirty = self._ckpt_dirty
        if changed:
            # roster/status drift the explicit mutation sites don't cover
            # (replica promoted/died, drain advanced) still checkpoints —
            # recovery always sees the latest converged picture
            self._checkpoint("reconcile")
        elif dirty:
            self._checkpoint("retry")

    # consecutive proxy-actor deaths before first HEALTHY that stop the
    # respawn loop for that node (mirrors the replica crash-loop guard)
    _MAX_PROXY_START_FAILURES = 3

    def _reconcile_proxies(self, proxy_cfg: tuple) -> None:
        """Desired state: one HEALTHY proxy actor per alive node. Dead or
        ping-failing proxies are removed and recreated next pass; requests
        through the other nodes' proxies keep flowing meanwhile. A node
        whose proxy dies repeatedly before ever becoming healthy (bad
        options, port conflict) flips to a sticky UNHEALTHY tombstone
        visible in proxy_status() instead of respawning 5x/second forever."""
        from ray_tpu_torch.serve.proxy_actor import ProxyActor, proxy_actor_options

        worker = ray_tpu_torch.worker.global_worker()
        try:
            nodes = worker.gcs.call("get_nodes")["nodes"]
        except Exception:  # noqa: BLE001 — GCS hiccup; retry next pass
            return
        alive = {n["node_id"] for n in nodes if n.get("alive")}
        # a wildcard bind must be advertised as the node's REACHABLE ip
        node_ip = {n["node_id"]: n.get("address", "").rsplit(":", 1)[0]
                   for n in nodes}
        now = time.monotonic()
        with self._lock:
            current = dict(self._proxies)
        # reap proxies on dead nodes (and their failure tombstones)
        for nid in list(current):
            if nid not in alive:
                ps = current.pop(nid)
                with self._lock:
                    self._proxies.pop(nid, None)
                    self._proxy_failures.pop(nid, None)
                if ps.handle is not None:
                    try:
                        ray_tpu_torch.kill(ps.handle)
                    except Exception:  # noqa: BLE001
                        pass
        # health-check and promote the rest
        for nid, ps in current.items():
            if ps.state == "UNHEALTHY":
                continue  # sticky tombstone: operator must re-start_proxies
            try:
                info = worker.gcs.call(
                    "get_actor", {"actor_id": ps.handle._actor_id.binary()}
                )["actor"]
            except Exception:  # noqa: BLE001
                info = None
            if (info or {}).get("state") == "DEAD":
                self._proxy_died(nid, ps)
                continue
            if ps.ping_ref is not None:
                if self._ref_ready(ps.ping_ref):
                    try:
                        # ping returns the bound addresses, so promotion
                        # never needs a second, blocking RPC
                        ps.addresses = ray_tpu_torch.get(ps.ping_ref, timeout=5)
                        host, port = ps.addresses.get("http", (None, None))
                        if host in ("0.0.0.0", "::", ""):
                            ps.addresses["http"] = (node_ip.get(nid, host),
                                                    port)
                        ps.state = "HEALTHY"
                        with self._lock:
                            self._proxy_failures.pop(nid, None)
                        ps.next_ping_at = now + 1.0
                    except Exception:  # noqa: BLE001 — failed check
                        self._proxy_died(nid, ps, kill=True)
                    ps.ping_ref = None
                elif now > ps.ping_deadline:
                    self._proxy_died(nid, ps, kill=True)
            elif now >= ps.next_ping_at:
                try:
                    ps.ping_ref = ps.handle.ping.remote()
                    ps.ping_deadline = now + 30.0
                except Exception:  # noqa: BLE001 — dead; reaped above
                    pass
        # start proxies for uncovered nodes
        http_options, grpc_options = proxy_cfg
        with self._lock:
            covered = set(self._proxies)
        for nid in alive - covered:
            try:
                handle = ActorClass(
                    ProxyActor,
                    name=f"RT_SERVE_PROXY:{nid.hex()[:12]}",
                    **proxy_actor_options(nid),
                ).remote(http_options, grpc_options)
            except Exception:  # noqa: BLE001 — e.g. stale name not yet
                continue       # reaped by GCS; retry next pass
            with self._lock:
                if self._proxy_cfg is None:
                    # shutdown raced us between the cfg snapshot and here
                    # — don't leak the just-created actor (mirrors
                    # _start_replica's ds.deleted guard)
                    pass
                else:
                    self._proxies[nid] = _ProxyState(handle)
                    continue
            try:
                ray_tpu_torch.kill(handle)
            except Exception:  # noqa: BLE001
                pass

    def _proxy_died(self, nid: bytes, ps: "_ProxyState",
                    kill: bool = False) -> None:
        """Remove a dead/failed proxy; repeated pre-healthy deaths leave a
        sticky UNHEALTHY tombstone instead of a respawn loop."""
        if kill and ps.handle is not None:
            try:
                ray_tpu_torch.kill(ps.handle)
            except Exception:  # noqa: BLE001
                pass
        with self._lock:
            if ps.state == "STARTING":
                n = self._proxy_failures.get(nid, 0) + 1
                self._proxy_failures[nid] = n
                if n >= self._MAX_PROXY_START_FAILURES:
                    tomb = _ProxyState(None)
                    tomb.state = "UNHEALTHY"
                    self._proxies[nid] = tomb
                    return
            self._proxies.pop(nid, None)

    def _remove_proxy(self, nid: bytes, ps: "_ProxyState") -> None:
        with self._lock:
            self._proxies.pop(nid, None)
        try:
            ray_tpu_torch.kill(ps.handle)
        except Exception:  # noqa: BLE001
            pass

    def _reconcile_deployment(self, app_name: str, name: str, ds: _DeploymentState) -> bool:
        changed = False
        worker = ray_tpu_torch.worker.global_worker()
        # 1. promote STARTING replicas that came alive; drop dead ones.
        # GCS reads happen outside the lock; list mutations under it.
        for r in list(ds.replicas):
            try:
                info = worker.gcs.call(
                    "get_actor", {"actor_id": r.actor_id.binary()}
                )["actor"]
            except Exception:
                continue
            state = (info or {}).get("state")
            if state == "ALIVE" and r.state == "STARTING":
                # non-blocking readiness probe: a slow-starting replica must
                # not stall the reconcile loop (which also drives every other
                # deployment's health checks)
                if r.probe_ref is None:
                    r.probe_ref = r.handle.replica_metadata.remote()
                    r.probe_deadline = time.monotonic() + 120.0
                elif self._ref_ready(r.probe_ref):
                    try:
                        meta = ray_tpu_torch.get(r.probe_ref, timeout=30)
                        with self._lock:
                            ds.batch_configs = meta["batch_configs"]
                            ds.stream_methods = meta["stream_methods"]
                            ds.signal_capable = meta.get(
                                "has_autoscaling_snapshot", False
                            )
                            ds.drain_capable = meta.get("has_drain", False)
                            r.state = "RUNNING"
                            ds.consecutive_start_failures = 0
                        changed = True
                    except Exception as e:  # noqa: BLE001
                        ds.last_error = f"replica probe failed: {e}"
                    r.probe_ref = None
                elif time.monotonic() > getattr(r, "probe_deadline", 0):
                    self._kill_unhealthy(ds, r, "readiness probe timed out")
                    with self._lock:
                        ds.consecutive_start_failures += 1
                    changed = True
            elif state == "DEAD":
                with self._lock:
                    if r in ds.replicas:
                        ds.replicas.remove(r)
                    if r.state == "STARTING":
                        ds.consecutive_start_failures += 1
                    ds.last_error = "replica actor died"
                changed = True
        # 2. health-check RUNNING replicas via ping round-trips
        changed |= self._health_check(ds)
        # 2b. fleet metrics plane: pull metrics_report from every live
        # replica — unconditional, unlike the autoscaling snapshots (every
        # ReplicaActor exposes it; no capability gate, no decider needed)
        self._poll_fleet_metrics(app_name, name, ds)
        # 2c. engine-signal snapshots — polled for every signal-capable
        # deployment (the method self-gates), not just autoscaling ones:
        # the snapshot now carries the prefix-digest summary that feeds
        # prefix-aware routing, which a fixed-size fleet wants too
        self._poll_snapshots(ds)
        # 3. crash-loop detection: repeated death-before-RUNNING means the
        # user code fails at startup — stop respawning, mark UNHEALTHY
        if ds.consecutive_start_failures >= _MAX_CONSECUTIVE_START_FAILURES:
            if ds.status != "UNHEALTHY":
                with self._lock:
                    ds.status = "UNHEALTHY"
                    ds.last_error = (
                        f"{ds.consecutive_start_failures} consecutive replicas "
                        f"died before becoming ready: {ds.last_error or ''}"
                    )
                return True
            return False
        # 4. autoscaling decision — engine signals when the deployment
        # exports AutoscalingSnapshot (serve.llm), router-reported
        # in-flight load otherwise
        if ds.decider is not None:
            running = sum(1 for r in ds.replicas if r.state == "RUNNING")
            new_target = ds.target
            if ds.signal_capable:
                snaps = self._aggregate_signals(ds)
                # decide only on a converged fleet with a full signal set:
                # scaling while a replica warms (or with half the fleet's
                # snapshots stale) would double-count the same saturation
                if running == ds.target and len(snaps) == running and running > 0:
                    new_target = ds.decider.decide_from_signals(snaps, ds.target)
                shed = fleet_saturated(
                    ds.config.autoscaling_config, snaps, ds.target
                )
                shed_cls = shed_classes(
                    ds.config.autoscaling_config, snaps, ds.target
                )
                if shed != ds.shed or shed_cls != ds.shed_classes:
                    with self._lock:
                        ds.shed = shed
                        ds.shed_classes = shed_cls
                    self._checkpoint("shed_flip")
                    changed = True
            else:
                total = self._aggregate_inflight(app_name, name)
                if running > 0 or total > 0:
                    new_target = ds.decider.decide(total, ds.target)
            if new_target != ds.target:
                chaos.fire(
                    "controller_scale",
                    app=app_name,
                    deployment=name,
                    current=ds.target,
                    target=new_target,
                )
                with self._lock:
                    ds.target = new_target
                self._checkpoint("target_change")
                changed = True
            self._m_desired.set(
                ds.target, tags={"app": app_name, "deployment": name}
            )
        # 5. converge replica count (scale-down drains gracefully when the
        # deployment supports it), then advance in-flight drains
        with self._lock:
            live = [r for r in ds.replicas if r.state in ("STARTING", "RUNNING")]
            deficit = ds.target - len(live) if not ds.deleted else 0
            excess = len(live) - ds.target if not ds.deleted else 0
        if deficit > 0:
            for _ in range(deficit):
                self._start_replica(app_name, ds)
                changed = True
        elif excess > 0:
            if ds.drain_capable:
                self._drain_replicas(ds, excess)
            else:
                self._stop_replicas(ds, excess)
            changed = True
        changed |= self._advance_drains(ds)
        with self._lock:
            draining = sum(1 for r in ds.replicas if r.state == "DRAINING")
        self._m_draining.set(
            draining, tags={"app": app_name, "deployment": name}
        )
        # 6. status rollup
        with self._lock:
            running = sum(1 for r in ds.replicas if r.state == "RUNNING")
            new_status = "HEALTHY" if running >= ds.target else "UPDATING"
            if new_status != ds.status:
                ds.status = new_status
                changed = True
        return changed

    def _health_check(self, ds: _DeploymentState) -> bool:
        """Ping RUNNING replicas (reference: deployment_state health-check
        loop driving user check_health via the replica actor). A replica
        whose ping doesn't land within 3 periods is killed and replaced by
        the convergence step."""
        period = ds.config.health_check_period_s
        if period <= 0:
            return False
        now = time.monotonic()
        changed = False
        for r in list(ds.replicas):
            if r.state != "RUNNING":
                continue
            if r.ping_ref is not None:
                if self._ref_ready(r.ping_ref):
                    try:
                        ray_tpu_torch.get(r.ping_ref, timeout=1)
                        r.ping_ref = None
                        r.next_ping_at = now + period
                    except Exception as e:  # noqa: BLE001 — failed check
                        self._kill_unhealthy(ds, r, f"health check failed: {e}")
                        changed = True
                elif now > r.ping_deadline:
                    self._kill_unhealthy(ds, r, "health check timed out")
                    changed = True
            elif now >= r.next_ping_at:
                try:
                    r.ping_ref = r.handle.ping.remote()
                    # Pings share the replica's one-at-a-time queue with data
                    # calls, so the deadline must exceed worst-case request
                    # latency (handles allow 120s) — this catches truly
                    # wedged replicas, not slow ones.
                    r.ping_deadline = now + max(6 * period, 150.0)
                except Exception:  # noqa: BLE001 — dead; step 1 reaps it
                    pass
        return changed

    def _kill_unhealthy(self, ds: _DeploymentState, r, reason: str) -> None:
        with self._lock:
            if r in ds.replicas:
                ds.replicas.remove(r)
            ds.last_error = reason
        # terminal span flush: a replica that failed its health check can
        # often still answer one last actor-level drain (a dead ENGINE
        # leaves the actor alive — the common failover case). Without it,
        # the kill races the 0.5s poll and the spans of the requests that
        # died WITH the engine are lost — precisely the traces tail
        # retention exists to keep. Bounded small so a truly dead process
        # can't stall the reconcile loop; only the trace buffer is taken
        # (the metrics families stay last-known in the aggregator).
        try:
            rep = ray_tpu_torch.get(r.handle.metrics_report.remote(), timeout=3)
            self._ingest_trace_report(
                f"replica:{r.actor_id.hex()[:12]}", rep, stamp=obs.clock()
            )
        except Exception:  # noqa: BLE001 — process is gone; its buffered
            pass           # spans die with it
        try:
            ray_tpu_torch.kill(r.handle)
        except Exception:  # noqa: BLE001
            pass

    def _aggregate_inflight(self, app_name: str, dep_name: str) -> float:
        """Sum router-reported in-flight load (one-clock rule: freshness
        judged on obs.clock, the same clock get_routing_table stamps)."""
        now = obs.clock()
        total = 0.0
        with self._lock:
            for rid, (ts, m) in list(self._router_metrics.items()):
                if now - ts > _METRIC_TTL_S:
                    del self._router_metrics[rid]
                    continue
                total += m.get((app_name, dep_name), 0.0)
        return total

    def _poll_snapshots(self, ds: _DeploymentState) -> None:
        """Pull AutoscalingSnapshot from every RUNNING replica of a
        signal-capable deployment, non-blocking (same ref discipline as
        pings/probes: a slow replica must not stall the reconcile loop).
        Snapshots are stamped with obs.clock at arrival (one-clock rule);
        _aggregate_signals judges freshness on the same clock."""
        if not ds.signal_capable:
            return
        now = obs.clock()
        for r in list(ds.replicas):
            if r.state != "RUNNING":
                continue
            if r.snapshot_ref is not None:
                if self._ref_ready(r.snapshot_ref):
                    try:
                        snap = ray_tpu_torch.get(r.snapshot_ref, timeout=5)
                        with self._lock:
                            ds.snapshots[r.actor_id.binary()] = (now, snap)
                    except Exception:  # noqa: BLE001 — dead/failing replica;
                        pass           # the health check owns its fate
                    r.snapshot_ref = None
                    r.next_snapshot_at = now + _SNAPSHOT_PERIOD_S
                elif now > r.snapshot_deadline:
                    r.snapshot_ref = None
                    r.next_snapshot_at = now + _SNAPSHOT_PERIOD_S
            elif now >= r.next_snapshot_at:
                try:
                    r.snapshot_ref = r.handle.rt_call.remote(
                        "autoscaling_snapshot", (), {}
                    )
                    r.snapshot_deadline = now + _SNAPSHOT_TIMEOUT_S
                except Exception:  # noqa: BLE001 — dead; step 1 reaps it
                    pass

    def _poll_fleet_metrics(
        self, app_name: str, name: str, ds: _DeploymentState
    ) -> None:
        """Pull ``metrics_report()`` from every live replica into the
        fleet aggregator, non-blocking (same ref discipline as pings and
        snapshot polls: a slow replica must not stall the reconcile
        loop). Reports are ingested with the CONTROLLER's obs.clock as
        the stamp — per-process perf_counter timelines aren't comparable
        across actors, so last-write ordering and history stamps ride one
        clock: ours. Dispatched actor-level (not rt_call): the poll must
        never queue behind a saturated data plane. DRAINING replicas
        still report — their in-flight streams keep moving counters until
        retirement, and the history keeps their series after it."""
        now = obs.clock()
        for r in list(ds.replicas):
            if r.state not in ("RUNNING", "DRAINING"):
                continue
            if r.metrics_ref is not None:
                if self._ref_ready(r.metrics_ref):
                    try:
                        rep = ray_tpu_torch.get(r.metrics_ref, timeout=5)
                        self._fleet.ingest(
                            f"replica:{r.actor_id.hex()}",
                            rep["families"],
                            {
                                "app": app_name,
                                "deployment": name,
                                "replica_id": r.actor_id.hex(),
                                # the reference's label; one pool until
                                # A9 brings the handoff
                                "pool_role": "",
                            },
                            stamp=now,
                        )
                        self._ingest_trace_report(
                            f"replica:{r.actor_id.hex()[:12]}", rep,
                            stamp=now,
                        )
                    except Exception:  # noqa: BLE001 — dead/failing
                        pass           # replica; the health check owns it
                    r.metrics_ref = None
                    r.next_metrics_at = now + _FLEET_PERIOD_S
                elif now > r.metrics_deadline:
                    r.metrics_ref = None
                    r.next_metrics_at = now + _FLEET_PERIOD_S
            elif now >= r.next_metrics_at:
                try:
                    r.metrics_ref = r.handle.metrics_report.remote()
                    r.metrics_deadline = now + _FLEET_TIMEOUT_S
                except Exception:  # noqa: BLE001 — dead; step 1 reaps it
                    pass

    def _poll_proxy_metrics(self) -> None:
        """Same non-blocking metrics_report pull over HEALTHY per-node
        proxies — the serve_* ingress counters (shed responses, access
        status codes) live in proxy processes, not in any replica."""
        now = obs.clock()
        with self._lock:
            current = list(self._proxies.items())
        for nid, ps in current:
            if ps.state != "HEALTHY" or ps.handle is None:
                continue
            if ps.metrics_ref is not None:
                if self._ref_ready(ps.metrics_ref):
                    try:
                        rep = ray_tpu_torch.get(ps.metrics_ref, timeout=5)
                        self._fleet.ingest(
                            f"proxy:{nid.hex()}",
                            rep["families"],
                            {
                                "deployment": "_proxy",
                                "replica_id": f"proxy:{nid.hex()[:12]}",
                            },
                            stamp=now,
                        )
                        self._ingest_trace_report(
                            f"proxy:{nid.hex()[:12]}", rep, stamp=now,
                        )
                    except Exception:  # noqa: BLE001 — dead/failing
                        pass           # proxy; its ping path owns it
                    ps.metrics_ref = None
                    ps.next_metrics_at = now + _FLEET_PERIOD_S
                elif now > ps.metrics_deadline:
                    ps.metrics_ref = None
                    ps.next_metrics_at = now + _FLEET_PERIOD_S
            elif now >= ps.next_metrics_at:
                try:
                    ps.metrics_ref = ps.handle.metrics_report.remote()
                    ps.metrics_deadline = now + _FLEET_TIMEOUT_S
                except Exception:  # noqa: BLE001 — dead; reaped above
                    pass

    def _ingest_self_metrics(self) -> None:
        """Fold the controller's OWN registry (autoscale targets, drain
        gauges, recovery counters) into the fleet plane, so one scrape
        target really does cover the whole control+data plane."""
        now = obs.clock()
        if now < self._next_self_ingest:
            return
        self._next_self_ingest = now + _FLEET_PERIOD_S
        self._fleet.ingest(
            "controller",
            metrics.collect_families(),
            {"deployment": "_controller", "replica_id": "controller"},
            stamp=now,
        )
        # the controller process records spans too (driver-side clients
        # sharing this process); same drain, same store
        self._ingest_trace_report(
            "controller", {"spans": tracing.drain_buffered_spans()},
            stamp=now,
        )

    def _ingest_trace_report(self, source: str, rep: dict,
                             stamp: float) -> int:
        """Fold one polled report's piggybacked span drain into the
        TraceStore. Must never raise (it sits on the non-blocking poll
        path) and must never swallow silently either — failures are
        counted and logged (sanitizer-lint enforced). Returns the number
        of spans the store accepted."""
        spans = rep.get("spans") or ()
        if not spans:
            return 0
        try:
            n = self._traces.ingest(list(spans), source=source, stamp=stamp)
            if n:
                self._m_spans_ingested.inc(n)
            self._m_trace_store.set(float(len(self._traces)))
            return n
        except Exception as e:  # noqa: BLE001 — poll path stays alive
            self._m_trace_ingest_errors.inc()
            logger.warning("trace ingest from %s failed: %r", source, e)
            return 0

    def _evaluate_slos(self) -> None:
        """Evaluate the declarative SLO specs over the fleet history
        rings (multi-window burn rates — serve/slo.py), refresh the
        ``serve_slo_burn_rate`` gauges, count newly-burning violations,
        and attach exemplar trace ids from the TraceStore — the link
        from a burning SLO back to the traces that show why."""
        now = obs.clock()
        if now < self._next_slo_eval:
            return
        self._next_slo_eval = now + _SLO_EVAL_PERIOD_S
        try:
            results = slo_mod.evaluate(
                self._slo_specs, self._fleet.history(), now
            )
        except Exception as e:  # noqa: BLE001 — monitor must not kill
            logger.warning("slo evaluation failed: %r", e)  # the loop
            return
        specs = {s.name: s for s in self._slo_specs}
        burning_now: set[str] = set()
        for res in results:
            spec = specs[res["name"]]
            for wname, w in res["windows"].items():
                self._m_slo_burn.set(
                    w["burn_rate"], tags={"slo": res["name"],
                                          "window": wname},
                )
            res["exemplar_trace_ids"] = []
            if res["burning"]:
                burning_now.add(res["name"])
                if res["name"] not in self._slo_burning:
                    self._m_slo_violations.inc(tags={"slo": res["name"]})
                if spec.exemplar == "slowest_ttft":
                    res["exemplar_trace_ids"] = self._traces.exemplar_ids(
                        slowest_ttft=True)
                else:
                    res["exemplar_trace_ids"] = (
                        self._traces.exemplar_ids(flags=(spec.exemplar,))
                        or self._traces.exemplar_ids(slowest_ttft=True)
                    )
        self._slo_burning = burning_now
        self._slo_results = results

    def _aggregate_signals(self, ds: _DeploymentState) -> list[dict]:
        """Fresh snapshots, one per RUNNING replica (stale or orphaned
        entries pruned). Freshness is judged on obs.clock against
        AutoscalingConfig.signal_ttl_s — same clock the poll stamped."""
        now = obs.clock()
        cfg = ds.config.autoscaling_config
        ttl = cfg.signal_ttl_s if cfg is not None else _METRIC_TTL_S
        out = []
        with self._lock:
            running = {
                r.actor_id.binary()
                for r in ds.replicas
                if r.state == "RUNNING"
            }
            for aid in list(ds.snapshots):
                ts, snap = ds.snapshots[aid]
                if aid not in running or now - ts > ttl:
                    del ds.snapshots[aid]
                    continue
                out.append(snap)
        return out

    def _drain_replicas(self, ds: _DeploymentState, n: int) -> None:
        """Graceful scale-down: STARTING victims (serving nothing) die
        immediately; RUNNING victims — least-loaded first, by their last
        snapshot's active_streams — flip to DRAINING, which removes them
        from the routing table (only RUNNING replicas are routed) while
        their in-flight streams keep decoding. _advance_drains retires
        them once idle (after release_all) or at the drain deadline."""
        to_kill: list[_ReplicaState] = []
        to_drain: list[_ReplicaState] = []
        with self._lock:
            starting = [r for r in ds.replicas if r.state == "STARTING"]
            to_kill = starting[:n]
            want = n - len(to_kill)
            if want > 0:
                def load(r):
                    entry = ds.snapshots.get(r.actor_id.binary())
                    return entry[1].get("active_streams", 0) if entry else 0

                running = sorted(
                    (r for r in ds.replicas if r.state == "RUNNING"), key=load
                )
                to_drain = running[:want]
            for r in to_kill:
                ds.replicas.remove(r)
            # drain deadlines ride obs.clock so the checkpoint can
            # persist remaining-time and recovery can resume the countdown
            # on the same clock (one-clock rule)
            deadline = (
                obs.clock() + ds.config.graceful_shutdown_timeout_s
            )
            for r in to_drain:
                r.state = "DRAINING"
                r.drain_deadline = deadline
                r.drain_ref = None
                r.finish_ref = None
        for r in to_kill:
            try:
                ray_tpu_torch.kill(r.handle)
            except Exception:  # noqa: BLE001 — already dead is fine
                pass
        if to_drain:
            # persist the drain BEFORE prepare_drain lands: a controller
            # crash right after this point must recover replicas already
            # latched non-admitting as DRAINING, not as routable RUNNING
            self._checkpoint("drain_start")
        for r in to_drain:
            try:
                # prepare_drain stops admissions replica-side and returns a
                # drain_status dict, so it doubles as the first poll
                r.drain_ref = r.handle.rt_call.remote("prepare_drain", (), {})
            except Exception:  # noqa: BLE001 — dead; step 1 reaps it
                pass

    def _advance_drains(self, ds: _DeploymentState) -> bool:
        """Drive DRAINING replicas to retirement. States per replica:
        polling drain_status (finish or hand off in-flight streams) ->
        finish_drain once idle (release_all returns every KV block) ->
        kill + leave ds.replicas. A replica that dies mid-drain — or one
        still serving at the deadline — is killed as-is: its streams
        resume byte-identically on survivors via the failover path.
        Deadlines ride obs.clock (checkpointed as remaining-time, so a
        recovered controller resumes the countdown, not restarts it)."""
        changed = False
        now = obs.clock()
        for r in [r for r in ds.replicas if r.state == "DRAINING"]:
            if r.finish_ref is not None:
                # releasing: wait for finish_drain's release_all to land
                if self._ref_ready(r.finish_ref) or now > r.drain_deadline:
                    self._retire_drained(ds, r)
                    changed = True
                continue
            idle = False
            dead = False
            if r.drain_ref is not None:
                if self._ref_ready(r.drain_ref):
                    try:
                        status = ray_tpu_torch.get(r.drain_ref, timeout=5)
                        idle = status.get("active_streams", 0) == 0
                    except Exception:  # noqa: BLE001 — died mid-drain; the
                        dead = True    # failover path owns its streams
                    r.drain_ref = None
            else:
                try:
                    r.drain_ref = r.handle.rt_call.remote(
                        "drain_status", (), {}
                    )
                except Exception:  # noqa: BLE001
                    dead = True
            if dead:
                self._retire_drained(ds, r)
                changed = True
            elif idle:
                try:
                    r.finish_ref = r.handle.rt_call.remote(
                        "finish_drain", (), {}
                    )
                    # short grace for the block release to land
                    r.drain_deadline = now + 5.0
                except Exception:  # noqa: BLE001
                    self._retire_drained(ds, r)
                changed = True
            elif now > r.drain_deadline:
                self._retire_drained(ds, r)
                changed = True
        return changed

    def _retire_drained(self, ds: _DeploymentState, r: _ReplicaState) -> None:
        with self._lock:
            if r in ds.replicas:
                ds.replicas.remove(r)
            ds.snapshots.pop(r.actor_id.binary(), None)
        try:
            ray_tpu_torch.kill(r.handle)
        except Exception:  # noqa: BLE001 — already dead is fine
            pass
        self._checkpoint("drain_finish")

    def _start_replica(self, app_name: str, ds: _DeploymentState) -> None:
        spec = ds.spec
        opts = dict(ds.config.ray_actor_options)
        num_cpus = opts.pop("num_cpus", 1)
        # whole cards: the raylet hands a replica CUDA_VISIBLE_DEVICES
        # slots, and a fraction raises in ActorClass
        num_gpus = opts.pop("num_gpus", 0)
        # replicas serve up to max_ongoing_requests concurrently on the
        # worker's method pool (reference: replicas are async actors bounded
        # by max_ongoing_requests) — overridable via ray_actor_options
        max_concurrency = int(
            opts.pop("max_concurrency", 0) or ds.config.max_ongoing_requests or 1
        )
        resources = dict(opts.pop("resources", None) or {})
        # remaining numeric keys are custom resources — never drop them
        # silently
        for k in list(opts):
            v = opts.pop(k)
            if isinstance(v, (int, float)):
                resources[k] = float(v)
            else:
                raise ValueError(
                    f"unsupported ray_actor_options key {k!r} for deployment "
                    f"{spec['name']!r}"
                )
        actor_cls = ActorClass(
            ReplicaActor,
            num_cpus=num_cpus,
            num_gpus=num_gpus,
            resources=resources or None,
            max_restarts=0,  # the reconciler owns restarts, not the raylet
            # headroom beyond the data-plane bound so control calls (ping /
            # autoscaling_snapshot / drain_status) don't park behind
            # max_ongoing_requests concurrent streams; routers still cap
            # data dispatches at max_ongoing_requests
            max_concurrency=max_concurrency + _CONTROL_SLOTS,
        )
        handle = actor_cls.remote(
            spec["name"],
            spec["callable_blob"],
            spec["init_blob"],
            ds.config.user_config,
            max_concurrency,
        )
        rs = _ReplicaState(handle)
        appended = False
        with self._lock:
            if ds.deleted:
                # deleted while we were starting it — don't leak the actor
                pass
            else:
                ds.replicas.append(rs)
                appended = True
        if appended:
            # the actor exists but no checkpoint knows it yet: a crash in
            # this window leaks a replica unless recovery reaps it — the
            # kill fire makes the window a deterministic chaos site for
            # exactly that orphan-reconciliation proof
            chaos.fire(
                "controller.kill",
                reason="replica_starting",
                deployment=spec["name"],
            )
            self._checkpoint("replica_added")
            return
        try:
            ray_tpu_torch.kill(handle)
        except Exception:  # noqa: BLE001
            pass

    def _stop_replicas(self, ds: _DeploymentState, n: int) -> None:
        with self._lock:
            victims, keep = ds.replicas[:n], ds.replicas[n:]
            ds.replicas = keep
        for r in victims:
            try:
                ray_tpu_torch.kill(r.handle)
            except Exception:  # noqa: BLE001 — already dead is fine
                pass
        if victims:
            self._checkpoint("replica_stopped")

    # ---------------- crash-recovery checkpointing ----------------

    def _checkpoint(self, reason: str) -> None:
        """Persist desired state + replica roster to the GCS internal KV.

        Called after every state mutation (deploy/delete, target change,
        shed flip, drain start/finish, replica add/retire, proxy config).
        The write is one atomic kv_put of a small JSON blob — there is no
        half-written state to recover from. A failed write degrades to
        warn-and-retry (_ckpt_dirty; the reconcile loop retries every
        pass), never an inconsistent controller. The ``controller.kill``
        fire after a SUCCESSFUL write is the chaos anchor crash-recovery
        tests kill at, so the checkpoint provably contains the mutation
        the test expects recovery to honor."""
        if self._stopped.is_set():
            return  # tearing down: shutdown() already deleted the key
        with self._ckpt_io_lock:
            with self._lock:
                self._ckpt_dirty = False
                self._ckpt_seq += 1
                payload = self._build_checkpoint_locked()
            try:
                chaos.fire(
                    "controller.checkpoint", reason=reason,
                    seq=payload["seq"],
                )
                kv_put(
                    CHECKPOINT_KEY, encode_checkpoint(payload),
                    ns=CHECKPOINT_NS,
                )
            except Exception as e:  # noqa: BLE001 — degrade, never crash
                with self._lock:
                    self._ckpt_dirty = True
                logger.warning(
                    "serve controller checkpoint write failed (%s), "
                    "will retry: %r", reason, e,
                )
                return
        chaos.fire("controller.kill", reason=reason)

    def _build_checkpoint_locked(self) -> dict:
        """Snapshot desired state + roster (caller holds self._lock)."""
        now = obs.clock()
        apps: dict[str, Any] = {}
        for app_name, app in self._apps.items():
            deps = {}
            for name, ds in app["deployments"].items():
                deps[name] = {
                    "spec_blob": encode_spec(ds.spec),
                    "target": ds.target,
                    "status": ds.status,
                    # shed is persisted for inspection only; recovery
                    # recomputes it from fresh snapshots (see _recover)
                    "shed": ds.shed,
                    "shed_classes": list(ds.shed_classes),
                    "signal_capable": ds.signal_capable,
                    "drain_capable": ds.drain_capable,
                    "batch_configs": ds.batch_configs,
                    "stream_methods": list(ds.stream_methods),
                    "replicas": [
                        {
                            "actor_id": r.actor_id.hex(),
                            "state": r.state,
                            # remaining time, not an absolute deadline:
                            # obs.clock doesn't survive the process
                            "drain_remaining_s": (
                                max(0.0, r.drain_deadline - now)
                                if r.state == "DRAINING"
                                else None
                            ),
                        }
                        for r in ds.replicas
                        if r.state != "STOPPING"
                    ],
                }
            apps[app_name] = {
                "ingress": app["ingress"],
                "route_prefix": app["route_prefix"],
                "deployments": deps,
            }
        return {
            "version": CHECKPOINT_VERSION,
            "seq": self._ckpt_seq,
            "written_at": obs.wall(),
            "restarts": self._restarts,
            "reconciler_version": self._version,
            "apps": apps,
            "proxy_cfg": (
                list(self._proxy_cfg) if self._proxy_cfg else None
            ),
        }

    def _recover(self) -> None:
        """Rebuild state from the last checkpoint after a crash restart.

        Steps: load + validate the checkpoint (unknown versions are
        rejected loudly — boot fresh rather than guess); re-resolve each
        checkpointed replica actor against the GCS, adopting live ones
        (RUNNING replicas re-enter the ping path immediately, DRAINING
        ones resume their drain with the checkpointed remaining time and
        an idempotent re-latch of prepare_drain); reap orphan replica
        actors the checkpoint doesn't know — they were created in the
        window between a mutation and its checkpoint, or belong to an
        app deleted mid-outage; re-adopt per-node proxies by name. Shed
        flags are NOT restored: fresh autoscaling snapshots recompute
        them within a reconcile pass, so a stale flag from before the
        crash can't fail-close a now-healthy fleet. Idempotent — running
        it twice converges to the same state."""
        chaos.fire("controller.recover")
        t0 = obs.clock()
        try:
            blob = kv_get(CHECKPOINT_KEY, ns=CHECKPOINT_NS)
        except Exception as e:  # noqa: BLE001 — GCS unreachable
            logger.error(
                "controller recovery: checkpoint read failed: %r", e
            )
            return
        if blob is None:
            return  # fresh boot: nothing to recover, nothing to reap
        try:
            ckpt = decode_checkpoint(bytes(blob))
        except Exception as e:  # noqa: BLE001 — unknown version/corrupt:
            logger.error(        # refuse to guess; boot fresh and loud
                "controller recovery: checkpoint rejected: %r", e
            )
            return
        known: set[bytes] = set()
        apps: dict[str, dict] = {}
        adopted = 0
        for app_name, app in ckpt["apps"].items():
            deps: dict[str, _DeploymentState] = {}
            for name, d in app["deployments"].items():
                try:
                    ds = _DeploymentState(decode_spec(d["spec_blob"]))
                except Exception as e:  # noqa: BLE001 — one bad spec
                    logger.error(       # must not sink the whole recovery
                        "controller recovery: spec for %s/%s unreadable, "
                        "dropping the deployment: %r", app_name, name, e,
                    )
                    continue
                ds.target = int(d["target"])
                ds.signal_capable = bool(d.get("signal_capable"))
                ds.drain_capable = bool(d.get("drain_capable"))
                ds.batch_configs = d.get("batch_configs") or {}
                ds.stream_methods = list(d.get("stream_methods") or ())
                for rep in d.get("replicas", ()):
                    aid = bytes.fromhex(rep["actor_id"])
                    known.add(aid)
                    r = self._adopt_replica(aid, rep, ds.config)
                    if r is not None:
                        ds.replicas.append(r)
                        adopted += 1
                deps[name] = ds
            apps[app_name] = {
                "deployments": deps,
                "ingress": app["ingress"],
                "route_prefix": app.get("route_prefix"),
            }
        reaped = self._reap_orphans(known)
        proxies = self._readopt_proxies(ckpt.get("proxy_cfg"))
        with self._lock:
            self._apps = apps
            self._proxies = proxies
            pc = ckpt.get("proxy_cfg")
            if pc is not None:
                self._proxy_cfg = (pc[0], pc[1])
            self._ckpt_seq = int(ckpt["seq"])
            self._restarts = int(ckpt.get("restarts", 0)) + 1
            # keep routing-table versions advancing across restarts so
            # proxy route-sync loops never skip the post-recovery update
            self._version = int(ckpt.get("reconciler_version", 0)) + 1
        self._m_restarts.inc()
        self._recovery_s = obs.clock() - t0
        self._m_recovery.observe(self._recovery_s)
        self._recovered_at = obs.wall()
        logger.warning(
            "serve controller recovered from checkpoint seq=%s: %d app(s), "
            "%d replica(s) adopted, %d orphan(s) reaped, in %.3fs",
            ckpt["seq"], len(apps), adopted, reaped, self._recovery_s,
        )
        self._checkpoint("recovered")

    def _adopt_replica(
        self, aid: bytes, rep: dict, cfg: DeploymentConfig
    ) -> _ReplicaState | None:
        """Re-resolve one checkpointed replica actor; None when it died
        during the outage (the convergence step replaces it)."""
        worker = ray_tpu_torch.worker.global_worker()
        try:
            info = worker.gcs.call("get_actor", {"actor_id": aid})["actor"]
        except Exception as e:  # noqa: BLE001 — GCS hiccup: treat as dead
            logger.warning(
                "controller recovery: get_actor(%s) failed: %r",
                aid.hex(), e,
            )
            return None
        if info is None or info.get("state") == "DEAD":
            return None
        r = _ReplicaState(
            ActorHandle(ActorID(aid), info.get("class_name", "ReplicaActor"))
        )
        state = rep.get("state", "STARTING")
        if state == "RUNNING":
            # adopt via the existing ping path: next_ping_at=0 makes the
            # first health-check pass validate it NOW; a replica wedged
            # during the outage is killed and replaced like any other
            r.state = "RUNNING"
            r.next_ping_at = 0.0
        elif state == "DRAINING":
            r.state = "DRAINING"
            remaining = rep.get("drain_remaining_s")
            if remaining is None:
                remaining = cfg.graceful_shutdown_timeout_s
            r.drain_deadline = obs.clock() + float(remaining)
            try:
                # idempotent re-latch: the pre-crash prepare_drain may or
                # may not have landed; this also doubles as the first
                # drain_status poll for _advance_drains
                r.drain_ref = r.handle.rt_call.remote(
                    "prepare_drain", (), {}
                )
            except Exception as e:  # noqa: BLE001 — died just now; the
                logger.warning(     # reconcile pass reaps it
                    "controller recovery: prepare_drain re-latch failed "
                    "for %s: %r", aid.hex(), e,
                )
        # STARTING replicas stay STARTING: the readiness probe re-runs
        return r

    def _reap_orphans(self, known: set[bytes]) -> int:
        """Kill live ReplicaActors the checkpoint doesn't know. Only ever
        called with a checkpoint in hand — a fresh boot must not reap
        (it has no roster to judge against)."""
        worker = ray_tpu_torch.worker.global_worker()
        try:
            actors = worker.gcs.call("list_actors")["actors"]
        except Exception as e:  # noqa: BLE001 — skip the sweep this boot
            logger.warning(
                "controller recovery: list_actors failed, orphan sweep "
                "skipped: %r", e,
            )
            return 0
        reaped = 0
        for a in actors:
            if a.get("class_name") != "ReplicaActor":
                continue
            if a.get("state") == "DEAD" or a["actor_id"] in known:
                continue
            try:
                ray_tpu_torch.kill(
                    ActorHandle(ActorID(a["actor_id"]), "ReplicaActor")
                )
                reaped += 1
            except Exception as e:  # noqa: BLE001 — died on its own
                logger.warning(
                    "controller recovery: orphan %s kill failed: %r",
                    a["actor_id"].hex(), e,
                )
        if reaped:
            self._m_orphans.inc(reaped)
            logger.warning(
                "controller recovery: reaped %d orphan replica(s) the "
                "checkpoint did not know", reaped,
            )
        return reaped

    def _readopt_proxies(
        self, proxy_cfg
    ) -> dict[bytes, "_ProxyState"]:
        """Re-adopt per-node proxy actors by their well-known names.
        Adopted proxies re-enter the ping path as STARTING, which
        re-learns their bound addresses without a restart."""
        proxies: dict[bytes, _ProxyState] = {}
        if proxy_cfg is None:
            return proxies
        worker = ray_tpu_torch.worker.global_worker()
        try:
            nodes = worker.gcs.call("get_nodes")["nodes"]
        except Exception as e:  # noqa: BLE001 — reconcile restarts them
            logger.warning(
                "controller recovery: get_nodes failed, proxies will be "
                "restarted by reconcile: %r", e,
            )
            return proxies
        for n in nodes:
            if not n.get("alive"):
                continue
            nid = n["node_id"]
            try:
                handle = ray_tpu_torch.get_actor(
                    f"RT_SERVE_PROXY:{nid.hex()[:12]}"
                )
            except ValueError:
                logger.info(
                    "controller recovery: no proxy on node %s yet",
                    nid.hex()[:12],
                )
                continue  # reconcile starts one
            proxies[nid] = _ProxyState(handle)
        return proxies
