"""Per-node ingress proxy actor, controller-managed (the port's copy of
``ray_tpu/serve/proxy_actor.py``, HTTP only: the port has no gRPC ingress,
ROADMAP A8).

Equivalent of the reference's proxy actors (reference:
python/ray/serve/_private/proxy_state.py:1 ProxyStateManager — the
controller keeps one HTTP proxy actor per node with health states
and restarts them on failure; default_impl.py wires it up). The actor
hosts the same HTTPProxy server the dev-mode driver path
uses, plus a route-sync thread that pulls the controller's versioned
routing table (the same pull protocol handles use) so `serve.run`d route
prefixes appear on every node without any push plumbing.
"""
from __future__ import annotations

import threading
import time

_ROUTE_SYNC_PERIOD_S = 0.25
_NO_GRPC = ("the port has no gRPC ingress yet (grpcio is not on the card's "
            "machine; ROADMAP A8): pass grpc_options=None")


class ProxyActor:
    """Runs on one node; owns that node's ingress servers."""

    def __init__(self, http_options: dict | None,
                 grpc_options: dict | None):
        from ray_tpu_torch.serve.config import HTTPOptions

        if grpc_options is not None:
            raise NotImplementedError(_NO_GRPC)
        self._http = None
        if http_options is not None:
            from ray_tpu_torch.serve.proxy import HTTPProxy

            self._http = HTTPProxy(HTTPOptions(**http_options))
            self._http.start()
        self._stopped = threading.Event()
        self._route_version = None
        if self._http is not None:
            self._sync_thread = threading.Thread(
                target=self._route_sync_loop, daemon=True,
                name="serve-proxy-route-sync")
            self._sync_thread.start()

    # -- controller surface --

    def ping(self) -> dict:
        """Health probe; carries the bound addresses so the controller
        never needs a second (potentially blocking) RPC to learn them."""
        return self.addresses()

    def addresses(self) -> dict:
        """Bound (host, port) per protocol — ports may be ephemeral."""
        out = {}
        if self._http is not None:
            out["http"] = (self._http.options.host, self._http.port)
        return out

    def metrics_report(self) -> dict:
        """Fleet-plane snapshot of this proxy process's registry (the
        serve_* ingress counters live here, not in any replica). Same
        shape as ReplicaActor.metrics_report (incl. the piggybacked
        span-buffer drain for the fleet trace plane)."""
        from ray_tpu_torch.util import metrics, tracing

        return {
            "clock": time.perf_counter(),
            "wall": time.time(),
            "families": metrics.collect_families(),
            "spans": tracing.drain_buffered_spans(),
        }

    def stop(self) -> str:
        self._stopped.set()
        if self._http is not None:
            self._http.stop()
        return "stopped"

    # -- route sync --

    def _route_sync_loop(self) -> None:
        import ray_tpu_torch
        from ray_tpu_torch.serve.controller import CONTROLLER_NAME

        controller = None
        while not self._stopped.wait(_ROUTE_SYNC_PERIOD_S):
            try:
                if controller is None:
                    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
                table = ray_tpu_torch.get(
                    controller.get_routing_table.remote(), timeout=30)
            except Exception:  # noqa: BLE001 — controller down/restarting
                controller = None
                continue
            if table["version"] == self._route_version:
                continue
            self._route_version = table["version"]
            self._http.replace_routes({
                app["route_prefix"]: (app_name, app["ingress"])
                for app_name, app in table["apps"].items()
                if app.get("route_prefix")
            })


def proxy_actor_options(node_id: bytes) -> dict:
    """ActorClass kwargs pinning one proxy to one node."""
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    return {
        "num_cpus": 0.1,
        "scheduling_strategy": NodeAffinitySchedulingStrategy(
            node_id=node_id, soft=False),
    }
