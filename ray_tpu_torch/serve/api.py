"""Serve public API: run / start / status / delete / shutdown / handles
(the port's copy of ``ray_tpu/serve/api.py``; the HTTP ingress is the
standard-library proxy of ``proxy.py``, and there is no gRPC ingress:
``start(grpc_options=...)`` raises).

Equivalent of the reference's serve api surface
(reference: python/ray/serve/api.py — serve.run:479, serve.start,
serve.status, serve.delete, serve.shutdown; handle getters
python/ray/serve/context.py get_deployment_handle).
"""
from __future__ import annotations

import time

import ray_tpu_torch
from ray_tpu_torch.actor import ActorClass
from ray_tpu_torch.serve.config import GrpcOptions, HTTPOptions
from ray_tpu_torch.serve.controller import CONTROLLER_NAME, ServeController
from ray_tpu_torch.serve.deployment import Application
from ray_tpu_torch.serve.handle import DeploymentHandle, _Router
from ray_tpu_torch.serve.proxy import HTTPProxy
from ray_tpu_torch.serve.proxy_actor import _NO_GRPC

_proxy: HTTPProxy | None = None

# app name -> the ObjectRefs its bind arguments name. A replica reads them
# by id (the controller holds only the init_blob bytes), so this client
# keeps them counted as the driver's until the app is deleted or Serve
# shuts down: a replica the controller restarts after the caller dropped
# its own ref still finds its weights. An object still fate-shares with
# its owner, the driver process, as in the reference.
_bound_refs: dict[str, list] = {}


def _refs_in(value, out: list) -> list:
    """Every ObjectRef in ``value`` (bind arguments: nested lists, tuples,
    dicts and applications), appended to ``out``."""
    from ray_tpu_torch._private.object_ref import ObjectRef

    if isinstance(value, ObjectRef):
        out.append(value)
    elif isinstance(value, Application):
        for v in (*value.args, *value.kwargs.values()):
            _refs_in(v, out)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _refs_in(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _refs_in(v, out)
    return out


# the raylet is the controller's supervisor: on worker death it restarts
# the named actor IN PLACE (same actor id — cached handles keep working)
# and __init__ -> _recover() rebuilds state from the GCS checkpoint.
# Dead-dead (restart budget exhausted) falls back to this module creating
# a fresh actor, which recovers from the same checkpoint; handles pick up
# the new actor id via _Router._invalidate_controller's re-resolve.
_CONTROLLER_MAX_RESTARTS = 100


def _get_or_create_controller():
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        pass
    handle = ActorClass(
        ServeController,
        num_cpus=0.1,
        name=CONTROLLER_NAME,
        max_restarts=_CONTROLLER_MAX_RESTARTS,
    ).remote()
    # wait for liveness so the first deploy call doesn't race startup
    ray_tpu_torch.get(handle.list_applications.remote(), timeout=60)
    return handle


def start(
    http_options: HTTPOptions | dict | None = None,
    grpc_options: GrpcOptions | dict | None = None,
    proxy_location: str = "Driver",
) -> None:
    """Start serve system actors (reference: serve.start;
    proxy_location mirrors serve.config.ProxyLocation).

    proxy_location:
      * "Driver" — dev mode: in-process proxy threads in this driver.
      * "EveryNode" — production shape: the controller keeps one proxy
        ACTOR per alive node, health-checked and restarted on failure
        (reference: serve/_private/proxy_state.py). Use port=0 per
        protocol unless nodes are distinct hosts; read bound ports via
        serve.proxy_addresses().
    """
    global _proxy
    if grpc_options is not None:
        raise NotImplementedError(_NO_GRPC)
    controller = _get_or_create_controller()
    if proxy_location == "EveryNode":
        ray_tpu_torch.get(
            controller.start_proxies.remote(
                _as_dict(http_options), _as_dict(grpc_options)),
            timeout=60,
        )
        return
    if proxy_location != "Driver":
        raise ValueError(
            f"proxy_location must be 'Driver' or 'EveryNode', "
            f"got {proxy_location!r}")
    if http_options is not None and _proxy is None:
        if isinstance(http_options, dict):
            http_options = HTTPOptions(**http_options)
        _proxy = HTTPProxy(http_options)
        _proxy.start()


def _as_dict(options) -> dict | None:
    if options is None:
        return None
    if isinstance(options, dict):
        return dict(options)
    from dataclasses import asdict

    return asdict(options)


def proxy_addresses(timeout_s: float = 30.0) -> dict:
    """hex node_id -> {"http": (host, port), ...} of HEALTHY per-node
    proxies (EveryNode mode). Blocks briefly until at least one proxy is
    up or the timeout passes."""
    controller = _get_or_create_controller()
    deadline = time.monotonic() + timeout_s
    while True:
        addrs = ray_tpu_torch.get(controller.proxy_addresses.remote(), timeout=60)
        if addrs or time.monotonic() > deadline:
            return addrs
        time.sleep(0.1)


def run(
    target: Application,
    *,
    name: str = "default",
    route_prefix: str | None = None,
    _blocking: bool = True,
    timeout_s: float = 120.0,
) -> DeploymentHandle:
    """Deploy an application and (by default) block until healthy
    (reference: serve.run api.py:479)."""
    if not isinstance(target, Application):
        raise TypeError("serve.run expects Deployment.bind(...)")
    controller = _get_or_create_controller()
    apps = target.flatten()
    specs = [a.build_spec(name) for a in apps]
    by_name: dict[str, dict] = {}
    uniq = []
    for s in specs:
        prev = by_name.get(s["name"])
        if prev is not None:
            if (
                prev["callable_blob"] != s["callable_blob"]
                or prev["init_blob"] != s["init_blob"]
                or prev["config"] != s["config"]
            ):
                raise ValueError(
                    f"two deployments named {s['name']!r} with different "
                    "bind arguments in one app — give one of them "
                    ".options(name=...) (handles route by name)"
                )
            continue
        by_name[s["name"]] = s
        uniq.append(s)
    ingress = target.deployment.name
    ray_tpu_torch.get(
        controller.deploy_application.remote(name, uniq, ingress, route_prefix),
        timeout=60,
    )
    _bound_refs[name] = _refs_in(target, [])
    _Router.reset_all()  # drop stale routing tables from a previous version
    if route_prefix is not None and _proxy is not None:
        _proxy.set_route(route_prefix, name, ingress)
    if _blocking:
        _wait_healthy(controller, name, timeout_s)
    return DeploymentHandle(ingress, name)


def _wait_healthy(controller, app_name: str, timeout_s: float) -> None:
    deadline = time.monotonic() + timeout_s
    st: dict = {}
    while time.monotonic() < deadline:
        st = ray_tpu_torch.get(controller.status.remote(), timeout=60)
        app = st.get(app_name, {})
        if app and all(d["status"] == "HEALTHY" for d in app.values()):
            return
        bad = [
            f"{n}: {d['message']}" for n, d in app.items() if d["status"] == "UNHEALTHY"
        ]
        if bad:
            raise RuntimeError(f"app {app_name} unhealthy: {bad}")
        time.sleep(0.1)
    raise TimeoutError(f"app {app_name} not healthy within {timeout_s}s: {st}")


def status() -> dict:
    controller = _get_or_create_controller()
    return ray_tpu_torch.get(controller.status.remote(), timeout=60)


def delete(name: str) -> None:
    controller = _get_or_create_controller()
    ray_tpu_torch.get(controller.delete_application.remote(name), timeout=60)
    _bound_refs.pop(name, None)
    if _proxy is not None:
        _proxy.remove_routes_for_app(name)
    _Router.reset_all()


def get_app_handle(name: str = "default") -> DeploymentHandle:
    controller = _get_or_create_controller()
    table = ray_tpu_torch.get(controller.get_routing_table.remote(), timeout=60)
    app = table["apps"].get(name)
    if app is None:
        raise ValueError(f"no serve application named {name!r}")
    return DeploymentHandle(app["ingress"], name)


def get_deployment_handle(deployment_name: str, app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(deployment_name, app_name)


def shutdown() -> None:
    """Tear down all serve state (reference: serve.shutdown)."""
    global _proxy
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        controller = None
    if controller is not None:
        try:
            ray_tpu_torch.get(controller.shutdown.remote(), timeout=60)
        except Exception:  # noqa: BLE001 — already dead is fine
            pass
        ray_tpu_torch.kill(controller)
    if _proxy is not None:
        _proxy.stop()
        _proxy = None
    _bound_refs.clear()
    _Router.reset_all()
