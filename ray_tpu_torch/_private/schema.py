"""Versioned wire schemas for the control plane (the port's copy of
``ray_tpu/_private/schema.py``; ``task_done`` also carries the CUDA
binding of a task worker, ``cuda_devices``).

Equivalent in role to the reference's protobuf schema layer (reference:
src/ray/protobuf/*.proto — versioned message definitions compiled into every
RPC surface). This framework's wire format is msgpack dicts (rpc.py); this
module is the single authoritative declaration of those messages:

  * PROTOCOL_VERSION — bumped on any incompatible wire change; enforced by
    the `_handshake` exchange every RpcClient performs on connect (the
    analog of proto compatibility: an old client cannot silently talk to a
    new server).
  * SCHEMAS — per-method required/optional request fields. In strict mode
    (RAY_TPU_STRICT_SCHEMA=1, enabled by the test harness) servers validate
    every inbound payload against its declaration, catching schema drift at
    the boundary instead of as a KeyError deep in a handler.

Unlike protobuf there is no codegen step: msgpack already handles encoding,
so the schema layer is enforcement + documentation, not serialization.
"""
from __future__ import annotations

import os
from typing import Any

# Bump on ANY incompatible change to message shapes or the framing in
# rpc.py. Clients and servers must match exactly (single-version policy:
# a rolling upgrade runs homogeneous binaries, like the reference's
# same-commit requirement for cluster nodes).
PROTOCOL_VERSION = 1


class SchemaError(Exception):
    pass


def _spec(required: str = "", optional: str = "") -> dict:
    return {
        "required": tuple(required.split()) if required else (),
        "optional": tuple(optional.split()) if optional else (),
    }


# Request schemas by service + method. A method absent from its service's
# table is schema-free (payload passed through opaque); list the core
# surface explicitly so drift is caught where it matters.
SCHEMAS: dict[str, dict[str, dict]] = {
    "gcs": {
        "kv_put": _spec("key value", "ns overwrite"),
        "kv_get": _spec("key", "ns"),
        "kv_del": _spec("key", "ns"),
        "kv_keys": _spec("", "ns prefix"),
        "register_node": _spec(
            "node_id address resources", "labels store_socket"
        ),
        "heartbeat": _spec(
            "node_id",
            "available load pending_shapes disk_used_frac seen_seq",
        ),
        "drain_node": _spec("node_id"),
        "get_nodes": _spec(),
        "cluster_resources": _spec(),
        "object_location_update": _spec("node_id events"),
        "free_object": _spec("object_id"),
        "get_object_locations": _spec("object_id"),
        "next_job_id": _spec(),
        "register_actor": _spec("actor_id", "class_name name max_restarts"),
        "update_actor": _spec(
            "actor_id",
            "state node_id raylet_address worker_id increment_restarts",
        ),
        "get_actor": _spec("actor_id"),
        "get_named_actor": _spec("name"),
        "list_actors": _spec(),
        "create_placement_group": _spec("pg_id bundles", "strategy"),
        "remove_placement_group": _spec("pg_id"),
        "get_placement_group": _spec("pg_id"),
        "subscribe": _spec("topic"),
        "unsubscribe": _spec("topic"),
        "publish": _spec("topic payload"),
        "add_task_events": _spec("events"),
        "list_task_events": _spec("job_id", "trace_id limit"),
    },
    "raylet": {
        "pull_object": _spec("object_id", "length offset"),
        "fetch_object": _spec("object_id"),
        "free_object": _spec("object_id"),
        "register_worker": _spec("worker_id", "pid"),
        "submit_task": _spec("spec"),
        "actor_started": _spec("actor_id worker_id"),
        "kill_actor": _spec("actor_id"),
        "task_done": _spec("", "task_id cuda_devices"),
        "prepare_bundle": _spec("pg_id bundle_index resources"),
        "commit_bundle": _spec("pg_id bundle_index"),
        "cancel_bundle": _spec("pg_id bundle_index"),
        "return_bundle": _spec("pg_id bundle_index"),
        "node_stats": _spec(),
    },
}


def strict_mode() -> bool:
    return os.environ.get("RAY_TPU_STRICT_SCHEMA", "0") == "1"


def validate_request(service: str, method: str, payload: Any) -> None:
    """Raise SchemaError when payload does not match the declared shape.
    Only meaningful for dict payloads; other payload types are opaque."""
    table = SCHEMAS.get(service)
    if table is None:
        return
    spec = table.get(method)
    if spec is None:
        return
    if payload is None:
        payload = {}
    if not isinstance(payload, dict):
        raise SchemaError(
            f"{service}.{method}: expected a dict payload, got "
            f"{type(payload).__name__}"
        )
    missing = [k for k in spec["required"] if k not in payload]
    if missing:
        raise SchemaError(f"{service}.{method}: missing fields {missing}")
    allowed = set(spec["required"]) | set(spec["optional"])
    unknown = [k for k in payload if k not in allowed]
    if unknown:
        raise SchemaError(f"{service}.{method}: unknown fields {unknown}")


def handshake_payload() -> dict:
    import ray_tpu_torch

    return {"protocol": PROTOCOL_VERSION, "version": ray_tpu_torch.__version__}


def check_handshake(payload: Any) -> dict:
    """Server side: validate a client hello; raises SchemaError on
    incompatibility. Returns the server's hello."""
    if not isinstance(payload, dict) or "protocol" not in payload:
        raise SchemaError("malformed handshake")
    theirs = payload["protocol"]
    if theirs != PROTOCOL_VERSION:
        raise SchemaError(
            f"protocol version mismatch: peer speaks {theirs}, "
            f"this node speaks {PROTOCOL_VERSION}"
        )
    return handshake_payload()
