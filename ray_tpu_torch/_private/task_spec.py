"""Task specification: the unit handed from owners to raylets to workers.

Equivalent of the reference's TaskSpecification
(reference: src/ray/common/task/task_spec.h:244 — protobuf-backed spec with
function descriptor, args, resources, scheduling strategy, actor fields).
Here the spec is a dict of wire types (``wire.py``) built/validated by this
module; functions and classes travel as ``serialization.dumps_by_value``
pickles (the port's stand-in for cloudpickle).

Top-level ObjectRef args are replaced by dependency markers and resolved to
values by the executing worker (reference semantics: dependency_resolver.cc
inlines resolved args); nested refs stay refs.
"""
from __future__ import annotations

import hashlib
import pickle
from typing import Any

from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID

NORMAL = "normal"
ACTOR_CREATION = "actor_creation"
ACTOR_TASK = "actor_task"

# Scheduling strategy types (reference: policy/scheduling_options.h:30-102).
SCHED_DEFAULT = "default"  # hybrid: prefer local, spill when saturated
SCHED_SPREAD = "spread"
SCHED_NODE_AFFINITY = "node_affinity"


def function_id(func_blob: bytes) -> bytes:
    return hashlib.sha1(func_blob).digest()[:16]


def check_whole_gpus(resources: dict) -> dict:
    """Refuse a ``GPU`` demand that is not a whole number of cards. The
    raylet hands out whole slots through ``CUDA_VISIBLE_DEVICES``, so 0.5
    would run with no card and 1.5 with one. -> ``resources``."""
    n = resources.get("GPU", 0)
    if n < 0 or n != int(n):
        raise ValueError(
            f"num_gpus must be a whole number of GPUs, got {n!r}")
    return resources


def make_task_spec(
    *,
    task_id: TaskID,
    job_id: JobID,
    name: str,
    task_type: str = NORMAL,
    function_blob: bytes | None = None,
    method_name: str | None = None,
    args: tuple = (),
    kwargs: dict | None = None,
    num_returns: int = 1,
    streaming: bool = False,
    resources: dict[str, float] | None = None,
    actor_id: ActorID | None = None,
    seqno: int = 0,
    max_retries: int = 0,
    placement: dict | None = None,
    scheduling: dict | None = None,
    runtime_env: dict | None = None,
    max_restarts: int = 0,
    max_concurrency: int = 1,
    owner_address: str = "",
) -> dict:
    from ray_tpu_torch._private.object_ref import ObjectRef  # circular import

    arg_deps: list[bytes] = []
    proc_args = []
    for a in args:
        if isinstance(a, ObjectRef):
            arg_deps.append(a.object_id.binary())
            proc_args.append(_RefMarker(a.object_id.binary()))
        else:
            proc_args.append(a)
    proc_kwargs = {}
    for k, v in (kwargs or {}).items():
        if isinstance(v, ObjectRef):
            arg_deps.append(v.object_id.binary())
            proc_kwargs[k] = _RefMarker(v.object_id.binary())
        else:
            proc_kwargs[k] = v

    args_blob = ser.dumps((tuple(proc_args), proc_kwargs))
    return {
        "task_id": task_id.binary(),
        "job_id": job_id.binary(),
        "name": name,
        "type": task_type,
        "function_blob": function_blob,
        "function_id": function_id(function_blob) if function_blob else b"",
        "method_name": method_name,
        "args_blob": args_blob,
        "arg_deps": arg_deps,
        "num_returns": num_returns,
        # streaming: yielded values seal at return indices 1..n as produced;
        # index 0 is the completion marker (count or error) — reference:
        # streaming generator returns, _raylet.pyx:957-1043
        "streaming": streaming,
        "resources": resources or {"CPU": 1.0},
        "actor_id": actor_id.binary() if actor_id else None,
        "seqno": seqno,
        "max_retries": max_retries,
        "retry_count": 0,
        "placement": placement,
        "scheduling": scheduling or {"type": SCHED_DEFAULT},
        "runtime_env": runtime_env,
        "max_restarts": max_restarts,
        "max_concurrency": max_concurrency,
        "owner_address": owner_address,
    }


class _RefMarker:
    """Placeholder for a top-level ObjectRef arg; replaced before execution."""

    __slots__ = ("object_id_bytes",)

    def __init__(self, object_id_bytes: bytes):
        self.object_id_bytes = object_id_bytes

    def __reduce__(self):
        return (_RefMarker, (self.object_id_bytes,))


def return_object_ids(spec: dict) -> list[ObjectID]:
    tid = TaskID(spec["task_id"])
    return [
        ObjectID.for_task_return(tid, i) for i in range(spec["num_returns"])
    ]


def dumps_function(func: Any) -> bytes:
    return ser.dumps_by_value(func)


def loads_function(blob: bytes) -> Any:
    return pickle.loads(blob)
