"""ray_tpu_torch — the PyTorch/CUDA port of ``ray_tpu``.

A package of its own beside the JAX one: it imports ``torch`` and never
``jax`` or anything of ``ray_tpu`` (what it needs from there it keeps its
own copy of). Module names follow the JAX package so every counterpart is
found at the same path:

- the distributed core: ``init`` / ``remote`` / ``get`` / ``put`` /
  ``wait`` / ``kill`` / ``get_actor`` below, over ``_private/`` (GCS,
  raylet, worker pool, the shared-memory object store of ``cpp/``) with
  ``GPU`` as a scheduled resource: a ``num_gpus=1`` task or actor runs
  with ``CUDA_VISIBLE_DEVICES`` set to its card
- ``ops/``        — layers, flash attention, the fused lm-head loss, paged
  KV ops, sampling and the attention dispatchers over the hand-written
  Hopper kernels (``csrc/*.cu``, built at first use by ``_build.py``)
- ``models/gpt.py``, ``models/llama.py`` — the GPT-2 and Llama families'
  training and KV-cached serving paths
- ``benchmarks/gpt_mfu.py`` — train steps of either family: tokens/s and
  MFU
- ``convert.py``  — the JAX parameter trees into the port's weights
- ``serve/llm/``  — paged KV cache, single-device executor, the
  continuous-batching ``LLMEngine``

Entry points run on ``cuda:0`` unless the caller passes ``device="cpu"``;
with no CUDA device and no explicit device they raise (``_device.py``).
Importing the package does not import torch (a worker process that runs
no torch code never loads it); ``resolve_device`` loads it on first use.

Public core API (reference: python/ray/_private/worker.py — ray.init:1139,
get:2461, put:2590, wait:2653, remote:3027).
"""
from __future__ import annotations

import threading
from typing import Any, Sequence

from ray_tpu_torch._private import worker as _worker_mod
from ray_tpu_torch._private.config import reset_config
from ray_tpu_torch._private.ids import JobID
from ray_tpu_torch._private.generator import ObjectRefGenerator
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.worker import (CoreWorker, global_worker,
                                           set_global_worker)
from ray_tpu_torch.actor import ActorHandle, get_actor, kill
from ray_tpu_torch.remote_function import remote_decorator as remote
from ray_tpu_torch import exceptions

__version__ = "0.1.0"

_init_lock = threading.Lock()
_node_handle = None

# module alias so `ray_tpu_torch.worker.global_worker()` works (ObjectRef)
worker = _worker_mod


def __getattr__(name: str):
    if name == "resolve_device":
        from ray_tpu_torch._device import resolve_device

        return resolve_device
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")


def is_initialized() -> bool:
    return _worker_mod.global_worker_or_none() is not None


def init(
    *,
    num_cpus: float | None = None,
    num_gpus: float | None = None,
    resources: dict[str, float] | None = None,
    object_store_memory: int | None = None,
    labels: dict[str, str] | None = None,
    _system_config: dict[str, Any] | None = None,
    ignore_reinit_error: bool = False,
):
    """Start a single-host cluster (store daemon + GCS + raylet) and connect
    this process as the driver. ``num_gpus=None`` counts the host's cards
    (``node.autodetect_gpus``) without touching CUDA in this process."""
    global _node_handle
    with _init_lock:
        if is_initialized():
            if ignore_reinit_error:
                return _node_handle
            raise RuntimeError(
                "ray_tpu_torch.init() called twice; pass ignore_reinit_error=True")
        reset_config(_system_config)
        from ray_tpu_torch._private.node import start_head

        _node_handle = start_head(
            num_cpus=num_cpus,
            num_gpus=num_gpus,
            resources=resources,
            labels=labels,
            object_store_memory=object_store_memory,
        )
        job_id = JobID(
            _node_handle.raylet.gcs.call("next_job_id")["job_id"]
        )
        core = CoreWorker(
            mode="driver",
            gcs_address=_node_handle.gcs_address,
            raylet_address=_node_handle.raylet.address,
            store_socket=_node_handle.store_socket,
            job_id=job_id,
            node_id=_node_handle.node_id,
        )
        set_global_worker(core)
        return _node_handle


def shutdown() -> None:
    global _node_handle
    with _init_lock:
        w = _worker_mod.global_worker_or_none()
        if w is not None:
            w.shutdown()
            set_global_worker(None)
        if _node_handle is not None:
            _node_handle.shutdown()
            _node_handle = None


def put(value: Any) -> ObjectRef:
    return global_worker().put(value)


def get(refs: ObjectRef | Sequence[ObjectRef], *, timeout: float | None = None):
    return global_worker().get(refs, timeout=timeout)


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: float | None = None,
):
    return global_worker().wait(refs, num_returns=num_returns, timeout=timeout)


def cluster_resources() -> dict[str, float]:
    return global_worker().gcs.call("cluster_resources")["total"]


def available_resources() -> dict[str, float]:
    return global_worker().gcs.call("cluster_resources")["available"]


def nodes() -> list[dict]:
    return global_worker().gcs.call("get_nodes")["nodes"]


__all__ = [
    "init",
    "shutdown",
    "is_initialized",
    "remote",
    "put",
    "get",
    "wait",
    "kill",
    "get_actor",
    "cluster_resources",
    "available_resources",
    "nodes",
    "ObjectRef",
    "ObjectRefGenerator",
    "ActorHandle",
    "exceptions",
    "resolve_device",
]
