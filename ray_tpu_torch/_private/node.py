"""Node bootstrap: object store daemon + GCS + raylet for one host.

Equivalent of the reference's node bootstrap
(reference: python/ray/_private/node.py — Node.start_head_processes:1395
spawns gcs_server, start_ray_processes:1424 spawns the raylet which embeds
plasma). The store is always a real subprocess (C++ daemon), ONE PER NODE;
GCS and raylet run as threads in the hosting process — same protocol, fewer
processes. The `Cluster` harness stacks extra in-process raylets, each
with its own store daemon, for multi-node tests (reference:
python/ray/cluster_utils.py:108). The port's copy of
``ray_tpu/_private/node.py``: ``GPU`` is the node's accelerator resource
(``autodetect_gpus``); the standalone node processes (``node_main.py``)
and the fake-TPU-host harness are not carried over.
"""
from __future__ import annotations

import atexit
import os
import re
import tempfile
from typing import Any

from ray_tpu_torch._private.config import global_config
from ray_tpu_torch._private.gcs import GcsService
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.object_store import start_store
from ray_tpu_torch._private.raylet import Raylet


def autodetect_gpus() -> int:
    """Count the local NVIDIA cards without creating a CUDA context in the
    calling process (the raylet and the driver never touch CUDA).

    ``CUDA_VISIBLE_DEVICES`` first (the entries it lists; set but empty
    means none); then the ``/dev/nvidia<N>`` device files this process may
    open (a container can list nodes of cards its
    device controller denies); else 0 (reference:
    python/ray/_private/accelerator.py, the visible-devices variable and
    the device count).
    """
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        return len([d for d in visible.split(",") if d.strip()])
    try:
        nodes = [d for d in os.listdir("/dev") if re.fullmatch(r"nvidia\d+", d)]
    except OSError:
        return 0
    return sum(_openable(os.path.join("/dev", d)) for d in nodes)


def _openable(path: str) -> bool:
    try:
        os.close(os.open(path, os.O_RDWR | os.O_CLOEXEC))
    except OSError:
        return False
    return True


class NodeHandle:
    def __init__(self, *, gcs: GcsService | None, gcs_address: str,
                 raylet: Raylet, store_proc, store_socket: str, session_dir: str):
        self.gcs = gcs
        self.gcs_address = gcs_address
        self.raylet = raylet
        self.store_proc = store_proc
        self.store_socket = store_socket
        self.session_dir = session_dir
        self.node_id = raylet.node_id

    def shutdown(self) -> None:
        self.raylet.stop()
        if self.gcs is not None:
            self.gcs.stop()
        if self.store_proc is not None:
            try:
                self.store_proc.terminate()
                self.store_proc.wait(timeout=5)
            except Exception:
                pass


def _default_node_resources(
    num_cpus: float | None,
    num_gpus: float | None,
    resources: dict[str, float] | None,
    labels: dict[str, str] | None,
) -> tuple[dict[str, float], dict[str, str]]:
    node_resources = dict(resources or {})
    node_resources.setdefault(
        "CPU", float(num_cpus if num_cpus is not None else os.cpu_count() or 1)
    )
    node_resources.setdefault(
        "GPU", float(num_gpus if num_gpus is not None else autodetect_gpus())
    )
    node_resources.setdefault("memory", float(2 * 1024**3))
    return node_resources, dict(labels or {})


def start_head(
    *,
    num_cpus: float | None = None,
    num_gpus: float | None = None,
    resources: dict[str, float] | None = None,
    labels: dict[str, str] | None = None,
    object_store_memory: int | None = None,
    gcs_port: int = 0,
) -> NodeHandle:
    cfg = global_config()
    session_dir = tempfile.mkdtemp(prefix="ray_tpu_torch_session_")
    store_socket = os.path.join(session_dir, "store.sock")
    store_proc = start_store(
        store_socket,
        object_store_memory or cfg.object_store_memory_bytes,
        spill_dir=cfg.object_spilling_dir or None,
    )
    # build+load the native scheduling core NOW so the first dispatch never
    # stalls on a synchronous g++ compile
    from ray_tpu_torch._private import scheduler as _sched

    _sched._load_native()

    gcs = GcsService()
    gcs_address = gcs.start(port=gcs_port)

    node_resources, node_labels = _default_node_resources(
        num_cpus, num_gpus, resources, labels
    )
    raylet = Raylet(
        NodeID.from_random(), gcs_address, store_socket, node_resources, node_labels
    )
    handle = NodeHandle(
        gcs=gcs,
        gcs_address=gcs_address,
        raylet=raylet,
        store_proc=store_proc,
        store_socket=store_socket,
        session_dir=session_dir,
    )
    atexit.register(handle.shutdown)
    return handle


def start_worker_node(
    gcs_address: str,
    *,
    num_cpus: float | None = None,
    num_gpus: float | None = None,
    resources: dict[str, float] | None = None,
    labels: dict[str, str] | None = None,
    object_store_memory: int | None = None,
) -> NodeHandle:
    """Join an existing cluster as a new node: own store daemon + raylet
    (reference: `ray start --address=<gcs>`, scripts.py:548 worker path)."""
    cfg = global_config()
    session_dir = tempfile.mkdtemp(prefix="ray_tpu_torch_session_")
    store_socket = os.path.join(session_dir, "store.sock")
    store_proc = start_store(
        store_socket,
        object_store_memory or cfg.object_store_memory_bytes,
        spill_dir=cfg.object_spilling_dir or None,
    )
    node_resources, node_labels = _default_node_resources(
        num_cpus, num_gpus, resources, labels
    )
    raylet = Raylet(
        NodeID.from_random(), gcs_address, store_socket, node_resources, node_labels
    )
    handle = NodeHandle(
        gcs=None,
        gcs_address=gcs_address,
        raylet=raylet,
        store_proc=store_proc,
        store_socket=store_socket,
        session_dir=session_dir,
    )
    atexit.register(handle.shutdown)
    return handle


class Cluster:
    """In-process fake multi-node cluster for tests.

    Reference: python/ray/cluster_utils.py:108 Cluster — extra raylets in one
    process against one GCS. Every node runs its OWN store daemon; objects
    move between nodes through the raylet pull/push object plane, exactly as
    they would across physical hosts.
    """

    def __init__(self, head_resources: dict[str, float] | None = None):
        self.head = start_head(
            num_cpus=(head_resources or {}).get("CPU", 2),
            num_gpus=(head_resources or {}).get("GPU", 0),
            resources={
                k: v for k, v in (head_resources or {}).items() if k not in ("CPU", "GPU")
            },
        )
        self.nodes: list[Raylet] = [self.head.raylet]
        self._store_procs: dict[bytes, Any] = {}

    @property
    def gcs_address(self) -> str:
        return self.head.gcs_address

    def add_node(
        self,
        *,
        num_cpus: float = 1,
        num_gpus: float = 0,
        resources: dict[str, float] | None = None,
        labels: dict[str, str] | None = None,
        object_store_memory: int | None = None,
    ) -> Raylet:
        cfg = global_config()
        node_resources = dict(resources or {})
        node_resources["CPU"] = float(num_cpus)
        node_resources["GPU"] = float(num_gpus)
        node_resources.setdefault("memory", float(2 * 1024**3))
        node_labels = dict(labels or {})
        store_socket = os.path.join(
            self.head.session_dir, f"store-{len(self.nodes)}.sock"
        )
        store_proc = start_store(
            store_socket,
            object_store_memory or cfg.object_store_memory_bytes,
            spill_dir=cfg.object_spilling_dir or None,
        )
        raylet = Raylet(
            NodeID.from_random(),
            self.head.gcs_address,
            store_socket,
            node_resources,
            node_labels,
        )
        self.nodes.append(raylet)
        self._store_procs[raylet.node_id.binary()] = store_proc
        return raylet

    def remove_node(self, raylet: Raylet) -> None:
        raylet.stop()
        self.nodes.remove(raylet)
        proc = self._store_procs.pop(raylet.node_id.binary(), None)
        if proc is not None:
            try:
                proc.terminate()
            except Exception:
                pass
        try:
            self.head.gcs.rpc_drain_node(None, 0, {"node_id": raylet.node_id.binary()})
        except Exception:
            pass

    def shutdown(self) -> None:
        for raylet in self.nodes[1:]:
            try:
                raylet.stop()
            except Exception:
                pass
        for proc in self._store_procs.values():
            try:
                proc.terminate()
            except Exception:
                pass
        self._store_procs.clear()
        self.head.shutdown()
