"""Worker process entry point: register with the raylet, execute pushed tasks.

Equivalent of the reference's default_worker.py + the Cython task-execution
loop (reference: python/ray/_private/workers/default_worker.py;
_raylet.pyx:3044 run_task_loop). Spawned by the raylet's worker pool with
RT_* env vars carrying the connection endpoints.

The port's copy of ``ray_tpu/_private/worker_main.py``.
"""
from __future__ import annotations

import os
import queue
import sys


def main() -> None:
    raylet_addr = os.environ["RT_RAYLET_ADDR"]
    store_sock = os.environ["RT_STORE_SOCK"]
    gcs_addr = os.environ["RT_GCS_ADDR"]
    node_id_hex = os.environ["RT_NODE_ID"]
    worker_id_hex = os.environ["RT_WORKER_ID"]

    from ray_tpu_torch._private.ids import JobID, NodeID, WorkerID
    from ray_tpu_torch._private.worker import CoreWorker, set_global_worker

    core = CoreWorker(
        mode="worker",
        gcs_address=gcs_addr,
        raylet_address=raylet_addr,
        store_socket=store_sock,
        job_id=JobID(b"\x00" * 4),  # replaced per-task from the spec
        node_id=NodeID.from_hex(node_id_hex),
        worker_id=WorkerID.from_hex(worker_id_hex),
    )
    set_global_worker(core)

    tasks: queue.Queue = queue.Queue()

    def on_execute(payload):
        tasks.put(payload)

    core.add_notify_handler("execute_task", on_execute)

    core.raylet.call(
        "register_worker", {"worker_id": worker_id_hex, "pid": os.getpid()}
    )

    while True:
        payload = tasks.get()
        if payload is None:
            break
        from ray_tpu_torch._private.ids import JobID as _J

        core.job_id = _J(payload["spec"]["job_id"])
        core.execute_task(payload["spec"], payload.get("gpus", []))


if __name__ == "__main__":
    try:
        main()
    except (KeyboardInterrupt, ConnectionError):
        sys.exit(0)
