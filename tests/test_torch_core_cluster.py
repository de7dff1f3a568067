"""The port's in-process ``Cluster`` harness against the JAX package's:
one program on a CPU-only head plus a node that holds the accelerator
(two fake GPUs here, two TPU chips there). A task that needs both cards
spills back from the head to that node and sees them as its visible
devices; objects cross the two nodes' stores both ways; a demand no node
can meet fails with the same error. The records must be equal."""
from __future__ import annotations

import contextlib
import gc
import importlib
import os
import time

import numpy as np
import pytest


@contextlib.contextmanager
def _cluster(pkg):
    """A head of 2 CPUs and a node of 1 CPU and 2 accelerators, with this
    process connected as the driver (the JAX tests' ``ray_cluster``)."""
    node = importlib.import_module(f"{pkg}._private.node")
    worker = importlib.import_module(f"{pkg}._private.worker")
    ids = importlib.import_module(f"{pkg}._private.ids")
    cluster = node.Cluster(head_resources={"CPU": 2})
    accel = {"num_gpus": 2} if pkg == "ray_tpu_torch" else {"num_tpus": 2}
    cluster.add_node(num_cpus=1, **accel)
    job = ids.JobID(cluster.head.raylet.gcs.call("next_job_id")["job_id"])
    core = worker.CoreWorker(
        mode="driver", gcs_address=cluster.gcs_address,
        raylet_address=cluster.head.raylet.address,
        store_socket=cluster.head.store_socket, job_id=job,
        node_id=cluster.head.node_id)
    worker.set_global_worker(core)
    try:
        yield importlib.import_module(pkg)
    finally:
        core.shutdown()
        worker.set_global_worker(None)
        cluster.shutdown()


def _program(rt, accel, visible_var):
    rec = {}
    deadline = time.monotonic() + 30
    # the head learns of the other node by its heartbeat
    while rt.cluster_resources().get(accel, 0) < 2:
        assert time.monotonic() < deadline
        time.sleep(0.1)
    rec["total"] = (rt.cluster_resources()["CPU"],
                    rt.cluster_resources()[accel])

    @rt.remote(num_cpus=0, resources={accel: 2})
    def on_card(x):
        return os.environ.get(visible_var), float(x.sum())

    @rt.remote(num_cpus=0, resources={accel: 1})
    def make(n):
        return np.arange(n, dtype=np.float64)

    arr = np.arange(1 << 14, dtype=np.float32)
    rec["spillback"] = rt.get(on_card.remote(rt.put(arr)), timeout=120)
    back = rt.get(make.remote(1 << 13), timeout=120)
    rec["pulled"] = (back.dtype.str, back.shape, float(back.sum()))

    @rt.remote(resources={accel: 16})
    def impossible():
        return 1

    try:
        rt.get(impossible.remote(), timeout=60)
    except Exception as e:  # noqa: BLE001 — the record is the error
        rec["infeasible"] = (type(e).__name__, "satisfy" in str(e))
    return rec


@pytest.mark.timeout(120)
def test_cluster_program_equal_records():
    pytest.importorskip("jax")
    import ray_tpu
    import ray_tpu_torch

    for rt in (ray_tpu, ray_tpu_torch):
        if rt.is_initialized():  # left by a file run before in this process
            rt.shutdown()
    with _cluster("ray_tpu_torch") as rt:
        mine = _program(rt, "GPU", "CUDA_VISIBLE_DEVICES")
    # the JAX package's RpcClient can deadlock when the collector runs an
    # ObjectRef's __del__ inside call_async (see test_torch_core.py)
    gc.disable()
    try:
        with _cluster("ray_tpu") as rt:
            theirs = _program(rt, "TPU", "TPU_VISIBLE_CHIPS")
    finally:
        gc.enable()
        gc.collect()
    assert mine == theirs
    assert mine["total"] == (3.0, 2.0)
    assert mine["spillback"] == ("0,1", float(np.arange(1 << 14).sum()))
    assert mine["infeasible"] == ("ValueError", True)
