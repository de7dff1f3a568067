"""The lifetime of an LLM app's ``params=`` ref (``build_llm_app(params=
<ObjectRef>)``) on the port's Serve: the weights stay in the store for
as long as an app that names them is deployed, and no longer.

A tiny f32 Llama app on weights put by the driver streams two requests
(greedy and sampled); the driver drops its last reference (the ref and
the app) and collects; the replica is killed; the replica the controller
starts in its place reads the weights through the ref that ``serve.run``
holds, and streams what the first one did. After ``serve.delete`` the
object is freed."""
from __future__ import annotations

import dataclasses
import gc
import os
import signal
import time

import pytest
import torch

BUCKETS = dict(block_size=8, num_blocks=64, max_batch_size=4,
               batch_buckets=(4,), length_buckets=(32,))
REQUESTS = [dict(prompt=[5, 17, 3, 99, 42, 7], max_new_tokens=8),
            dict(prompt=[8, 1, 250, 31], max_new_tokens=8, temperature=0.8,
                 top_p=0.9, seed=4)]


@pytest.fixture(scope="module")
def torch_serve():
    import ray_tpu_torch
    from ray_tpu_torch import serve

    node = ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    serve.start()
    yield ray_tpu_torch, serve, node
    serve.shutdown()
    ray_tpu_torch.shutdown()


def _wait(pred, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.1)
    return False


def _replicas(rt, node) -> dict:
    """actor id -> worker pid of the live replicas."""
    actors = rt.worker.global_worker().gcs.call("list_actors")["actors"]
    ids = {a["actor_id"] for a in actors if a.get("class_name") ==
           "ReplicaActor" and a.get("state") != "DEAD"}
    return {w.actor_id: w.proc.pid for w in node.raylet._all_workers.values()
            if w.actor_id in ids and w.proc is not None}


def _streams(handle) -> list:
    from ray_tpu_torch.serve.llm import stream_tokens

    return [[c["token"] for c in stream_tokens(handle, dict(r))]
            for r in REQUESTS]


@pytest.mark.timeout(150)
def test_dropped_params_ref_survives_a_replica_restart(torch_serve):
    from ray_tpu_torch.models.families import family
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.serve.llm import EngineConfig, build_llm_app

    rt, serve, node = torch_serve
    cfg = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32)
    weights = {k: v.detach() for k, v in family("llama").init(
        cfg, 3, torch.device("cpu")).weights().items()}
    ref = rt.put(weights)
    oid = ref.binary()
    del weights
    app = build_llm_app(
        EngineConfig(model="llama", model_config=cfg, device="cpu",
                     prefix_caching=False, **BUCKETS),
        params=ref, num_replicas=1, ray_actor_options={"num_gpus": 1})
    handle = serve.run(app, name="params", timeout_s=120)
    first = _streams(handle)
    assert all(len(s) == 8 for s in first)

    del ref, app  # the driver's last reference
    gc.collect()
    (old_id, old_pid), = _replicas(rt, node).items()
    os.kill(old_pid, signal.SIGKILL)
    assert _wait(lambda: (lambda r: len(r) == 1 and old_id not in r)(
        _replicas(rt, node)))
    assert _wait(lambda: serve.status()["params"]["LLMDeployment"][
        "status"] == "HEALTHY")
    assert _streams(handle) == first
    assert not node.gcs.object_dir.get(oid, {}).get("freed")

    serve.delete("params")
    assert _wait(lambda: node.gcs.object_dir.get(oid, {}).get("freed"), 30)
    assert _wait(lambda: not _replicas(rt, node), 30)
