"""The port's Serve on the card (marked ``gpu``: skips without an NVIDIA
card of compute capability 9.0 or more): a tiny f32 Llama app
(``build_llm_app``) in a ``num_gpus=1`` replica, on weights carried
through the object store, serves on the replica's ``cuda:0`` with the CUDA
kernels, and its streams, through the handle and over HTTP, equal an
in-process engine's on the same weights, greedy and sampled."""
from __future__ import annotations

import dataclasses
import json
import urllib.request

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

BUCKETS = dict(block_size=16, num_blocks=64, max_batch_size=4,
               batch_buckets=(4,), length_buckets=(64,))


@pytest.fixture(scope="module")
def served():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability >= 9.0 (kernels target sm_90a)")
    import ray_tpu_torch
    from ray_tpu_torch import serve

    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    serve.start(http_options={"port": 0})
    yield ray_tpu_torch, serve
    serve.shutdown()
    ray_tpu_torch.shutdown()


@pytest.mark.timeout(600)
def test_tiny_llama_replica_streams_equal_in_process(served):
    from ray_tpu_torch.models.families import family
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.serve.llm import (
        EngineConfig,
        LLMEngine,
        SamplingParams,
        build_llm_app,
        stream_tokens,
    )

    rt, serve = served
    cfg = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32)
    weights = {k: v.detach().cpu() for k, v in family("llama").init(
        cfg, 3, torch.device("cuda", 0)).weights().items()}
    ecfg = EngineConfig(model="llama", model_config=cfg,
                        prefix_caching=False, **BUCKETS)
    rng = np.random.default_rng(3)
    requests = [dict(prompt=rng.integers(0, 512, n).tolist(),
                     max_new_tokens=12, **kw) for n, kw in (
        (6, {}), (40, {"temperature": 0.8, "top_p": 0.9, "seed": 4}),
        (3, {"temperature": 1.1, "top_k": 30, "seed": 9}), (21, {}))]
    engine = LLMEngine(ecfg, params=weights, auto_step=False)
    streams = [engine.submit(r["prompt"], SamplingParams(**{
        k: v for k, v in r.items() if k != "prompt"})) for r in requests]
    while engine.step():
        pass
    want = [list(s) for s in streams]
    engine.shutdown()
    del engine
    torch.cuda.empty_cache()

    handle = serve.run(build_llm_app(ecfg, params=rt.put(weights),
                                     ray_actor_options={"num_gpus": 1}),
                       name="llm", route_prefix="/llm", timeout_s=300)
    got = [[c["token"] for c in stream_tokens(handle, r)] for r in requests]
    assert got == want
    port = serve.api._proxy.port
    for r, w in zip(requests, want):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/llm", data=json.dumps(r).encode(),
            headers={"Accept": "text/event-stream"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = resp.read().decode()
        tokens = [json.loads(line[6:])["token"]
                  for line in body.split("\n\n") if line.startswith("data: ")]
        assert tokens == w
    dump = handle.broadcast("debug_dump")[0]
    assert dump["executor"]["device"] == torch.cuda.get_device_name(0)
    assert dump["executor"]["attention_backend"] == "cuda"
    assert dump["executor"]["graphs"]["decode"] > 0
    assert dump["cache"]["used_blocks"] == 0
