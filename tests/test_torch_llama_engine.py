"""The port's ``LLMEngine`` serving Llama (``EngineConfig(model="llama")``)
against the JAX package's engine on the same converted tiny f32 weights:
identical streams, greedy and seeded-sampled, with requests joining the
port's engine mid-stream, unquantized and int8 (greedy), at query-group
sizes G = 2 (``LlamaConfig.tiny()``) and G = 3 (6 query heads on 2 kv
heads). The pool holds the kv heads only, and is whole at the end.

One batch bucket and one length bucket keep the JAX side to few
programs."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

BUCKETS = dict(block_size=8, num_blocks=64, batch_buckets=(4,),
               length_buckets=(32,))


@pytest.fixture(autouse=True)
def _cpu(jax_cpu):
    return jax_cpu


def _weights(groups):
    import jax
    import jax.numpy as jnp
    from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from ray_tpu.models.llama import llama_init

    from ray_tpu_torch.models.llama import LlamaConfig

    shape = {} if groups == 2 else dict(n_head=6, n_kv_head=2, d_model=96)
    jcfg = dataclasses.replace(JaxLlamaConfig.tiny(), dtype=jnp.float32,
                               attention="xla", **shape)
    tcfg = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32,
                               **shape)
    tree = jax.tree.map(np.asarray, llama_init(jax.random.PRNGKey(groups),
                                               jcfg))
    return jcfg, tcfg, tree


@pytest.mark.parametrize("groups,kind", [(2, None), (3, None), (2, "int8"),
                                         (3, "int8")])
def test_llama_streams_match_jax_engine(groups, kind):
    import jax
    import jax.numpy as jnp
    from ray_tpu.serve.llm import EngineConfig as JaxEngineConfig
    from ray_tpu.serve.llm import LLMEngine as JaxLLMEngine

    from ray_tpu_torch.convert import llama_params_from_numpy
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    jcfg, tcfg, tree = _weights(groups)
    rng = np.random.default_rng(groups)
    shapes = [(6, {}), (17, {"temperature": 0.8, "top_p": 0.9, "seed": 4}),
              (3, {"temperature": 1.1, "top_k": 30, "seed": 9}), (10, {})]
    if kind:  # quantized: greedy
        shapes = [(n, {}) for n, _ in shapes]
    requests = [(rng.integers(0, 512, n).tolist(), kw) for n, kw in shapes]
    jax_engine = JaxLLMEngine(
        JaxEngineConfig(model="llama", model_config=jcfg,
                        prefix_caching=False, attention_backend="xla",
                        quantization=kind, prefill_chunk_tokens=8, **BUCKETS),
        params=jax.tree.map(jnp.asarray, tree), auto_step=False)
    jstreams = [jax_engine.submit(p, max_new_tokens=8, **kw)
                for p, kw in requests]
    while jax_engine.step():
        pass
    want = [list(s) for s in jstreams]
    jax_engine.shutdown()

    engine = LLMEngine(EngineConfig(model_config=tcfg, device="cpu",
                                    quantization=kind, prefill_chunk_tokens=8,
                                    **BUCKETS),
                       params=llama_params_from_numpy(tree, tcfg),
                       auto_step=False)
    assert engine.cfg.model == "llama"  # the default family, as in JAX
    assert engine.executor.family == "llama"
    streams = []
    for p, kw in requests:  # one joins every other step
        streams.append(engine.submit(p, max_new_tokens=8, **kw))
        engine.step()
        engine.step()
    while engine.step():
        pass
    assert [list(s) for s in streams] == want
    assert all(len(s) == 8 for s in want)
    c = engine.cache
    assert c.cfg.n_kv_head == tcfg.n_kv_head
    assert c.available_blocks == c.cfg.usable_blocks and c.reserved_blocks == 0
    snap = c.debug_snapshot()
    assert snap["freed_total"] == snap["allocated_total"]


def test_engine_family_default_and_refusals():
    from ray_tpu_torch.models.gpt import GPTConfig
    from ray_tpu_torch.models.llama import Llama, LlamaConfig
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    engine = LLMEngine(EngineConfig(device="cpu"), auto_step=False)
    assert isinstance(engine.executor.model, Llama)
    assert engine.model_cfg == dataclasses.replace(
        LlamaConfig.tiny(), attention_backend="torch")
    assert engine.cache.k.shape[3] == LlamaConfig.tiny().n_kv_head
    with pytest.raises(TypeError, match="LlamaConfig"):
        LLMEngine(EngineConfig(model_config=GPTConfig.tiny(), device="cpu"),
                  auto_step=False)
    with pytest.raises(ValueError, match="unknown model family"):
        LLMEngine(EngineConfig(model="mistral", device="cpu"),
                  auto_step=False)
