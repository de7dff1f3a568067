"""The port's ``LLMEngine`` (``ray_tpu_torch.serve.llm``) against the JAX
package's engine on the same converted tiny f32 weights: identical greedy
and seeded-sampled streams, with and without chunked prefill; batched
equals solo; the pool is whole again after completion and after cancel.

Both engines run with one batch bucket and one length bucket so the JAX
side compiles few programs."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

BUCKETS = dict(block_size=8, num_blocks=64, batch_buckets=(4,),
               length_buckets=(32,))
REQUESTS = [  # (prompt length, sampling overrides)
    (5, {}),
    (19, {"temperature": 0.8, "top_p": 0.9, "seed": 11}),
    (12, {"temperature": 1.2, "top_k": 20, "seed": 2**31 + 3}),
    (9, {}),
]


@pytest.fixture(autouse=True)
def _cpu(jax_cpu):
    return jax_cpu


@pytest.fixture(scope="module")
def weights():
    import jax
    import jax.numpy as jnp
    from ray_tpu.models.gpt import GPTConfig as JaxGPTConfig
    from ray_tpu.models.gpt import gpt_init

    from ray_tpu_torch.convert import gpt_params_from_numpy
    from ray_tpu_torch.models.gpt import GPTConfig

    jcfg = dataclasses.replace(JaxGPTConfig.tiny(), dtype=jnp.float32,
                               attention="xla")
    tcfg = dataclasses.replace(GPTConfig.tiny(), dtype=torch.float32)
    tree = jax.tree.map(np.asarray, gpt_init(jax.random.PRNGKey(1), jcfg))
    return jcfg, tree, tcfg, gpt_params_from_numpy(tree, tcfg)


def _prompts():
    rng = np.random.default_rng(0)
    return [(rng.integers(0, 512, n).tolist(), kw) for n, kw in REQUESTS]


def _port_engine(weights, **kw):
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    _, _, tcfg, state = weights
    cfg = EngineConfig(model_config=tcfg, device="cpu", **BUCKETS, **kw)
    return LLMEngine(cfg, params=state, auto_step=False)


def _run(engine, requests, max_new_tokens=8):
    streams = [engine.submit(p, max_new_tokens=max_new_tokens, **kw)
               for p, kw in requests]
    while engine.step():
        pass
    return [list(s) for s in streams]


@pytest.mark.parametrize("chunk", [None, 8])
def test_streams_match_jax_engine(weights, chunk):
    import jax.numpy as jnp
    from ray_tpu.serve.llm import EngineConfig as JaxEngineConfig
    from ray_tpu.serve.llm import LLMEngine as JaxLLMEngine

    jcfg, tree, _, _ = weights
    jax_engine = JaxLLMEngine(
        JaxEngineConfig(model="gpt", model_config=jcfg, prefix_caching=False,
                        attention_backend="xla", prefill_chunk_tokens=chunk,
                        **BUCKETS),
        params=_jax_tree(tree, jnp),
        auto_step=False,
    )
    requests = _prompts()
    want = _run(jax_engine, requests)
    jax_engine.shutdown()
    got = _run(_port_engine(weights, prefill_chunk_tokens=chunk), requests)
    assert got == want
    assert all(len(s) == 8 for s in got)


def _jax_tree(tree, jnp):
    return {k: (_jax_tree(v, jnp) if isinstance(v, dict) else jnp.asarray(v))
            for k, v in tree.items()}


def test_batched_equals_solo_and_pool_whole(weights):
    requests = _prompts()
    engine = _port_engine(weights, prefill_chunk_tokens=8)
    batched = _run(engine, requests)
    solo = [_run(engine, [r])[0] for r in requests]
    assert batched == solo
    c = engine.cache
    assert c.free_blocks == c.cfg.usable_blocks and c.reserved_blocks == 0


def test_cancel_returns_blocks(weights):
    from ray_tpu_torch.serve.llm import RequestCancelledError

    engine = _port_engine(weights)
    (p0, _), (p1, _) = _prompts()[:2]
    keep = engine.submit(p0, max_new_tokens=8)
    drop = engine.submit(p1, max_new_tokens=8)
    engine.step()  # both prefilled
    engine.step()  # one decode step
    assert engine.cancel(drop.request_id)
    assert not engine.cancel(drop.request_id)
    with pytest.raises(RequestCancelledError):
        list(drop)
    while engine.step():
        pass
    assert len(list(keep)) == 8
    waiting = engine.submit(p0, max_new_tokens=4)
    assert engine.cancel(waiting.request_id)  # cancelled before admission
    c = engine.cache
    assert c.free_blocks == c.cfg.usable_blocks and c.reserved_blocks == 0
    engine.shutdown()


def test_auto_step_serves_and_shuts_down(weights):
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    _, _, tcfg, state = weights
    engine = LLMEngine(EngineConfig(model_config=tcfg, device="cpu",
                                    **BUCKETS), params=state)
    (prompt, _), = _prompts()[:1]
    try:
        assert engine.generate(prompt, max_new_tokens=5) == _run(
            _port_engine(weights), [(prompt, {})], max_new_tokens=5)[0]
    finally:
        engine.shutdown()
    assert engine.cache.free_blocks == engine.cache.cfg.usable_blocks


def test_submit_and_sampling_validation(weights):
    from ray_tpu_torch.serve.llm import SamplingParams

    engine = _port_engine(weights)
    with pytest.raises(ValueError, match="at least one token"):
        engine.submit([])
    with pytest.raises(ValueError, match="max_seq_len"):
        engine.submit([1] * 120, max_new_tokens=16)
    for bad in ({"max_new_tokens": 0}, {"temperature": -1.0},
                {"temperature": float("nan")}, {"top_k": -2},
                {"top_p": 0.0}, {"top_p": 1.5}):
        with pytest.raises(ValueError):
            SamplingParams(**bad)
    with pytest.raises(ValueError, match="int4"):
        _port_engine(weights, quantization="int4")  # a typo never serves f32
