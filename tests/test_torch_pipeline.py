"""The port engine's dispatch-ahead decode pipeline (lag-1 sync, the
block quarantine, the decode signature set) on the CPU, ported from
``tests/test_serve_llm_decode.py``: staggered requests equal solo runs,
EOS and cancel under the lag end a stream exactly once with every block
back, sampling does not grow the signature set, and the pipelined
streams equal the JAX engine's on the same weights (greedy and sampled,
unquantized and int8). Tiny configs, a few seconds each."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

# one batch and one length bucket keep the JAX engine's compiles few
BUCKETS = dict(block_size=8, num_blocks=64, batch_buckets=(4,),
               length_buckets=(32,))


@pytest.fixture(autouse=True)
def _cpu(jax_cpu):
    return jax_cpu


def _config():
    from ray_tpu_torch.models.gpt import GPTConfig

    return dataclasses.replace(GPTConfig.tiny(), dtype=torch.float32)


def _engine(**kw):
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    kw.setdefault("block_size", 8)
    kw.setdefault("num_blocks", 64)
    kw.setdefault("model_config", _config())
    return LLMEngine(EngineConfig(model="gpt", device="cpu", seed=1, **kw),
                     auto_step=False)


def _drain(eng, streams, steps=400):
    for _ in range(steps):
        if all(s.done for s in streams):
            break
        eng.step()
    while eng.step():  # reconcile any in-flight step (lag-1 drain)
        pass


def _assert_pool_whole(eng):
    snap = eng.cache.debug_snapshot()
    assert snap["used_blocks"] == 0, snap
    assert snap["quarantined_blocks"] == 0, snap
    assert snap["reserved_blocks"] == 0, snap
    assert snap["live_sequences"] == 0, snap
    assert snap["freed_total"] == snap["allocated_total"], snap


def test_pipelined_engine_matches_solo_runs():
    """Dispatch-ahead is invisible in the outputs: staggered requests give
    exactly the solo-run tokens, and the sync records show that the
    pipeline reached its steady state (lag-1 syncs)."""
    prompts = [[1, 2, 3], [7] * 11, [100, 200, 300, 400, 5]]
    solo = [_engine().generate(p, max_new_tokens=10) for p in prompts]

    eng = _engine()
    streams = [eng.submit(prompts[0], max_new_tokens=10)]
    for _ in range(3):
        eng.step()
    streams.append(eng.submit(prompts[1], max_new_tokens=10))
    eng.step()
    streams.append(eng.submit(prompts[2], max_new_tokens=10))
    _drain(eng, streams)
    assert [list(s) for s in streams] == solo

    lags = [r["sync_lag"] for r in eng.debug_dump()["steps"]
            if r["kind"] == "decode"]
    assert 1 in lags, f"pipeline never reached steady state: {lags}"
    stats = eng.stats()
    assert stats["decode_inflight"] == 0  # fully drained
    assert stats["running"] == 0 and stats["kv_used_blocks"] == 0
    _assert_pool_whole(eng)


def test_decode_signatures_do_not_grow_with_sampling():
    """Sampling params are data: a mix of greedy / top-k / top-p / seeded
    requests records (prefill, prefill_chunk, decode) signatures only, and
    a second wave with new sampling values at the same shapes adds none."""
    eng = _engine()
    mixes = [dict(), dict(temperature=0.7, top_k=4, seed=1),
             dict(temperature=0.9, top_p=0.8, seed=2),
             dict(temperature=1.1, seed=3)]
    streams = [eng.submit([10 + i, 20 + i, 30 + i], max_new_tokens=6, **m)
               for i, m in enumerate(mixes)]
    _drain(eng, streams)
    sigs = eng.fns.signatures
    assert {s[0] for s in sigs} <= {"prefill", "prefill_chunk", "decode"}
    before = len(sigs)
    assert eng.stats()["num_compiled_shapes"] == before

    streams = [eng.submit([40 + i, 50 + i, 60 + i], max_new_tokens=6,
                          temperature=0.3 + 0.1 * i, top_k=2 + i,
                          seed=100 + i)
               for i in range(4)]
    _drain(eng, streams)
    assert len(eng.fns.signatures) == before


def test_eos_under_lag_terminates_exactly_once():
    """A request hitting EOS while its next token is already in flight
    never emits the speculative token and releases its blocks exactly
    once; the pool serves follow-up traffic at full capacity."""
    probe = _engine().generate([4, 4, 8], max_new_tokens=3)
    eos = probe[1]
    expected = probe[: probe.index(eos) + 1]  # up to and including EOS

    eng = _engine(eos_id=eos)
    s1 = eng.submit([4, 4, 8], max_new_tokens=50)
    s2 = eng.submit([7] * 9, max_new_tokens=20)
    _drain(eng, streams := [s1, s2])
    assert list(s1) == expected, "tokens past EOS leaked into the stream"
    assert all(s.done for s in streams)
    _assert_pool_whole(eng)

    again = eng.generate([4, 4, 8], max_new_tokens=50)
    while eng.step():
        pass
    assert again == expected
    _assert_pool_whole(eng)


def test_cancel_in_flight_releases_exactly_once():
    """Cancelling a row while a step that includes it is in flight fails
    its stream at once, defers its release to the reconcile of that step
    (then quarantined while the next step is in flight), and frees every
    block exactly once; the other row's stream is its solo run."""
    from ray_tpu_torch.serve.llm import RequestCancelledError

    keep_prompt, drop_prompt = [5, 6, 7, 8], [9] * 7
    solo = _engine().generate(keep_prompt, max_new_tokens=12)
    eng = _engine()
    keep = eng.submit(keep_prompt, max_new_tokens=12)
    drop = eng.submit(drop_prompt, max_new_tokens=12)
    for _ in range(4):  # prefill, then decode steps into the steady state
        eng.step()
    assert eng.stats()["decode_inflight"] == 1
    row = next(r for r in eng._running if r.id == drop.request_id)
    assert row.inflight == 1
    assert eng.cancel(drop.request_id)
    assert not eng.cancel(drop.request_id)
    with pytest.raises(RequestCancelledError):
        list(drop)
    # still in flight: its blocks are held until that step is reconciled
    assert eng.cache.debug_snapshot()["live_sequences"] == 2
    assert not row.blocks_released
    eng.step()  # the batch changed: collapse the lag, release the row
    assert row.blocks_released and row.inflight == 0
    _drain(eng, [keep])
    assert list(keep) == solo
    _assert_pool_whole(eng)


def test_host_sync_moves_o_batch_int32():
    """Every sync moves the bucketed batch's int32 ids, never logits."""
    eng = _engine()
    streams = [eng.submit([i + 1] * 5, max_new_tokens=8) for i in range(3)]
    _drain(eng, streams)
    recs = eng.debug_dump()["steps"]
    assert recs
    buckets = set(eng._batch_buckets)
    for r in recs:
        assert r["sync_bytes"] % 4 == 0 and r["sync_bytes"] // 4 in buckets
    assert eng.stats()["host_sync_bytes_total"] == sum(
        r["sync_bytes"] for r in recs)


def test_device_feed_only_from_the_last_decode_step():
    """A decode step is fed on the device from the ids of the decode step
    dispatched last, never from an older one: on a card the graphs share
    one memory pool, so a later replay may have overwritten those."""
    eng = _engine()
    ex = eng.executor
    B, nb = 4, 4
    tables = np.arange(1, 1 + B * nb, dtype=np.int32).reshape(B, nb)
    positions = np.full(B, 3, np.int32)
    first = ex.decode_step(np.ones(B, np.int32), positions, tables)
    second = ex.decode_step(first, positions + 1, tables)
    with pytest.raises(RuntimeError, match="dispatched last"):
        ex.stage_decode(first, positions + 2, tables)
    third = ex.decode_step(second, positions + 2, tables)
    assert ex.sync_tokens(third).shape == (B,)


@pytest.fixture(scope="module")
def weights():
    import jax
    import jax.numpy as jnp
    from ray_tpu.models.gpt import GPTConfig as JaxGPTConfig
    from ray_tpu.models.gpt import gpt_init

    from ray_tpu_torch.convert import gpt_params_from_numpy

    jcfg = dataclasses.replace(JaxGPTConfig.tiny(), dtype=jnp.float32,
                               attention="xla")
    tcfg = _config()
    tree = jax.tree.map(np.asarray, gpt_init(jax.random.PRNGKey(2), jcfg))
    return jcfg, tree, tcfg, gpt_params_from_numpy(tree, tcfg)


@pytest.mark.parametrize("kind", [None, "int8"])
def test_pipelined_streams_match_jax_engine(weights, kind):
    """The pipelined port engine, with requests joining mid-stream, gives
    the JAX engine's streams on the same weights, greedy and sampled."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.serve.llm import EngineConfig as JaxEngineConfig
    from ray_tpu.serve.llm import LLMEngine as JaxLLMEngine

    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    jcfg, tree, tcfg, state = weights
    rng = np.random.default_rng(3)
    requests = [(rng.integers(0, 512, n).tolist(), kw) for n, kw in (
        (6, {}), (14, {"temperature": 0.8, "top_p": 0.9, "seed": 4}),
        (3, {"temperature": 1.1, "top_k": 30, "seed": 9}), (10, {}))]
    jax_engine = JaxLLMEngine(
        JaxEngineConfig(model="gpt", model_config=jcfg, prefix_caching=False,
                        attention_backend="xla", quantization=kind,
                        **BUCKETS),
        params=jax.tree.map(jnp.asarray, tree), auto_step=False)
    jstreams = [jax_engine.submit(p, max_new_tokens=10, **kw)
                for p, kw in requests]
    while jax_engine.step():
        pass
    want = [list(s) for s in jstreams]
    jax_engine.shutdown()

    eng = LLMEngine(EngineConfig(model="gpt", model_config=tcfg, device="cpu",
                                 quantization=kind, **BUCKETS),
                    params=state, auto_step=False)
    streams = []
    for p, kw in requests:  # one joins every other step
        streams.append(eng.submit(p, max_new_tokens=10, **kw))
        eng.step()
        eng.step()
    _drain(eng, streams)
    assert [list(s) for s in streams] == want
    assert 1 in [r["sync_lag"] for r in eng.debug_dump()["steps"]]
    _assert_pool_whole(eng)
