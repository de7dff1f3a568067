"""Priority classes, preemption and admission control in the port's
engine against the JAX engine, on the CPU (the scenarios of
``tests/test_serve_llm_priority.py``, ``tests/test_serve_llm_prefix.py``
(f) and ``tests/test_serve_llm_ft.py``): a batch-class stream parked on
the host KV tier under an interactive flood and resumed (greedy and
nucleus, GPT and Llama) gives the JAX engine's streams and
``preemptions_total`` / ``kv_demoted_blocks`` / ``kv_promoted_blocks``,
and the stream of an engine that never parks it; a resume that promotes
its chain back from the host tier; cancel, deadline and shutdown while
parked, with every block back once; the aging floor; the
``preempt_exhausted`` latch; parking under structured output and
speculation; admission skip-ahead and its aging cap; the queue limits'
refusals; the configs' fields and defaults.

Tiny f32 configs whose weights are the JAX init at ``PRNGKey(0)`` carried
across by ``convert.py``; block 4, 24 blocks, one batch and one length
bucket keep the JAX side to few programs. Where counts are compared the
thresholds are pressure-only (``PRESSURE``: the queue-wait and aging
clocks out of reach), so the counts depend on the step sequence alone."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

BUCKETS = dict(block_size=4, num_blocks=24, batch_buckets=(8,),
               length_buckets=(64,))
PRESSURE = dict(kv_pressure=0.5, queue_wait_s=1e6, resume_pressure=0.4,
                aging_s=1e6)
TIER = 1 << 20  # host tier bytes: every chain of the traffic fits
BATCH_PROMPT = [5, 6, 7, 8, 9, 11]
BATCH_NEW = 16
# the flood: 6 interactive prompts of 12 tokens whose budgets stagger
# their completions, so the parked chain sits in the device LRU while the
# pool keeps turning over (and is evicted to the host tier before resume)
FLOOD, FLOOD_LEN, FLOOD_NEW = 6, 12, (4, 8, 12)
SAMPLINGS = [dict(), dict(temperature=0.8, top_p=0.9, seed=7)]
COUNTERS = ("preemptions_total", "kv_demoted_blocks", "kv_promoted_blocks",
            "prefix_evicted_blocks", "prefix_hit_tokens", "rejected_total",
            "preempted", "preempt_exhausted")


@pytest.fixture(autouse=True)
def _cpu(jax_cpu):
    return jax_cpu


class _Clock:
    """A stand-in for the port engine's clock (``obs.clock``, which every
    deadline and preemption age reads): ``monotonic()`` reads ``now``,
    which the test moves (deadlines and aging without sleeping, and
    without depending on the machine's speed)."""

    def __init__(self):
        self.now = 0.0

    def monotonic(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    from ray_tpu_torch.serve.llm import obs

    fake = _Clock()
    monkeypatch.setattr(obs, "clock", fake.monotonic)
    return fake


_WEIGHTS: dict = {}


def _weights(fam):
    """(jcfg, tcfg, numpy tree, the port's state dict), the JAX init at
    PRNGKey(0), made once per family."""
    if fam not in _WEIGHTS:
        import jax
        import jax.numpy as jnp

        from ray_tpu_torch import convert

        if fam == "gpt":
            from ray_tpu.models.gpt import GPTConfig as J
            from ray_tpu.models.gpt import gpt_init as init

            from ray_tpu_torch.models.gpt import GPTConfig as T
            to_port = convert.gpt_params_from_numpy
        else:
            from ray_tpu.models.llama import LlamaConfig as J
            from ray_tpu.models.llama import llama_init as init

            from ray_tpu_torch.models.llama import LlamaConfig as T
            to_port = convert.llama_params_from_numpy
        jcfg = dataclasses.replace(J.tiny(), dtype=jnp.float32,
                                   attention="xla")
        tcfg = dataclasses.replace(T.tiny(), dtype=torch.float32)
        tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), jcfg))
        _WEIGHTS[fam] = (jcfg, tcfg, tree, to_port(tree, tcfg))
    return _WEIGHTS[fam]


def _jax_engine(fam="llama", **kw):
    import jax
    import jax.numpy as jnp
    from ray_tpu.serve.llm import EngineConfig, LLMEngine

    jcfg, _, tree, _ = _weights(fam)
    return LLMEngine(EngineConfig(model=fam, model_config=jcfg,
                                  attention_backend="xla",
                                  **{**BUCKETS, **kw}),
                     params=jax.tree.map(jnp.asarray, tree), auto_step=False)


def _port_engine(fam="llama", **kw):
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    _, tcfg, _, state = _weights(fam)
    return LLMEngine(EngineConfig(model=fam, model_config=tcfg, device="cpu",
                                  **{**BUCKETS, **kw}),
                     params=state, auto_step=False)


def _both(fam="llama", **kw):
    return _jax_engine(fam, **kw), _port_engine(fam, **kw)


def _counters(eng) -> dict:
    st = eng.stats()
    return {k: st[k] for k in COUNTERS}


def _assert_pool_whole(eng):
    c = eng.cache
    snap = c.debug_snapshot()
    assert snap["used_blocks"] == 0, snap
    assert snap["quarantined_blocks"] == 0, snap
    assert snap["reserved_blocks"] == 0, snap
    assert snap["live_sequences"] == 0, snap
    assert c.available_blocks == c.cfg.usable_blocks, snap


def _flood(eng, n=FLOOD, seed0=100, **kw):
    rng = np.random.default_rng(seed0)
    return [eng.submit(rng.integers(1, 500, FLOOD_LEN).tolist(),
                       max_new_tokens=FLOOD_NEW[i % len(FLOOD_NEW)],
                       priority="interactive", temperature=0.8,
                       seed=seed0 + i, **kw)
            for i in range(n)]


def _drain(eng):
    while eng.step():
        pass


def _park_and_flood(eng, **sampling):
    """A batch stream decodes two steps, then the flood arrives; stepped
    until idle. -> (batch stream, flood streams)."""
    batch = eng.submit(BATCH_PROMPT, max_new_tokens=BATCH_NEW,
                       priority="batch", **sampling)
    for _ in range(3):  # prefill, two decode steps
        eng.step()
    inter = _flood(eng)
    _drain(eng)
    return batch, inter


def _unparked(fam="llama", **sampling):
    """The batch stream of an engine without preemption."""
    return _port_engine(fam).generate(BATCH_PROMPT, max_new_tokens=BATCH_NEW,
                                      **sampling)


def _park_one(eng, **sampling):
    """Submit a batch stream, start it, flood; step until it is parked."""
    batch = eng.submit(BATCH_PROMPT, max_new_tokens=BATCH_NEW,
                       priority="batch", **sampling)
    eng.step()
    eng.step()
    inter = _flood(eng)
    for _ in range(20):
        if eng.stats()["preempted"] == 1:
            break
        eng.step()
    assert eng.stats()["preempted"] == 1, "batch stream never parked"
    return batch, inter


# ------------------------------------------------ preempt / resume

@pytest.mark.timeout(120)
@pytest.mark.parametrize("fam", ["gpt", "llama"])
@pytest.mark.parametrize("sampling", SAMPLINGS, ids=["greedy", "nucleus"])
def test_preempt_resume_equals_jax(fam, sampling):
    """Under the flood the batch stream is parked (its chain demoted to
    the host tier), evicted from the device while parked, promoted back
    on resume and completed: every stream and the preemption and tier
    counters equal the JAX engine's, the batch stream equals an unparked
    run's, and the pool is whole."""
    kw = dict(preemption=dict(PRESSURE), host_cache_bytes=TIER)
    outs, counts = [], []
    for eng in _both(fam, **kw):
        batch, inter = _park_and_flood(eng, **sampling)
        outs.append([list(batch)] + [list(s) for s in inter])
        counts.append(_counters(eng))
    assert outs[1] == outs[0]
    assert counts[1] == counts[0]
    assert counts[1]["preemptions_total"] >= 1
    assert counts[1]["kv_promoted_blocks"] >= 1
    assert counts[1]["preempted"] == 0
    assert outs[1][0] == _unparked(fam, **sampling)
    assert [len(o) for o in outs[1][1:]] == [
        FLOOD_NEW[i % len(FLOOD_NEW)] for i in range(FLOOD)]
    _assert_pool_whole(eng)


@pytest.mark.timeout(120)
def test_resume_promotes_the_parked_chain_from_the_host_tier():
    """The parked chain is demoted at the park, evicted from the device
    while parked, and its resume promotes it back from the host tier:
    the resumed stream equals an unparked run's."""
    from ray_tpu_torch.serve.llm.kv_cache import _block_key

    eng = _port_engine(preemption=dict(PRESSURE), host_cache_bytes=TIER)
    batch, inter = _park_one(eng)
    req = batch._request
    first = _block_key(b"", req.pending_resume[:BUCKETS["block_size"]])
    assert first in eng.cache.host_tier
    demoted = eng.stats()["kv_demoted_blocks"]
    assert demoted >= 1
    for _ in range(200):  # the flood turns the pool over while parked
        if not eng.cache.has_digest(first):
            break
        eng.step()
    assert req in eng._preempted and not eng.cache.has_digest(first)
    promoted = eng.stats()["kv_promoted_blocks"]
    for _ in range(200):
        if req not in eng._preempted:
            break
        eng.step()
    assert eng.stats()["kv_promoted_blocks"] > promoted
    _drain(eng)
    assert list(batch) == _unparked()
    assert req.preempt_count == 1
    _assert_pool_whole(eng)


# ------------------------------------------------ leaving while parked

@pytest.mark.timeout(120)
@pytest.mark.parametrize("how", ["cancel", "deadline", "shutdown"])
def test_parked_stream_leaves_exactly_once(how, clock):
    """A parked stream holds no blocks: cancel, its deadline and
    shutdown end it with its error and release nothing twice; the flood
    still completes and the pool is whole."""
    from ray_tpu_torch.serve.llm import (
        DeadlineExceededError,
        RequestCancelledError,
    )

    eng = _port_engine(preemption=dict(PRESSURE), host_cache_bytes=TIER)
    deadline = dict(deadline_s=5.0) if how == "deadline" else {}
    batch, inter = _park_one(eng, **deadline)
    got = []
    if how == "cancel":
        assert eng.cancel(batch.request_id) is True
        assert eng.cancel(batch.request_id) is False
        err = RequestCancelledError
    elif how == "deadline":
        clock.now = 5.0
        eng.step()  # the sweep reaches the parked stream
        assert eng.stats()["deadline_exceeded_total"] == 1
        err = DeadlineExceededError
    else:
        eng.shutdown()
        err = RequestCancelledError
    assert eng.stats()["preempted"] == 0
    with pytest.raises(err):
        for tok in batch:
            got.append(tok)
    assert 0 < len(got) < BATCH_NEW
    if how == "shutdown":
        for s in inter:
            with pytest.raises(RequestCancelledError):
                list(s)
        return
    _drain(eng)
    assert [len(list(s)) for s in inter] == [
        FLOOD_NEW[i % len(FLOOD_NEW)] for i in range(FLOOD)]
    _assert_pool_whole(eng)


# ------------------------------------------------ starvation floor, latch

@pytest.mark.timeout(120)
def test_aging_floor_resumes_under_sustained_pressure(clock):
    """Under a flood that never lets the pool empty (and with
    ``resume_pressure`` 0, only an empty pool resumes by pressure), the
    parked batch stream stays parked until it ages past the floor, then
    resumes regardless of pressure, is never parked a second time and
    completes an unparked run's tokens."""
    eng = _port_engine(preemption=dict(PRESSURE, aging_s=1.0,
                                       resume_pressure=0.0),
                       host_cache_bytes=TIER)
    batch, inter = _park_one(eng)
    seed = 500
    for i in range(400):
        if batch.done:
            break
        if i == 40:
            assert batch._request in eng._preempted
            clock.now = 1.0  # the park ages past the floor
        if eng.stats()["waiting"] < 2:
            inter.extend(_flood(eng, 2, seed0=seed))
            seed += 2
        eng.step()
    assert batch.done, "the aged batch stream starved under the flood"
    assert batch._request.preempt_count == 1
    _drain(eng)
    assert list(batch) == _unparked()
    _assert_pool_whole(eng)


@pytest.mark.timeout(120)
def test_preempt_exhausted_latch_equals_jax():
    """Interactive hogs hold the pool and an interactive waiter cannot
    fit: pressure holds but no running stream is outranked, so
    ``preempt_exhausted`` latches (step by step as the JAX engine's) and
    nothing is parked."""
    seqs, outs = [], []
    for eng in _both(num_blocks=12, preemption=dict(PRESSURE)):
        hogs = [eng.submit([21 + i, 3, 4], max_new_tokens=24,
                           priority="interactive", temperature=0.8,
                           seed=60 + i) for i in range(2)]
        eng.step()
        waiter = eng.submit([31, 3, 4, 5], max_new_tokens=24,
                            priority="interactive", temperature=0.8,
                            seed=70)
        seq = []
        while eng.step():
            seq.append(eng.stats()["preempt_exhausted"])
        seqs.append(seq)
        outs.append([list(s) for s in hogs + [waiter]])
        assert eng.stats()["preemptions_total"] == 0
    assert seqs[1] == seqs[0] and True in seqs[1]
    assert outs[1] == outs[0]
    _assert_pool_whole(eng)


# ------------------------------------------------ composition

class _Oracle:
    """A drafter that proposes the batch stream's next two tokens (an
    unparked run's) and then a wrong one, so a verify window accepts two
    drafts and corrects the third before and after the park; it drafts
    nothing for other prompts."""

    def __init__(self, ref):
        self.ref = ref

    def propose(self, prompt, generated, k):
        if list(prompt) != BATCH_PROMPT:
            return []
        n = len(generated)
        return (self.ref[n:n + 2] + [(self.ref[n + 2] + 1) % 512]
                if n + 2 < len(self.ref) else [])[:k]


@pytest.mark.timeout(120)
@pytest.mark.parametrize("extra", ["structured", "speculative"])
def test_preempt_composes_with_structured_and_speculation(extra):
    """A JSON-mode batch stream parks with its grammar cursor and resumes
    grammar-valid; with ``speculative_k=4`` the drafter reads the resumed
    chain and verify windows commit across the park: streams and
    counters equal the JAX engine's, and the batch stream an unparked
    run's."""
    from ray_tpu_torch.serve.llm import structured

    if extra == "structured":
        engine_kw = {}
        sampling = dict(temperature=0.8, seed=1, structured="json")
        ref = _unparked(**sampling)
    else:
        ref = _unparked()
        engine_kw = dict(speculative_k=4, drafter=_Oracle(ref))
        sampling = {}
    outs, counts, spec = [], [], []
    for eng in _both(preemption=dict(PRESSURE), host_cache_bytes=TIER,
                     **engine_kw):
        batch, inter = _park_and_flood(eng, **sampling)
        outs.append([list(batch)] + [list(s) for s in inter])
        counts.append(_counters(eng))
        st = eng.stats()
        spec.append({k: st[k] for k in ("spec_steps", "spec_drafted_tokens",
                                        "spec_accepted_tokens")})
    assert outs[1] == outs[0]
    assert counts[1] == counts[0] and spec[1] == spec[0]
    assert counts[1]["preemptions_total"] >= 1
    assert outs[1][0] == ref and len(ref) == BATCH_NEW
    if extra == "structured":
        dfa = structured.compile_grammar(
            structured.parse_response_format("json"),
            eng.model_cfg.vocab_size, eng.cfg.eos_id)
        cur = structured.FSMCursor(dfa)
        assert all(cur.advance(t) for t in ref)
    else:
        # windows before the park and after the resume
        assert spec[1]["spec_steps"] > 2 and spec[1]["spec_accepted_tokens"]
    _assert_pool_whole(eng)


# ------------------------------------------------ admission

@pytest.mark.timeout(120)
@pytest.mark.parametrize("max_skips", [16, 1], ids=["skip_ahead",
                                                   "aging_cap"])
def test_admission_skip_ahead_equals_jax(max_skips):
    """A hog holds most of the pool; a big head cannot fit and small
    requests behind it are admitted past it, until the head has been
    skipped ``admission_max_skips`` times: the queue after each step and
    every stream equal the JAX engine's."""
    results = []
    for eng in _both(num_blocks=17, max_batch_size=4, max_prefill_batch=4,
                     admission_max_skips=max_skips):
        hog = eng.submit([1] * 5, max_new_tokens=43)     # 12 blocks of 16
        eng.step()
        big = eng.submit([2] * 6, max_new_tokens=12)     # 5: cannot fit
        s1 = eng.submit([3] * 3, max_new_tokens=4)
        eng.step()
        waiting = [eng.stats()["waiting"]]
        s2 = eng.submit([4] * 3, max_new_tokens=4)
        while eng.step():
            waiting.append(eng.stats()["waiting"])
        results.append((waiting, [list(s) for s in (hog, big, s1, s2)]))
        _assert_pool_whole(eng)
    assert results[1] == results[0]
    waiting, outs = results[1]
    # s1 went past the head; under the cap s2 waits behind it
    assert waiting[:2] == ([1, 1] if max_skips > 1 else [1, 2])
    assert [len(o) for o in outs] == [43, 12, 4, 4]


@pytest.mark.timeout(120)
@pytest.mark.parametrize("limit", ["max_waiting", "max_waiting_blocks"])
def test_queue_limits_refuse_as_jax(limit):
    """A full queue refuses with ``EngineOverloadedError`` and the JAX
    engine's message; ``rejected_total`` counts the refusals; the queued
    requests still run, and admission frees the budget."""
    from ray_tpu.serve.llm import EngineOverloadedError as JErr

    from ray_tpu_torch.serve.llm import EngineOverloadedError as TErr

    kw = {limit: 2 if limit == "max_waiting" else 4}  # 2 blocks a request
    results = []
    for eng, err in zip(_both(**kw), (JErr, TErr)):
        streams = [eng.submit([1, 2, 3], max_new_tokens=4)
                   for _ in range(2)]
        msgs = []
        for _ in range(3):
            with pytest.raises(err) as info:
                eng.submit([1, 2, 3], max_new_tokens=4)
            msgs.append(str(info.value))
        rejected = eng.stats()["rejected_total"]
        eng.step()  # admission drains the queue and its budget
        streams.append(eng.submit([1, 2, 3], max_new_tokens=4))
        _drain(eng)
        results.append((msgs, rejected, [list(s) for s in streams]))
    assert results[1] == results[0]
    assert results[1][1] == 3
    assert "admission queue full (2 waiting" in results[1][0][0]
    _assert_pool_whole(eng)


# ------------------------------------------------ the surface

def test_priority_and_preemption_config_equal_jax():
    """``PreemptionConfig``'s fields and defaults, the new
    ``EngineConfig`` fields' defaults, ``PRIORITY_RANK`` and the
    ``SamplingParams.priority`` check equal the reference's; a dict
    becomes a ``PreemptionConfig``."""
    from ray_tpu.serve.llm import engine as J

    from ray_tpu_torch.serve.llm import engine as T

    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(T.PreemptionConfig) == fields(J.PreemptionConfig)
    jdef, tdef = dict(fields(J.EngineConfig)), dict(fields(T.EngineConfig))
    for name in ("max_waiting", "max_waiting_blocks", "admission_probe",
                 "admission_max_skips", "preemption"):
        assert tdef[name] == jdef[name], name
    assert T.PRIORITY_RANK == J.PRIORITY_RANK
    assert T.SamplingParams().priority == J.SamplingParams().priority
    eng = _port_engine(preemption=dict(kv_pressure=0.7))
    assert eng._preemption == T.PreemptionConfig(kv_pressure=0.7)
    assert _port_engine()._preemption is None


@pytest.mark.timeout(120)
def test_priority_workload_rehearsal_parks_promotes_and_completes():
    """``chip_smoke.priority_rehearsal``: the card's priority traffic
    (``engine_profile.priority_workload`` on its engine geometry) at tiny
    widths on the CPU parks two distinct batch streams, promotes a parked
    chain back from the host tier, resumes every parked stream and
    completes every stream at its budget with the pool whole (the
    checks of ``chip_smoke.priority_checks``); without preemption
    nothing is parked. The card's counts are held to these."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    counts = smoke.priority_rehearsal(torch)
    on, off = counts[True], counts[False]
    assert len(set(on["parked"])) >= 2 and on["kv_promoted_blocks"] >= 1
    assert on["preemptions_total"] == len(on["parked"])
    assert off["preemptions_total"] == 0 and off["parked"] == []
