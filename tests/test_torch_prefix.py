"""The port's prefix cache (content-addressed blocks, copy-on-write, LRU
eviction) against the JAX package's, on the CPU: the chain digest byte
for byte, ``PagedKVCache`` driven through one seeded sequence of
operations beside the JAX cache (tables, copy-on-write pairs, counts and
stats equal at every step), and the engine's streams and ``stats()``
prefix counters equal to the JAX engine's on shared-prefix traffic
(tiny GPT and Llama, f32 weights from a numpy seed; the scenarios of
``tests/test_serve_llm_prefix.py``): a full-chain hit diverging through
copy-on-write, chunked prefill from the first miss, LRU eviction, cancel
and ``release_all`` on shared blocks, a promotion and a copy-on-write
while a lag-1 decode step is in flight, and ``export_prefix`` of one
package adopted by the other's engine."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

# one batch bucket and two length buckets keep the JAX engine's compiles few
BUCKETS = dict(block_size=8, batch_buckets=(4,), length_buckets=(64, 128))
PREFIX_KEYS = ("prefix_hit_tokens", "prefix_hit_blocks",
               "prefix_cached_blocks", "prefix_evicted_blocks",
               "host_cache_blocks", "kv_demoted_blocks", "kv_promoted_blocks",
               "cow_blocks", "prefill_tokens_total", "prefix_hit_rate")


@pytest.fixture(autouse=True)
def _cpu(jax_cpu):
    return jax_cpu


@pytest.fixture(scope="module")
def models(jax_cpu):
    """Tiny f32 GPT and Llama weights (JAX init from a seed), as the JAX
    engine and the port take them."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.models.gpt import GPTConfig as JaxGPTConfig
    from ray_tpu.models.gpt import gpt_init
    from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from ray_tpu.models.llama import llama_init

    from ray_tpu_torch.convert import (
        gpt_params_from_numpy,
        llama_params_from_numpy,
    )
    from ray_tpu_torch.models.gpt import GPTConfig
    from ray_tpu_torch.models.llama import LlamaConfig

    out = {}
    for name, jc, init, tc, conv in (
        ("gpt", JaxGPTConfig, gpt_init, GPTConfig, gpt_params_from_numpy),
        ("llama", JaxLlamaConfig, llama_init, LlamaConfig,
         llama_params_from_numpy),
    ):
        jcfg = dataclasses.replace(jc.tiny(), dtype=jnp.float32,
                                   attention="xla")
        tcfg = dataclasses.replace(tc.tiny(), dtype=torch.float32)
        tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(2), jcfg))
        out[name] = (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
                     conv(tree, tcfg))
    return out


def jax_engine(models, family, **kw):
    from ray_tpu.serve.llm import EngineConfig, LLMEngine

    jcfg, jtree, _, _ = models[family]
    kw = {"num_blocks": 64, **BUCKETS, **kw}
    return LLMEngine(EngineConfig(model=family, model_config=jcfg,
                                  attention_backend="xla", **kw),
                     params=jtree, auto_step=False)


def port_engine(models, family, **kw):
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    _, _, tcfg, state = models[family]
    kw = {"num_blocks": 64, **BUCKETS, **kw}
    return LLMEngine(EngineConfig(model=family, model_config=tcfg,
                                  device="cpu", **kw),
                     params=state, auto_step=False)


def prefix_stats(eng) -> dict:
    st = eng.stats()
    return {k: st[k] for k in PREFIX_KEYS}


def drain(eng, streams, steps=600):
    """Step until idle (every in-flight step reconciled); the streams."""
    for _ in range(steps):
        if not eng.step():
            break
    assert all(s.done for s in streams)
    return [list(s) for s in streams]


def pool_is_clean(eng) -> bool:
    """No live blocks, no reservations; cached blocks are reclaimable."""
    c = eng.cache
    return (c.available_blocks == c.cfg.usable_blocks
            and c.reserved_blocks == 0 and c.used_blocks == 0)


def both(models, family, workload, **kw):
    """``workload(engine)`` on the JAX engine and the port's: equal
    outputs and equal prefix counters. -> (port engine, outputs)."""
    je = jax_engine(models, family, **kw)
    want = workload(je)
    want_stats = prefix_stats(je)
    je.shutdown()
    pe = port_engine(models, family, **kw)
    got = workload(pe)
    assert got == want
    assert prefix_stats(pe) == want_stats
    return pe, got


def shared_prefix(n=64, seed=42):
    return np.random.default_rng(seed).integers(1, 250, n).tolist()


# ------------------------------------------------------------ digests

@pytest.mark.parametrize("prev,tokens", [
    (b"", [1, 2, 3, 4, 5, 6, 7, 8]),
    (bytes(range(16)), [0] * 16),
    (b"\xff" * 16, [2**31 - 1, 511, 0, 31999]),
])
def test_block_key_matches_jax(prev, tokens):
    from ray_tpu.serve.llm.kv_cache import _block_key as jax_key

    from ray_tpu_torch.serve.llm.kv_cache import _block_key

    assert _block_key(prev, tokens) == jax_key(prev, tokens)
    assert _block_key(prev, np.asarray(tokens, np.int32)) == jax_key(
        prev, tokens)


# --------------------------------------------------- the cache, stepwise

def _caches(tier: bool):
    import jax.numpy as jnp
    from ray_tpu.serve.llm import kv_cache as jkv

    from ray_tpu_torch.serve.llm import kv_cache as tkv

    geo = dict(n_layer=1, n_kv_head=1, head_dim=8, num_blocks=12,
               block_size=4, host_cache_bytes=(1 << 16) if tier else 0)
    pair = (jkv.PagedKVCache(jkv.KVCacheConfig(dtype=jnp.float32, **geo)),
            tkv.PagedKVCache(tkv.KVCacheConfig(dtype=torch.float32, **geo)))
    for cache in pair:  # the executor's export, stubbed: block b holds b
        def demote_fn(ids):
            k = np.zeros((1, len(ids), 4, 1, 8), np.float32)
            for j, b in enumerate(ids):
                k[:, j] = float(b)
            return k, -k

        cache.demote_fn = demote_fn
    return pair


def _state(cache) -> dict:
    s = dataclasses.asdict(cache.stats)
    s.pop("tables", None)  # the JAX cache's, never filled
    tier = cache.host_tier
    return {"tables": {k: list(v) for k, v in cache._tables.items()},
            "ref": dict(cache._ref), "lru": list(cache._lru),
            "free": list(cache._free), "quarantine": list(cache._quarantine),
            "reserved": cache._reserved, "stats": s,
            "used": cache.used_blocks, "cached": cache.cached_blocks,
            "available": cache.available_blocks,
            "spare": cache.spare_blocks,
            "tier": None if tier is None else (list(tier.digests()),
                                               tier.nbytes)}


@pytest.mark.parametrize("tier", [False, True], ids=["device", "host_tier"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_cache_matches_jax_stepwise(seed, tier):
    """One seeded sequence of admissions (peek, reserve, allocate,
    ``assign_prefix``), prefill chunks and decode appends
    (``ensure_capacity``, ``prepare_write``, ``register_prefix``),
    promotions drained and landed, frees (quarantined or not), quarantine
    flushes and a final ``release_all``, applied to both caches: every
    return value and the whole state equal after every step."""
    jc, tc = _caches(tier)
    rng = np.random.default_rng(seed)
    stems = [rng.integers(1, 50, 8).tolist() for _ in range(5)]
    live = {}  # seq -> [tokens, reserved, drawn, written]
    nxt = 0
    for _ in range(240):
        op = rng.choice(["admit", "write", "free", "flush", "promote"],
                        p=[0.25, 0.4, 0.2, 0.05, 0.1])
        if op == "admit":
            stem = stems[rng.integers(len(stems))]
            # a whole stem (a full-chain hit once it is cached) or a
            # stem with a suffix of its own
            tokens = stem[:4 * rng.integers(1, 3)] + rng.integers(
                1, 50, max(0, rng.integers(-4, 6))).tolist()
            hits = jc.peek_prefix(tokens)
            assert tc.peek_prefix(tokens) == hits
            # the engine's sizing: one block more for a full-chain hit
            need = jc.cfg.blocks_for(len(tokens) + 4) + (
                hits * 4 >= len(tokens))
            ok = jc.can_reserve(need)
            assert tc.can_reserve(need) == ok
            if ok:
                for c in (jc, tc):
                    c.reserve(need)
                    c.allocate(nxt)
                got = [c.assign_prefix(nxt, tokens, max_blocks=hits)
                       for c in (jc, tc)]
                assert got[0] == got[1]
                live[nxt] = [tokens, need, got[0] // 4,
                             min(got[0], len(tokens) - 1)]
                nxt += 1
        elif op == "write" and live:
            seq = list(live)[rng.integers(len(live))]
            tokens, need, drawn, done = live[seq]
            end = min(done + int(rng.integers(1, 7)), len(tokens) + 4)
            if end > done:
                got = []
                for c in (jc, tc):
                    appended = c.ensure_capacity(seq, end)
                    pairs = c.prepare_write(seq, done, end)
                    reg = c.register_prefix(seq, tokens, end)
                    got.append((appended, pairs, reg))
                assert got[0] == got[1]
                live[seq][2] += got[0][0] + len(got[0][1])
                live[seq][3] = end
        elif op == "free" and live:
            seq = list(live)[rng.integers(len(live))]
            _, need, drawn, _ = live.pop(seq)
            quarantine = bool(rng.integers(2))
            for c in (jc, tc):
                assert c.free(seq, quarantine=quarantine) >= 0
                if need > drawn:
                    c.release_reservation(need - drawn)
        elif op == "flush":
            assert jc.flush_quarantine() == tc.flush_quarantine()
        elif op == "promote":
            want = jc.take_pending_promotions()
            got = tc.take_pending_promotions()
            assert [b for b, _, _ in got] == [b for b, _, _ in want]
            for (_, jk, jv), (_, tk, tv) in zip(want, got):
                assert np.array_equal(np.asarray(jk), tk)
                assert np.array_equal(np.asarray(jv), tv)
            for c, staged in ((jc, want), (tc, got)):
                c.promotions_landed([b for b, _, _ in staged])
        assert _state(tc) == _state(jc)
    s = tc.stats  # the sequence reached every path it is meant to
    assert min(s.prefix_hit_blocks, s.cow_copies,
               s.prefix_evicted_blocks) > 0
    if tier:
        assert min(s.demoted_blocks, s.promoted_blocks) > 0
    assert jc.release_all() == tc.release_all()
    assert _state(tc) == _state(jc)
    assert tc.available_blocks == tc.cfg.usable_blocks


# ------------------------------------------------------ engine vs JAX

@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_full_chain_hit_copy_on_write_divergence(models, family):
    """A prompt resident whole (64 tokens, 8 full blocks): two concurrent
    sampled hits recompute the last token through copy-on-write copies of
    the SAME shared tail block and diverge; the shared prefix then serves
    a greedy hit unchanged. Streams and counters equal the JAX engine's,
    and the streams equal a caching-off engine's."""
    prompt = shared_prefix(64)

    def workload(eng):
        out = [eng.generate(prompt, max_new_tokens=6)]
        s1 = eng.submit(prompt, max_new_tokens=6, temperature=0.8, seed=1)
        s2 = eng.submit(prompt, max_new_tokens=6, temperature=0.8, seed=2)
        out += drain(eng, [s1, s2])
        out.append(eng.generate(prompt, max_new_tokens=6))
        return out

    pe, got = both(models, family, workload)
    assert got[1] != got[2]  # genuinely divergent continuations
    assert got[0] == got[3]
    st = pe.stats()
    assert st["cow_blocks"] == 3 and st["prefix_hit_blocks"] == 3 * 8
    assert st["prefill_tokens_total"] == 64 + 3
    assert pool_is_clean(pe)
    cold = port_engine(models, family, prefix_caching=False)
    assert workload(cold) == got


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_chunked_prefill_starts_at_first_miss(models, family):
    """With the prefix resident, a chunked engine computes only the tail
    past the last full hit block, on the chunk path at its true start."""
    prefix = shared_prefix(64)

    def workload(eng):
        cold = eng.generate(prefix + [1, 2, 3], max_new_tokens=4)
        before = eng.stats()["prefill_tokens_total"]
        warm = eng.generate(prefix + [1, 2, 4], max_new_tokens=4)
        return [cold, warm, [eng.stats()["prefill_tokens_total"] - before]]

    pe, got = both(models, family, workload, prefill_chunk_tokens=16)
    assert got[2] == [3]
    assert "prefill_chunk" in {s[0] for s in pe.fns.signatures}
    ref = port_engine(models, family, prefix_caching=False,
                      prefill_chunk_tokens=16)
    assert got[:2] == [ref.generate(prefix + [1, 2, 3], max_new_tokens=4),
                       ref.generate(prefix + [1, 2, 4], max_new_tokens=4)]


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_lru_eviction_when_free_list_runs_dry(models, family):
    """Distinct prompts park their blocks in the LRU set until the free
    list runs dry; new allocations then evict the oldest, and a
    just-registered prefix (the MRU end) still hits."""
    def workload(eng):
        out = [eng.generate([i + 1] * 16, max_new_tokens=4)
               for i in range(12)]
        out.append(eng.generate([12] * 16 + [99], max_new_tokens=4))
        return out

    pe, _ = both(models, family, workload, num_blocks=17)
    st = pe.stats()
    assert st["prefix_evicted_blocks"] > 0 and st["prefix_hit_tokens"] == 16
    assert pool_is_clean(pe)


def test_cancel_and_release_all_with_shared_blocks(models):
    """Cancelling one of two requests that share cached blocks returns
    exactly its own blocks and leftover reservation; ``release_all``
    also drops the content-addressed set."""
    from ray_tpu.serve.llm import RequestCancelledError as JaxCancelled

    from ray_tpu_torch.serve.llm import RequestCancelledError

    cancelled = (RequestCancelledError, JaxCancelled)
    prefix = shared_prefix(32)

    def workload(eng):
        first = eng.generate(prefix + [1], max_new_tokens=2)
        a = eng.submit(prefix + [2], max_new_tokens=30)
        b = eng.submit(prefix + [3], max_new_tokens=30)
        eng.step()  # both prefilled, the prefix mapped from the cache
        hits = eng.stats()["prefix_hit_tokens"]
        assert eng.cancel(a.request_id)
        with pytest.raises(cancelled):
            list(a)
        used = eng.cache.used_blocks  # b still holds the shared prefix
        out = drain(eng, [b])
        return [first, *out, [hits, used]]

    pe, got = both(models, "llama", workload)
    assert got[2][0] == 2 * 32 and got[2][1] > 0 and len(got[1]) == 30
    assert pool_is_clean(pe)
    assert pe.cache.cached_blocks > 0
    assert pe.cache.release_all() == 0
    assert pe.cache.free_blocks == pe.cache.cfg.usable_blocks
    assert pe.cache.cached_blocks == 0
    pe.shutdown()
    assert pe.cache.free_blocks == pe.cache.cfg.usable_blocks


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_shared_prefix_waves_match_jax(models, family):
    """Two waves of six prompts that share a 40-token prefix (one
    sampled, joining at once): the second wave's prompts are hits, some
    of them whole; streams and counters equal the JAX engine's after
    each wave."""
    prefix = shared_prefix(40, seed=7)
    rng = np.random.default_rng(8)
    prompts = [prefix + rng.integers(1, 250, n).tolist()
               for n in (3, 8, 11, 16, 24, 0)]

    def wave(eng):
        streams = [eng.submit(p, max_new_tokens=8,
                              **({"temperature": 0.8, "top_p": 0.9,
                                  "seed": 3} if i == 1 else {}))
                   for i, p in enumerate(prompts)]
        return drain(eng, streams)

    def workload(eng):
        first = wave(eng)
        mid = prefix_stats(eng)
        return [first, wave(eng), mid]

    pe, got = both(models, family, workload, max_batch_size=4,
                   prefill_chunk_tokens=32)
    assert got[0] == got[1]
    st = pe.stats()
    assert st["prefix_hit_tokens"] > got[2]["prefix_hit_tokens"]
    assert pool_is_clean(pe)


def test_promotion_and_copy_on_write_under_an_in_flight_decode_step(models):
    """A request that is a full-chain hit on blocks demoted to the host
    tier joins while another row's lag-1 decode step is in flight: the
    promotion lands and the tail block is copied in the prefill window
    with that step still unsynced, and every stream equals the
    tier-off engine's and the JAX engine's."""
    prompt = shared_prefix(32)

    def workload(eng):
        first = eng.generate(prompt, max_new_tokens=4)
        for i in range(8):  # churn: the prompt's blocks are evicted
            eng.generate([100 + i] * 17, max_new_tokens=4)
        long = eng.submit([7] * 9, max_new_tokens=12)
        for _ in range(4):
            eng.step()
        inflight = eng.stats()["decode_inflight"]
        before = prefix_stats(eng)
        hit = eng.submit(prompt, max_new_tokens=4, temperature=0.9,
                         top_p=0.8, seed=5)
        eng.step()  # admission promotes; the prefill window lands + copies
        after = prefix_stats(eng)
        moved = [after[k] - before[k] for k in ("kv_promoted_blocks",
                                                "cow_blocks")]
        return [first, *drain(eng, [long, hit]), [inflight, *moved]]

    pe, got = both(models, "llama", workload, num_blocks=17,
                   host_cache_bytes=1 << 22)
    assert got[3] == [1, 4, 1]
    assert pool_is_clean(pe) and not pe.cache._unlanded
    ref = port_engine(models, "llama", num_blocks=17)
    assert workload(ref)[:3] == got[:3]


@pytest.mark.parametrize("exporter", ["port", "jax"])
def test_export_prefix_adopted_across_packages(models, exporter):
    """``export_prefix`` of one package's engine, adopted by the other's:
    the adopting engine's next run of the prompt is a full prefix hit and
    gives its local-prefill stream."""
    prompt = shared_prefix(48)
    src, dst = ((port_engine, jax_engine) if exporter == "port"
                else (jax_engine, port_engine))
    a = src(models, "llama")
    a.generate(prompt + [5], max_new_tokens=1)
    records = a.export_prefix(prompt + [5])
    assert len(records) == 6
    local = dst(models, "llama").generate(prompt + [5], max_new_tokens=6)
    b = dst(models, "llama")
    assert b.adopt_prefix(prompt + [5], records) == 6
    assert b.adopt_prefix(prompt + [5], records) == 6  # idempotent
    assert b.generate(prompt + [5], max_new_tokens=6) == local
    assert b.stats()["prefix_hit_tokens"] == 48
    # a record of other tokens is refused at the first mismatch
    other = dst(models, "llama")
    assert other.adopt_prefix([1] + prompt[1:] + [5], records) == 0
