"""The port's host KV tier and its RTKV records against the JAX
package's, on the CPU: records byte-identical to the JAX package's
``pack_blocks`` for f32, bf16, int8 and fp8 payloads (exported from a
pool through the executor, head dim 100 on a padded pool included, and
read back by both packages), ``HostKVTier``'s LRU eviction by bytes, a
corrupt arena entry dropped to recompute, and the engine's demote and
promote (tiny GPT and Llama, f32; the scenarios of
``tests/test_kv_host_tier.py``): streams and ``stats()`` counters equal
to the JAX engine's with the tier on, each demoted block promoted once,
a copy-on-write fork of a promoted block, and cancel with ``release_all``
on promoted blocks."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_prefix import (
    both,
    drain,
    models,  # noqa: F401 — the module fixture
    pool_is_clean,
    port_engine,
    shared_prefix,
)

PREFIX_TOKENS, PREFIX_BLOCKS = 32, 4  # block_size 8
TIER = 1 << 22


@pytest.fixture(autouse=True)
def _cpu(jax_cpu):
    return jax_cpu


def churn(eng, n=8, base=100):
    """Distinct prompts that run a 16-block pool dry: the cached prefix
    is evicted, and with the tier on, demoted."""
    for i in range(n):
        eng.generate([base + i] * 17, max_new_tokens=4)


# --------------------------------------------------------- RTKV records

def _pool_engine(dtype, kind, hd):
    """A one-layer GPT engine whose pool has head dim ``hd`` (the pool
    padded to ``pool_head_dim``), ``dtype`` and ``kind``."""
    from ray_tpu_torch.models.gpt import GPTConfig
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    cfg = dataclasses.replace(GPTConfig.tiny(), n_layer=1, n_head=2,
                              d_model=2 * hd, d_mlp=64, dtype=dtype)
    return LLMEngine(EngineConfig(model="gpt", model_config=cfg,
                                  device="cpu", num_blocks=8, block_size=4,
                                  quantization=kind), auto_step=False)


def _payloads(rng, shape, dtype, kind):
    """(port payload, JAX payload) of one side from the same values: bf16
    as uint16 bytes here and as ml_dtypes there; quantized data with
    positive f32 scales."""
    import ml_dtypes

    x = rng.standard_normal(shape).astype(np.float32) * 3
    if kind is None and dtype == torch.float32:
        return x, x.copy()
    if kind is None:
        port = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16)
        return port.numpy().view(np.uint16), x.astype(ml_dtypes.bfloat16)
    from ray_tpu.ops.quantization import QuantizedKV as JaxQKV

    from ray_tpu_torch.ops.quantization import QuantizedKV

    scale = rng.uniform(0.01, 2.0, shape[:-1]).astype(np.float32)
    if kind == "int8":
        data = rng.integers(-127, 128, shape).astype(np.int8)
        return QuantizedKV(data, scale), JaxQKV(data.copy(), scale.copy())
    port = torch.from_numpy(x).to(torch.float8_e4m3fn).view(torch.uint8)
    return (QuantizedKV(port.numpy(), scale),
            JaxQKV(x.astype(ml_dtypes.float8_e4m3fn), scale.copy()))


def _bytes(side):
    parts = [side.data, side.scale] if hasattr(side, "scale") else [side]
    return b"".join(np.ascontiguousarray(p).tobytes() for p in parts)


@pytest.mark.parametrize("dtype,kind,hd", [
    (torch.float32, None, 16), (torch.bfloat16, None, 16),
    (torch.float32, "int8", 16), (torch.float32, "fp8", 16),
    (torch.bfloat16, None, 100), (torch.float32, "int8", 100),
], ids=["f32", "bf16", "int8", "fp8", "bf16-hd100", "int8-hd100"])
def test_rtkv_records_byte_identical_to_jax(dtype, kind, hd):
    """Payloads landed in a pool (``executor.land_blocks``) and exported
    again (``export_blocks``, the demote capture) pack into the JAX
    package's bytes; both packages unpack either wire to the same
    payload bytes; the pool's padding columns stay zero."""
    from ray_tpu.serve.llm import kv_transfer as jkt

    from ray_tpu_torch.serve.llm import kv_transfer as tkt
    from ray_tpu_torch.serve.llm.kv_cache import _block_key

    eng = _pool_engine(dtype, kind, hd)
    cache, ex = eng.cache, eng.executor
    layout = cache.layout
    jlayout = jkt.KVLayout(
        n_layer=1, block_size=4, n_kv_head=2, head_dim=hd,
        dtype={torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
        if kind is None else {"int8": "int8", "fp8": "float8_e4m3fn"}[kind],
        quantization=kind)
    assert dataclasses.asdict(layout) == dataclasses.asdict(jlayout)
    rng = np.random.default_rng(hd)
    shape = (1, 3, 4, 2, hd)
    (tk, jk), (tv, jv) = (_payloads(rng, shape, dtype, kind)
                          for _ in range(2))
    ids = [5, 2, 6]
    ex.land_blocks(ids, tk, tv)
    k, v = ex.export_blocks(ids)
    assert _bytes(k) == _bytes(tk) and _bytes(v) == _bytes(tv)
    pool = cache.k.data if kind else cache.k
    assert not pool[..., hd:].view(torch.uint8).any()  # padding stays zero
    digests = [_block_key(b"", [i] * 4) for i in range(3)]
    wire = tkt.pack_blocks(layout, [(d, k[:, i], v[:, i])
                                    for i, d in enumerate(digests)],
                           prefix_tokens=12)
    jwire = jkt.pack_blocks(jlayout, [(d, jk[:, i], jv[:, i])
                                      for i, d in enumerate(digests)],
                            prefix_tokens=12)
    assert wire == jwire
    got_layout, ntok, recs = tkt.unpack_blocks(jwire, expect=layout)
    assert got_layout == layout and ntok == 12
    _, _, jrecs = jkt.unpack_blocks(wire, expect=jlayout)
    for (d, rk, rv), (jd, jrk, jrv), i in zip(recs, jrecs, range(3)):
        assert d == jd == digests[i]
        assert _bytes(rk) == _bytes(jrk) == _bytes(k[:, i])
        assert _bytes(rv) == _bytes(jrv) == _bytes(v[:, i])
    with pytest.raises(tkt.KVTransferError, match="head_dim"):
        tkt.unpack_blocks(wire, expect=dataclasses.replace(layout,
                                                           head_dim=hd + 8))
    flipped = bytearray(wire)
    flipped[-1] ^= 0xFF
    with pytest.raises(tkt.KVTransferError, match="content digest"):
        tkt.unpack_blocks(bytes(flipped))


def _tier_pair():
    from ray_tpu.serve.llm.kv_cache import HostKVTier as JaxTier
    from ray_tpu.serve.llm.kv_transfer import KVLayout as JaxLayout

    from ray_tpu_torch.serve.llm.kv_cache import HostKVTier
    from ray_tpu_torch.serve.llm.kv_transfer import KVLayout

    geo = dict(n_layer=1, block_size=2, n_kv_head=1, head_dim=2,
               dtype="float32")
    probe = HostKVTier(1 << 20, KVLayout(**geo))
    probe.put(b"\0" * 16, *_tier_block(0))
    two = 2 * probe.nbytes  # room for exactly two records
    return (HostKVTier(two, KVLayout(**geo)), JaxTier(two, JaxLayout(**geo)),
            probe.nbytes)


def _tier_block(fill):
    k = np.full((1, 2, 1, 2), float(fill), np.float32)
    return k, -k


def test_host_tier_lru_eviction_by_bytes_matches_jax():
    """Puts beyond the byte cap evict the least recently used record, a
    ``get`` refreshes recency, a resident digest is refreshed and not
    packed again, and a record larger than the cap is refused: return
    values, order and bytes as the JAX package's tier."""
    from ray_tpu_torch.serve.llm.kv_cache import HostKVTier

    tier, jtier, one = _tier_pair()
    d = [bytes([i]) * 16 for i in range(4)]
    script = [("put", 0, 10), ("put", 1, 11), ("put", 2, 12), ("get", 1),
              ("put", 3, 13), ("put", 1, 99), ("get", 1)]
    for t in (tier, jtier):
        out = []
        for op, i, *fill in script:
            if op == "put":
                out.append(t.put(d[i], *_tier_block(fill[0])))
            else:
                k, v = t.get(d[i])
                out.append((float(k.flat[0]), float(v.flat[0])))
        t.result = (out, list(t.digests()), t.nbytes, t.blocks,
                    dict(t._wire))
    assert tier.result == jtier.result
    out, digests, nbytes, blocks, _ = tier.result
    assert out[2] == (True, 1) and out[4] == (True, 1)
    assert digests == [d[1], d[3]] and blocks == 2 and nbytes == 2 * one
    assert out[5] == (True, 0) and out[6] == (11.0, -11.0)
    small = HostKVTier(one - 1, tier.layout)
    assert small.put(d[0], *_tier_block(1)) == (False, 0)
    assert small.blocks == 0 and small.nbytes == 0


def test_corrupt_host_entry_drops_to_recompute_as_jax():
    """A payload byte flipped in the arena fails verification at
    promote time: the entry is dropped and counted, the chain walk
    stops there, and nothing of it is staged to land; as the JAX
    cache."""
    from test_torch_prefix import _caches, _state

    tokens = list(range(1, 9))
    results = []
    for cache in _caches(tier=True):
        cache.reserve(2)
        cache.allocate("warm")
        cache.ensure_capacity("warm", 8)
        cache.register_prefix("warm", tokens, 8)
        cache.free("warm")
        cache.reserve(11)
        cache.allocate("churn")
        cache.ensure_capacity("churn", 44)  # evicts and demotes both
        cache.free("churn")
        first = next(iter(cache.host_tier._wire))
        wire = bytearray(cache.host_tier._wire[first])
        wire[-1] ^= 0xFF
        cache.host_tier._wire[first] = bytes(wire)
        peek = cache.peek_prefix(tokens)  # a pure lookup: no verification
        cache.reserve(2)
        cache.allocate("c")
        hit = cache.assign_prefix("c", tokens)
        staged = cache.take_pending_promotions()
        results.append((peek, hit, len(staged), first in cache.host_tier,
                        cache.stats.host_corrupt_drops, _state(cache)))
    assert results[0] == results[1]
    peek, hit, staged, resident, drops, _ = results[1]
    # the first record demoted is the chain's second block (the LRU frees
    # a table newest first): the walk keeps the first block and stops
    assert (peek, hit, staged, resident, drops) == (2, 4, 1, False, 1)


def test_demote_chain_matches_jax():
    """``demote_chain`` backs a registered chain into the tier with ONE
    export of the blocks not yet there; a second call exports nothing;
    an eviction of a backed block refreshes its entry instead of
    exporting it again: the same calls, returns and state as the JAX
    cache."""
    from test_torch_prefix import _caches, _state

    tokens = list(range(1, 11))  # 2 full blocks and a partial one
    results = []
    for cache in _caches(tier=True):
        exports = []
        demote_fn = cache.demote_fn
        cache.demote_fn = (lambda ids, f=demote_fn:
                           exports.append(list(ids)) or f(ids))
        cache.reserve(3)
        cache.allocate("a")
        cache.ensure_capacity("a", 10)
        cache.register_prefix("a", tokens, 10)
        steps = [cache.demote_chain(tokens, 10), list(exports),
                 cache.demote_chain(tokens, 10), cache.demote_chain([9] * 8,
                                                                    8)]
        cache.free("a")
        cache.reserve(11)
        cache.allocate("b")
        cache.ensure_capacity("b", 44)  # evicts both backed blocks
        steps += [list(exports), _state(cache)]
        results.append(steps)
    assert results[0] == results[1]
    got = results[1]
    assert got[0] == 2 and len(got[1]) == 1 and got[2:4] == [0, 0]
    assert got[4] == got[1]  # evictions of backed blocks export nothing
    assert got[5]["stats"]["demoted_blocks"] == 2


# -------------------------------------------------- engine vs JAX engine

@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_demote_promote_exactly_once_matches_jax(models, family):  # noqa: F811
    """Churn demotes the shared prefix; the re-hit promotes each block
    exactly once (a second request hits them on the device). Streams,
    greedy and sampled, equal the JAX engine's and the tier-off engine's;
    every demote capture is a sync of kind ``demote``."""
    prefix = shared_prefix(PREFIX_TOKENS)

    def workload(eng):
        out = [eng.generate(prefix + [1, 2, 3], max_new_tokens=4)]
        churn(eng)
        out.append(eng.generate(prefix + [9, 9, 9], max_new_tokens=4))
        out.append(eng.generate(prefix + [9, 9, 8], max_new_tokens=4,
                                temperature=0.9, top_p=0.8, seed=5))
        return out

    pe, got = both(models, family, workload, num_blocks=17,
                   host_cache_bytes=TIER)
    st = pe.stats()
    assert st["kv_demoted_blocks"] >= PREFIX_BLOCKS
    assert st["kv_promoted_blocks"] == PREFIX_BLOCKS
    assert st["prefix_hit_tokens"] == 2 * PREFIX_TOKENS
    demotes = [r for r in pe.debug_dump()["steps"] if r["kind"] == "demote"]
    record = pe.cache.layout.record_payload_bytes
    assert demotes and all(r["sync_bytes"] == r["batch"] * record
                           for r in demotes)
    assert pool_is_clean(pe) and not pe.cache._unlanded
    assert workload(port_engine(models, family, num_blocks=17)) == got


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantized_demote_promote_matches_jax(models, kind):  # noqa: F811
    """The same churn on a quantized pool: records carry the data and
    scale planes (RTKV v2), and the promoted blocks' bytes give the JAX
    engine's streams and counters."""
    prefix = shared_prefix(PREFIX_TOKENS)

    def workload(eng):
        out = [eng.generate(prefix + [1, 2, 3], max_new_tokens=4)]
        churn(eng)
        out.append(eng.generate(prefix + [9, 9, 9], max_new_tokens=4))
        return out

    pe, _ = both(models, "llama", workload, num_blocks=17,
                 host_cache_bytes=TIER, quantization=kind)
    assert pe.stats()["kv_promoted_blocks"] == PREFIX_BLOCKS
    assert pe.cache.layout.quantization == kind


def test_cow_fork_of_promoted_block_diverges(models):  # noqa: F811
    """A prompt resident whole in the host tier: two concurrent requests
    promote and share its blocks, then diverge through copy-on-write
    copies of the promoted tail block (the landing precedes the copy),
    with the streams of the tier-off engine and the JAX engine."""
    prompt = shared_prefix(64)

    def workload(eng):
        out = [eng.generate(prompt, max_new_tokens=6)]
        churn(eng, base=200)
        s1 = eng.submit(prompt, max_new_tokens=6, temperature=0.8, seed=1)
        s2 = eng.submit(prompt, max_new_tokens=6, temperature=0.8, seed=2)
        return out + drain(eng, [s1, s2])

    pe, got = both(models, "llama", workload, num_blocks=17,
                   host_cache_bytes=TIER)
    assert got[1] != got[2]
    st = pe.stats()
    assert st["kv_promoted_blocks"] == 8 and st["cow_blocks"] == 2
    assert pool_is_clean(pe)
    assert workload(port_engine(models, "llama", num_blocks=17)) == got


def test_cancel_and_release_all_with_promoted_blocks(models):  # noqa: F811
    """Cancelling one of two requests that share promoted blocks leaks
    nothing; ``release_all`` clears the promotion queue, the unlanded
    set and the arena."""
    prefix = shared_prefix(PREFIX_TOKENS)

    def workload(eng):
        first = eng.generate(prefix + [1], max_new_tokens=2)
        churn(eng)
        a = eng.submit(prefix + [2], max_new_tokens=20)
        b = eng.submit(prefix + [3], max_new_tokens=20)
        eng.step()  # a promotes, b shares the same blocks
        promoted = eng.stats()["kv_promoted_blocks"]
        assert eng.cancel(a.request_id)
        used = eng.cache.used_blocks
        return [first, *drain(eng, [b]), [promoted, used]]

    pe, got = both(models, "llama", workload, num_blocks=17,
                   host_cache_bytes=TIER)
    assert got[2][0] == PREFIX_BLOCKS and got[2][1] > 0
    assert len(got[1]) == 20
    assert pool_is_clean(pe) and not pe.cache._unlanded
    assert pe.cache.host_tier.blocks > 0
    pe.cache.release_all()
    assert pe.cache.host_tier.blocks == 0 and pe.cache.host_tier.nbytes == 0
    assert not pe.cache._pending_promotions and not pe.cache._unlanded
    assert pe.cache.free_blocks == pe.cache.cfg.usable_blocks


def test_unlanded_promotion_evicted_before_landing_is_dropped():
    """A block claimed for promotion whose payload has not landed holds
    garbage bytes: when its sequence is cancelled and the block evicted,
    nothing is exported, the stale landing is dropped at the drain, and
    the arena entry survives, so a later request promotes it again; the
    same calls, returns and state as the JAX cache."""
    from test_torch_prefix import _caches, _state

    tokens = list(range(1, 9))
    results = []
    for cache in _caches(tier=True):
        exports = []
        demote_fn = cache.demote_fn
        cache.demote_fn = (lambda ids, f=demote_fn:
                           exports.append(ids) or f(ids))
        steps = []

        def take(seq, n):
            cache.reserve(n)
            cache.allocate(seq)
            return cache.ensure_capacity(seq, 4 * n)

        take("warm", 2)
        cache.register_prefix("warm", tokens, 8)
        cache.free("warm")
        take("churn", 11)  # evicts and demotes both prefix blocks
        cache.free("churn")
        cache.reserve(2)
        cache.allocate("c")
        steps.append(cache.assign_prefix("c", tokens))  # promotes both
        cache.free("c")  # cancelled before the engine landed them
        n_exports = len(exports)
        take("d", 11)  # evicts the unlanded blocks
        steps += [len(exports) - n_exports, sorted(cache._unlanded),
                  cache.take_pending_promotions(), _state(cache)]
        cache.free("d")
        cache.reserve(2)
        cache.allocate("e")
        steps.append(cache.assign_prefix("e", tokens))
        staged = cache.take_pending_promotions()
        cache.promotions_landed([b for b, _, _ in staged])
        steps += [[(b, np.asarray(k).tolist()) for b, k, _ in staged],
                  _state(cache)]
        results.append(steps)
    assert results[0] == results[1]
    got = results[1]
    assert got[0] == 8 and got[1:4] == [0, [], []]
    stats = got[4]["stats"]
    assert stats["promotion_drops"] == 2 and stats["demote_drops"] == 0
    assert got[5] == 8 and len(got[6]) == 2
    assert got[7]["stats"]["promoted_blocks"] == 4
