"""Speculative decoding in the port (``ray_tpu_torch``) against the JAX
package on the CPU: the n-gram drafter's proposals, ``verify_tokens`` on
seeded logits and masks, each family's ``verify_step`` (window logits and
written K/V within 1e-5 of JAX's, f32; packed verdicts equal), and the
engine with ``speculative_k = 4``: streams equal the JAX engine's and the
port's own spec-off streams (greedy and nucleus, GPT and Llama), the
budget is exact, a garbage drafter stays lossless, EOS inside an accepted
window ends the stream there with every block back once, and the
``stats()`` speculation keys equal the JAX engine's.

Tiny f32 configs whose weights are the JAX init at ``PRNGKey(0)`` (the
JAX engine's own default weights) carried across by ``convert.py``; one
batch and one length bucket keep the JAX side to few programs. Both
engines admit with their default skip-ahead (``admission_probe=4``)."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

# a motif the tiny f32 Llama greedily continues (the JAX suite's MOTIF), so
# the drafter's windows are accepted and several tokens commit a step
MOTIF = [435, 326, 262, 138, 158, 21, 39, 9]
BUCKETS = dict(block_size=8, num_blocks=64, batch_buckets=(4,),
               length_buckets=(64,))
SAMPLINGS = [dict(), dict(temperature=0.8, top_p=0.9, seed=7)]
SPEC_KEYS = ("spec_steps", "spec_drafted_tokens", "spec_accepted_tokens",
             "spec_committed_tokens", "spec_accept_rate",
             "spec_committed_per_step")
LOGIT_TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu(jax_cpu):
    return jax_cpu


def _configs(fam):
    import jax.numpy as jnp

    if fam == "gpt":
        from ray_tpu.models.gpt import GPTConfig as J

        from ray_tpu_torch.models.gpt import GPTConfig as T
    else:
        from ray_tpu.models.llama import LlamaConfig as J

        from ray_tpu_torch.models.llama import LlamaConfig as T
    jcfg = dataclasses.replace(J.tiny(), dtype=jnp.float32, attention="xla")
    tcfg = dataclasses.replace(T.tiny(), dtype=torch.float32)
    return jcfg, tcfg


_WEIGHTS: dict = {}


def _weights(fam):
    """(jcfg, tcfg, numpy tree, the port's state dict), the JAX init at
    PRNGKey(0), made once per family."""
    if fam not in _WEIGHTS:
        import jax

        from ray_tpu_torch import convert

        jcfg, tcfg = _configs(fam)
        if fam == "gpt":
            from ray_tpu.models.gpt import gpt_init as init
            to_port = convert.gpt_params_from_numpy
        else:
            from ray_tpu.models.llama import llama_init as init
            to_port = convert.llama_params_from_numpy
        tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), jcfg))
        _WEIGHTS[fam] = (jcfg, tcfg, tree, to_port(tree, tcfg))
    return _WEIGHTS[fam]


def _jax_engine(fam, **kw):
    import jax
    import jax.numpy as jnp
    from ray_tpu.serve.llm import EngineConfig, LLMEngine

    jcfg, _, tree, _ = _weights(fam)
    kw = {**BUCKETS, **kw}
    return LLMEngine(EngineConfig(model=fam, model_config=jcfg,
                                  prefix_caching=False,
                                  attention_backend="xla", **kw),
                     params=jax.tree.map(jnp.asarray, tree), auto_step=False)


def _port_engine(fam, **kw):
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    _, tcfg, _, state = _weights(fam)
    kw = {**BUCKETS, **kw}
    return LLMEngine(EngineConfig(model=fam, model_config=tcfg, device="cpu",
                                  prefix_caching=False, **kw),
                     params=state, auto_step=False)


def _run(engine, requests):
    """Submit every (prompt, sampling overrides) at once, step until idle."""
    streams = [engine.submit(p, **kw) for p, kw in requests]
    while engine.step():
        pass
    return [list(s) for s in streams]


def _assert_pool_whole(eng):
    snap = eng.cache.debug_snapshot()
    assert snap["used_blocks"] == 0, snap
    assert snap["quarantined_blocks"] == 0, snap
    assert snap["reserved_blocks"] == 0, snap
    assert snap["live_sequences"] == 0, snap
    assert snap["freed_total"] == snap["allocated_total"], snap


# ---------------------------------------------------------------- drafter

@pytest.mark.parametrize("case", range(6))
def test_ngram_drafter_equals_jax(case):
    """The drafter's proposals equal the JAX drafter's on motif, random
    and degenerate contexts, for every k and n-gram range."""
    from ray_tpu.serve.llm.drafter import NGramDrafter as J

    from ray_tpu_torch.serve.llm.drafter import NGramDrafter as T

    rng = np.random.default_rng(case)
    contexts = [
        (MOTIF * 3, []), (MOTIF * 2, MOTIF[:3]), ([5], []), ([], [7, 7]),
        (rng.integers(0, 6, 40).tolist(), rng.integers(0, 6, 9).tolist()),
        (rng.integers(0, 512, 30).tolist(), []),
    ]
    prompt, generated = contexts[case]
    for max_n, min_n in ((4, 1), (2, 2), (3, 1)):
        for k in (0, 1, 3, 4, 8):
            assert (T(max_n, min_n).propose(prompt, generated, k)
                    == J(max_n, min_n).propose(prompt, generated, k))


def test_build_drafter_matches_jax():
    from ray_tpu.serve.llm.drafter import build_drafter as jbuild

    from ray_tpu_torch.serve.llm.drafter import NGramDrafter, build_drafter

    assert build_drafter(None) is None and jbuild(None) is None
    assert isinstance(build_drafter("ngram"), NGramDrafter)
    for bad, err in (("lookahead", ValueError), (object(), TypeError)):
        with pytest.raises(err) as mine:
            build_drafter(bad)
        with pytest.raises(err) as ref:
            jbuild(bad)
        if err is ValueError:
            assert str(mine.value) == str(ref.value)
    with pytest.raises(ValueError, match="min_n"):
        NGramDrafter(max_n=1, min_n=2)


# ---------------------------------------------------------- verify_tokens

def _mask(rng, shape, words, V):
    """Random allow-masks over V tokens, some rows all-ones and one that
    allows nothing (left unmasked by both)."""
    m = rng.integers(0, 2**32, shape + (words,), dtype=np.uint64)
    m = m.astype(np.uint32)
    flat = m.reshape(-1, words)
    flat[0] = 0xFFFFFFFF
    flat[1] = 0
    return m


@pytest.mark.parametrize("mode", ["greedy", "mixed", "masked"])
def test_verify_tokens_equals_jax(mode):
    """Packed verdicts equal JAX's on the same seeded logits: the port's
    draws are staged at starts + 1 + s (``keyed_uniform``), its [B] controls
    tiled across the window, the [B, W, words] mask flattened row-major."""
    import jax.numpy as jnp
    from ray_tpu.ops.sampling import verify_tokens as jverify

    from ray_tpu_torch.ops.sampling import keyed_uniform, verify_tokens

    rng = np.random.default_rng(3)
    B, W, V = 5, 5, 300
    words = (V + 31) // 32
    logits = rng.normal(size=(B, W, V)).astype(np.float32) * 3
    starts = rng.integers(0, 90, B).astype(np.int32)
    tgt = logits.argmax(-1)
    draft = rng.integers(0, V, (B, W)).astype(np.int32)
    # rows that agree with the greedy targets for a while, so acceptance
    # runs of several lengths occur
    for b, run in enumerate((4, 2, 0, 3, 1)):
        draft[b, 1:1 + run] = tgt[b, :run]
    dlen = np.array([4, 4, 2, 0, 3], np.int32)
    sampled = mode != "greedy"
    temp = np.where(np.arange(B) % 2 == 0, 0.0, 0.9).astype(np.float32) \
        if sampled else np.zeros(B, np.float32)
    top_k = np.array([0, 20, 0, -1, 1], np.int32)
    top_p = np.array([1.0, 0.9, 0.5, 1.0, 0.8], np.float32)
    seeds = np.array([1, 2, 3, 2**31 + 5, 7], np.uint32)
    jsample = {"seeds": jnp.asarray(seeds), "temperature": jnp.asarray(temp),
               "top_k": jnp.asarray(top_k), "top_p": jnp.asarray(top_p)}
    pos = starts[:, None] + 1 + np.arange(W)
    uniform = keyed_uniform(np.repeat(seeds, W), pos.reshape(-1))
    tsample = {"all_greedy": not sampled,
               "temperature": torch.from_numpy(temp),
               "top_k": torch.from_numpy(top_k),
               "top_p": torch.from_numpy(top_p),
               "uniform": uniform.reshape(B, W)}
    if mode == "masked":
        mask = _mask(rng, (B, W), words, V)
        jsample["mask"] = jnp.asarray(mask)
        tsample["mask"] = torch.from_numpy(mask.view(np.int32))
    want = np.asarray(jverify(jnp.asarray(logits), jnp.asarray(starts),
                              jnp.asarray(draft), jnp.asarray(dlen), jsample))
    got = verify_tokens(torch.from_numpy(logits), torch.from_numpy(starts),
                        torch.from_numpy(draft), torch.from_numpy(dlen),
                        tsample)
    assert got.dtype == torch.int32 and got.shape == (B, W + 1)
    np.testing.assert_array_equal(got.numpy(), want)
    if mode == "greedy":
        np.testing.assert_array_equal(want[:, 0], [5, 3, 1, 1, 2])


# ------------------------------------------------------------ verify_step

@pytest.mark.parametrize("fam", ["gpt", "llama"])
def test_verify_step_equals_jax(fam):
    """A [B, 5] verify window after a ragged prefill, windows starting mid
    block, draft lengths 0-4 and a padding row: the window logits at every
    column and the written K/V within 1e-5 of the JAX verify step's, and
    the sampled packed verdicts equal."""
    import jax.numpy as jnp

    from ray_tpu_torch.models.families import family
    from ray_tpu_torch.ops.sampling import keyed_uniform

    if fam == "gpt":
        from ray_tpu.models.gpt import gpt_prefill as jprefill
        from ray_tpu.models.gpt import gpt_verify_step as jverify
    else:
        from ray_tpu.models.llama import llama_prefill as jprefill
        from ray_tpu.models.llama import llama_verify_step as jverify
    jcfg, tcfg, tree, state = _weights(fam)
    model = family(fam).model(tcfg, "cpu").load_weights(state)
    rng = np.random.default_rng(11)
    B, W, S, bs, NB = 4, 5, 24, 8, 5
    hkv = getattr(jcfg, "n_kv_head", jcfg.n_head)
    shape = (jcfg.n_layer, 1 + 3 * NB, bs, hkv, jcfg.head_dim)
    tables = np.zeros((B, NB), np.int32)
    tables[:3] = (1 + rng.permutation(3 * NB)).reshape(3, NB)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    lens = np.array([21, 13, 8, 1], np.int32)
    jk = jv = jnp.zeros(shape, jnp.float32)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    _, jk, jv = jprefill(tree, jk, jv, jnp.asarray(toks), jnp.asarray(lens),
                         jnp.asarray(tables), jcfg)
    model.prefill(tk, tv, torch.from_numpy(toks), torch.from_numpy(lens),
                  torch.from_numpy(tables))
    window = rng.integers(0, jcfg.vocab_size, (B, W)).astype(np.int32)
    starts = np.array([21, 13, 8, 0], np.int32)
    dlen = np.array([4, 2, 0, 0], np.int32)
    args = [window, starts, dlen, tables]
    jl, jk2, jv2 = jverify(tree, jk, jv, *map(jnp.asarray, args), jcfg)
    tl, tk2, tv2 = model.verify_step(tk, tv, *map(torch.from_numpy, args))
    assert tl.shape == (B, W, jcfg.vocab_size) and tl.dtype == torch.float32
    # the padding row reads block 0, the garbage sink both sides write
    err = float(np.abs(tl[:3].numpy() - np.asarray(jl)[:3]).max())
    assert err <= LOGIT_TOL, err
    for t, j in ((tk2, jk2), (tv2, jv2)):
        err = float(np.abs(t[:, 1:].numpy() - np.asarray(j)[:, 1:]).max())
        assert err <= LOGIT_TOL, err

    # packed verdicts, sampled rows beside greedy ones, on the pool as it
    # stood before the window (the same window writes the same K/V)
    temp = np.array([0.0, 0.8, 1.1, 0.0], np.float32)
    top_p = np.array([1.0, 0.9, 1.0, 1.0], np.float32)
    top_k = np.array([0, 0, 30, 0], np.int32)
    seeds = np.array([3, 4, 5, 0], np.uint32)
    jsample = {"seeds": jnp.asarray(seeds), "temperature": jnp.asarray(temp),
               "top_k": jnp.asarray(top_k), "top_p": jnp.asarray(top_p)}
    pos = starts[:, None] + 1 + np.arange(W)
    tsample = {"all_greedy": False, "temperature": torch.from_numpy(temp),
               "top_k": torch.from_numpy(top_k),
               "top_p": torch.from_numpy(top_p),
               "uniform": keyed_uniform(np.repeat(seeds, W),
                                        pos.reshape(-1)).reshape(B, W)}
    want, _, _ = jverify(tree, jk, jv, *map(jnp.asarray, args), jcfg,
                         sample=jsample)
    got, _, _ = model.verify_step(tk, tv, *map(torch.from_numpy, args),
                                  sample=tsample)
    np.testing.assert_array_equal(got[:3].numpy(), np.asarray(want)[:3])


# ----------------------------------------------------------------- engine

@pytest.mark.timeout(300)
@pytest.mark.parametrize("fam", ["gpt", "llama"])
@pytest.mark.parametrize("sampling", SAMPLINGS, ids=["greedy", "nucleus"])
def test_spec_streams_equal_jax_and_spec_off(fam, sampling):
    """speculative_k = 4: the port's streams equal its own spec-off
    streams and the JAX engine's spec-on streams, with the same
    speculation counters in ``stats()``; the signature kinds grow by
    "verify" alone and the pool is whole at the end."""
    rng = np.random.default_rng(2)
    requests = [(MOTIF * 3, {**sampling, "max_new_tokens": 24}),
                (MOTIF[3:] * 2, {"max_new_tokens": 16}),
                (rng.integers(0, 512, 9).tolist(),
                 {**sampling, "max_new_tokens": 12})]
    jeng = _jax_engine(fam, speculative_k=4)
    want = _run(jeng, requests)
    off = _port_engine(fam)
    assert _run(off, requests) == want
    eng = _port_engine(fam, speculative_k=4)
    assert _run(eng, requests) == want
    assert [len(o) for o in want] == [24, 16, 12]
    mine, ref = eng.stats(), jeng.stats()
    assert {k: mine[k] for k in SPEC_KEYS} == {k: ref[k] for k in SPEC_KEYS}
    assert mine["spec_steps"] > 0
    kinds = {s[0] for s in eng.fns.signatures}
    assert "verify" in kinds and kinds <= {"prefill", "prefill_chunk",
                                           "decode", "verify"}
    W = {s[3] for s in eng.fns.signatures if s[0] == "verify"}
    assert W == {5}
    syncs = [r for r in eng.debug_dump()["steps"] if r["kind"] == "verify"]
    assert syncs and all(r["sync_lag"] == 0 for r in syncs)
    assert all(r["sync_bytes"] == 4 * 4 * 6 for r in syncs)  # [B, W+1]
    _assert_pool_whole(eng)
    jeng.shutdown()


def test_spec_accepts_on_repeating_prompts():
    """On the motif the n-gram drafter earns its keep: more than 1.3
    tokens committed a verify step (the JAX suite's bar)."""
    eng = _port_engine("llama", speculative_k=3)
    assert len(_run(eng, [(MOTIF * 3, {"max_new_tokens": 32})])[0]) == 32
    st = eng.stats()
    assert st["spec_accept_rate"] > 0.0
    assert st["spec_committed_per_step"] > 1.3, st
    assert st["spec_committed_tokens"] >= st["spec_accepted_tokens"]


@pytest.mark.parametrize("budget", [1, 2, 5])
def test_spec_budget_never_overshoots(budget):
    """The draft clamp keeps a fully accepted window inside
    max_new_tokens, and the reservation."""
    off = _port_engine("llama").generate(MOTIF * 3, max_new_tokens=budget)
    eng = _port_engine("llama", speculative_k=4)
    assert eng.generate(MOTIF * 3, max_new_tokens=budget) == off
    assert len(off) == budget
    _assert_pool_whole(eng)


class _GarbageDrafter:
    """Out-of-vocab ids, negatives and wrong but valid tokens."""

    def __init__(self, vocab_size):
        self._vocab = vocab_size
        self._calls = 0

    def propose(self, prompt, generated, k):
        self._calls += 1
        garbage = [self._vocab + 5, -1, 0, 1, self._vocab * 2]
        return garbage[self._calls % len(garbage):][:k]


@pytest.mark.parametrize("sampling", SAMPLINGS, ids=["greedy", "nucleus"])
def test_garbage_drafter_is_lossless(sampling):
    base = _port_engine("llama").generate(MOTIF * 2, max_new_tokens=12,
                                          **sampling)
    eng = _port_engine("llama", speculative_k=4,
                       drafter=_GarbageDrafter(512))
    assert eng.generate(MOTIF * 2, max_new_tokens=12, **sampling) == base
    while eng.step():
        pass
    _assert_pool_whole(eng)


class _OracleDrafter:
    """Proposes the true continuation of one prompt (so its windows are
    accepted whole), nothing for other prompts."""

    def __init__(self, prompt, continuation):
        self._prompt = list(prompt)
        self._cont = list(continuation)

    def propose(self, prompt, generated, k):
        if list(prompt) != self._prompt:
            return []
        n = len(generated)
        return self._cont[n:n + k]


def test_eos_mid_window_releases_blocks_once():
    """A fully accepted window holding EOS ends the stream AT the EOS
    token, nothing after it, with the request's blocks back exactly once
    while a neighbour keeps the lag-1 pipeline running; the pool then
    serves the same request again."""
    prompt = MOTIF * 2
    probe = _port_engine("llama").generate(prompt, max_new_tokens=10)
    eos = next((t for t in probe[2:4] if probe.index(t) >= 2), probe[2])
    expected = probe[:probe.index(eos) + 1]
    assert 3 <= len(expected) <= 4
    eng = _port_engine("llama", eos_id=eos, speculative_k=4,
                       drafter=_OracleDrafter(prompt, probe))
    s1 = eng.submit(prompt, max_new_tokens=50)
    s2 = eng.submit([7] * 9, max_new_tokens=20)
    while eng.step():
        pass
    assert list(s1) == expected
    assert s2.done
    st = eng.stats()
    assert st["spec_steps"] >= 1 and st["spec_accepted_tokens"] >= 1, st
    _assert_pool_whole(eng)
    assert eng.generate(prompt, max_new_tokens=50) == expected
    _assert_pool_whole(eng)


def test_speculative_k_validation():
    with pytest.raises(ValueError, match="speculative_k must be >= 0"):
        _port_engine("llama", speculative_k=-1)
    eng = _port_engine("llama", speculative_k=2, drafter=None)
    assert eng.generate(MOTIF, max_new_tokens=4) == _port_engine(
        "llama").generate(MOTIF, max_new_tokens=4)
    assert eng.stats()["spec_steps"] == 0
