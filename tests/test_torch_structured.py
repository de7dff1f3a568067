"""Structured output and the request surface of the port's engine
(``ray_tpu_torch``) against the JAX package on the CPU: the copied grammar
compiler's ``TokenDFA`` tables and cursor equal JAX's for a corpus of
regex, JSON-mode and JSON-Schema grammars; ``SamplingParams`` validates
with JAX's texts (and refuses ``priority`` until preemption is ported);
constrained streams, with speculation off and on, equal the JAX engine's;
a mixed batch keeps its unconstrained rows' bytes; stop sequences fire
across the resume boundary; a deadline ends a stream with
``DeadlineExceededError`` and every block back; a resumed constrained
stream equals the JAX engine's resumed stream; and the ``stats()``
structured keys equal JAX's.

Tiny f32 configs (vocab 512, so token t < 256 is byte t; EOS 0) whose
weights are the JAX init at ``PRNGKey(0)``, carried across by
``convert.py``; one batch and one length bucket."""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

VOCAB, EOS = 512, 0
BUCKETS = dict(block_size=8, num_blocks=64, batch_buckets=(4,),
               length_buckets=(64,), eos_id=EOS)
# the JAX suite's grammar corpus (tests/test_serve_llm_structured.py)
REGEXES = [
    r"[0-9]{1,3}(\.[0-9]{1,3}){3}",
    r"(yes|no|maybe)",
    r"-?(0|[1-9][0-9]*)(\.[0-9]+)?",
    r"[a-f]+x?",
    r'"(a|b)*"',
]
SCHEMAS = [
    {"type": "object", "properties": {"ok": {"type": "boolean"}}},
    {"type": "object", "properties": {
        "n": {"type": "integer"},
        "tag": {"enum": ["x", "y"]},
    }},
    {"type": "array", "items": {"type": "integer"},
     "minItems": 1, "maxItems": 3},
    {"const": "done"},
    {"anyOf": [{"type": "integer"}, {"type": "boolean"}]},
]
SPECS = ([{"type": "regex", "pattern": p} for p in REGEXES]
         + [{"type": "json_schema", "schema": s} for s in SCHEMAS]
         + ["json", {"type": "json_object"}])
IP = {"type": "regex", "pattern": r"[0-9]{1,3}(\.[0-9]{1,3}){3}"}
NUMBER = {"type": "regex", "pattern": r"-?(0|[1-9][0-9]*)(\.[0-9]+)?"}
NUCLEUS = dict(temperature=0.9, top_p=0.9, seed=5)


@pytest.fixture(autouse=True)
def _cpu(jax_cpu):
    return jax_cpu


_WEIGHTS: dict = {}


def _weights(fam):
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
                                  prefix_caching=False,
                                  attention_backend="xla",
                                  **{**BUCKETS, **kw}),
                     params=jax.tree.map(jnp.asarray, tree), auto_step=False)


def _port_engine(fam="llama", **kw):
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    _, tcfg, _, state = _weights(fam)
    return LLMEngine(EngineConfig(model=fam, model_config=tcfg, device="cpu",
                                  prefix_caching=False, **{**BUCKETS, **kw}),
                     params=state, auto_step=False)


def _run(engine, requests):
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


def _dfas(spec, vocab=VOCAB, eos=EOS):
    from ray_tpu.serve.llm import structured as J

    from ray_tpu_torch.serve.llm import structured as T

    return (T.compile_grammar(T.parse_response_format(spec), vocab, eos),
            J.compile_grammar(J.parse_response_format(spec), vocab, eos))


def _assert_valid(spec, toks, budget):
    """A fresh cursor accepts every token of the stream; one that ended
    before its budget sits at a full match (``must_stop`` or EOS)."""
    from ray_tpu_torch.serve.llm import structured

    cur = structured.FSMCursor(_dfas(spec)[0])
    body = [t for t in toks if t != EOS]
    for t in body:
        assert cur.advance(t), (t, toks)
    if len(toks) < budget:
        assert cur.accepting, bytes(body)
    return bytes(body)


# ---------------------------------------------------------------- compiler

@pytest.mark.parametrize("spec", SPECS, ids=lambda s: json.dumps(s)[:40])
@pytest.mark.parametrize("vocab,eos", [(VOCAB, EOS), (32000, None)])
def test_token_dfa_equals_jax(spec, vocab, eos):
    """trans, accept, mask, allowed_counts and must_stop equal JAX's, and
    so do a cursor's filter_draft and stage_verify_masks along seeded
    walks."""
    from ray_tpu_torch.serve.llm import structured

    mine, ref = _dfas(spec, vocab, eos)
    for name in ("trans", "accept", "mask", "allowed_counts", "must_stop"):
        a, b = getattr(mine, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (mine.vocab_size, mine.eos_id, mine.words) == (
        ref.vocab_size, ref.eos_id, ref.words)
    rng = np.random.default_rng(len(json.dumps(spec)))
    cur = structured.FSMCursor(mine)
    for _ in range(12):
        nxt = np.flatnonzero(mine.trans[cur.state] >= 0)
        draft = rng.integers(0, 256, 4).tolist()
        if len(nxt):
            draft[:2] = rng.choice(nxt, 2).tolist()
        out = np.zeros((5, mine.words), np.uint32)
        cur.stage_verify_masks(out, draft)
        st, want = cur.state, np.zeros_like(out)
        # the JAX cursor at the same state
        from ray_tpu.serve.llm import structured as J
        jcur = J.FSMCursor(ref)
        jcur.state = st
        jcur.stage_verify_masks(want, draft)
        np.testing.assert_array_equal(out, want)
        assert cur.filter_draft(draft) == jcur.filter_draft(draft)
        if not len(nxt):
            break
        assert cur.advance(int(rng.choice(nxt)))


def test_response_format_and_errors_equal_jax():
    from ray_tpu.serve.llm import structured as J

    from ray_tpu_torch.serve.llm import structured as T

    good = [None, "json", "json_object", {"type": "json_object"},
            {"type": "json_schema", "json_schema": {"schema": SCHEMAS[1]}},
            {"type": "json_schema", "schema": SCHEMAS[2]},
            {"type": "regex", "pattern": "ab+"}]
    for v in good:
        a, b = T.parse_response_format(v), J.parse_response_format(v)
        assert (a is None and b is None) or (a.kind, a.text) == (b.kind,
                                                                 b.text)
    bad = ["xml", {"type": "yaml"}, {"type": "regex"}, 5,
           {"type": "json_schema", "schema": 3}]
    for v in bad:
        with pytest.raises(T.GrammarError) as mine:
            T.parse_response_format(v)
        with pytest.raises(J.GrammarError) as ref:
            J.parse_response_format(v)
        assert str(mine.value) == str(ref.value)
    assert issubclass(T.GrammarError, ValueError)
    for spec in ({"type": "regex", "pattern": "a(b"},
                 {"type": "regex", "pattern": "(?=a)b"},
                 {"type": "json_schema", "schema": {"type": "tuple"}}):
        with pytest.raises(T.GrammarError) as mine:
            T.compile_grammar(T.parse_response_format(spec), VOCAB, EOS)
        with pytest.raises(J.GrammarError) as ref:
            J.compile_grammar(J.parse_response_format(spec), VOCAB, EOS)
        assert str(mine.value) == str(ref.value)


def test_grammar_cache_counts():
    from ray_tpu_torch.serve.llm import structured

    structured.clear_cache()
    spec = structured.parse_response_format("json")
    a = structured.compile_grammar(spec, VOCAB, EOS)
    assert structured.compile_grammar(spec, VOCAB, EOS) is a
    assert structured.compile_grammar(spec, VOCAB, None) is not a
    assert structured.cache_stats() == {"size": 2, "lookups": 3, "hits": 1}
    structured.clear_cache()
    assert structured.cache_stats() == {"size": 0, "lookups": 0, "hits": 0}


# ---------------------------------------------------------- SamplingParams

@pytest.mark.parametrize("kw", [
    dict(max_new_tokens=0), dict(max_new_tokens=1 << 21),
    dict(start_index=-1), dict(temperature=float("nan")),
    dict(temperature=-0.5), dict(top_k=-2), dict(top_p=0.0),
    dict(top_p=1.5), dict(stop=((),)),
])
def test_sampling_params_validation_equals_jax(kw):
    from ray_tpu.serve.llm import SamplingParams as J

    from ray_tpu_torch.serve.llm import SamplingParams as T

    with pytest.raises(ValueError) as mine:
        T(**kw)
    with pytest.raises(ValueError) as ref:
        J(**kw)
    assert str(mine.value) == str(ref.value)


def test_sampling_params_fields():
    from ray_tpu.serve.llm import SamplingParams as J

    from ray_tpu_torch.serve.llm import SamplingParams as T

    kw = dict(stop=(5, [6, 7]), deadline_s=2.5, start_index=3,
              structured="json")
    mine, ref = T(**kw), J(**kw)
    assert mine.stop == ref.stop == ((5,), (6, 7))
    for name in ("deadline_s", "start_index", "structured"):
        assert getattr(mine, name) == getattr(ref, name)
    assert dataclasses.replace(mine, seed=4).stop == ((5,), (6, 7))
    for p in ("batch", "default", "interactive"):
        assert T(priority=p).priority == J(priority=p).priority == p
    with pytest.raises(ValueError) as mine_err:
        T(priority="bulk")
    with pytest.raises(ValueError) as ref_err:
        J(priority="bulk")
    assert str(mine_err.value) == str(ref_err.value)


# ------------------------------------------------------------------ engine

@pytest.mark.timeout(300)
@pytest.mark.parametrize("fam,k", [("llama", 0), ("llama", 3), ("gpt", 0),
                                   ("gpt", 3)])
def test_constrained_streams_equal_jax(fam, k):
    """One batch of constrained requests (JSON mode greedy and sampled, a
    schema, a regex) beside an unconstrained one, with speculation off and
    on: every stream equals the JAX engine's, every constrained stream is
    grammar-valid, the structured counters equal JAX's, and the pool is
    whole at the end."""
    from ray_tpu.serve.llm import structured as J

    from ray_tpu_torch.serve.llm import structured as T

    requests = [
        ([9, 8, 7], dict(max_new_tokens=24, structured="json")),
        ([6, 4, 2], dict(max_new_tokens=20, structured=NUMBER, **NUCLEUS)),
        ([1, 2, 3], dict(max_new_tokens=24, structured={
            "type": "json_schema", "schema": SCHEMAS[1]})),
        ([4, 5, 6], dict(max_new_tokens=12, temperature=0.7, seed=3)),
    ]
    T.clear_cache()
    J.clear_cache()
    jeng = _jax_engine(fam, speculative_k=k)
    want = _run(jeng, requests)
    eng = _port_engine(fam, speculative_k=k)
    streams = [eng.submit(p, **kw) for p, kw in requests]
    eng.step()  # the first prefill: three constrained rows running
    assert eng.stats()["structured_running"] == 3
    while eng.step():
        pass
    got = [list(s) for s in streams]
    assert got == want
    for (p, kw), toks in zip(requests, got):
        if kw.get("structured"):
            _assert_valid(kw["structured"], toks, kw["max_new_tokens"])
    mine, ref = eng.stats(), jeng.stats()
    for key in ("structured_running", "grammar_cache", "spec_steps",
                "spec_drafted_tokens", "spec_accepted_tokens",
                "spec_committed_tokens"):
        assert mine[key] == ref[key], key
    assert (mine["spec_steps"] > 0) == (k > 0)
    _assert_pool_whole(eng)
    jeng.shutdown()


@pytest.mark.parametrize("k", [0, 3])
def test_mixed_batch_keeps_unconstrained_bytes(k):
    """An unconstrained row batched with constrained ones equals the same
    row in an all-unconstrained batch; unconstrained batches stage no
    mask (their decode signatures are unmasked), constrained ones do."""
    plain = [([4, 5, 6], dict(max_new_tokens=12, temperature=0.7, seed=3)),
             ([1, 2, 3], dict(max_new_tokens=16)),
             ([2, 2, 2], dict(max_new_tokens=16))]
    base = _port_engine(speculative_k=k)
    solo = _run(base, plain)
    assert not any(s[-1] for s in base.fns.signatures
                   if s[0] in ("decode", "verify"))
    mixed = [plain[0],
             ([1, 2, 3], dict(max_new_tokens=16, structured=IP)),
             ([2, 2, 2], dict(max_new_tokens=16, structured="json"))]
    eng = _port_engine(speculative_k=k)
    got = _run(eng, mixed)
    assert got[0] == solo[0]
    _assert_valid(IP, got[1], 16)
    _assert_valid("json", got[2], 16)
    assert any(s[-1] for s in eng.fns.signatures if s[0] == "decode")


def test_chunked_prefill_constrained_stream_equals_monolithic():
    spec = {"type": "regex", "pattern": "(yes|no|maybe)"}
    prompt = list(range(1, 38))
    mono = _port_engine().generate(prompt, max_new_tokens=12,
                                   structured=spec)
    chunked = _port_engine(prefill_chunk_tokens=8).generate(
        prompt, max_new_tokens=12, structured=spec)
    assert chunked == mono
    _assert_valid(spec, chunked, 12)


@pytest.mark.parametrize("k", [0, 3])
def test_stop_sequences_equal_jax_across_resume(k):
    """A stop sequence ends the stream after its last token (emitted, like
    EOS); one that straddles the resume boundary fires on the first
    resumed token; both as the JAX engine does."""
    base = _port_engine().generate([5, 6, 7], max_new_tokens=10,
                                   temperature=0.8, seed=42)
    assert len(base) == 10
    cases = [
        ([5, 6, 7], dict(max_new_tokens=10, temperature=0.8, seed=42,
                         stop=(base[2:4],))),
        ([5, 6, 7] + base[:3], dict(max_new_tokens=7, temperature=0.8,
                                    seed=42, start_index=3,
                                    stop=((base[2], base[3]),))),
        ([5, 6, 7], dict(max_new_tokens=10, stop=(999, [1, 2, 3, 4]))),
    ]
    got = [_run(_port_engine(speculative_k=k), [c])[0] for c in cases]
    want = [_run(_jax_engine(speculative_k=k), [c])[0] for c in cases]
    assert got == want
    assert got[0] == base[:4] and got[1] == [base[3]]


def test_deadline_expires_and_pool_stays_whole():
    """A request past its deadline is evicted at the top of the next step:
    its stream raises ``DeadlineExceededError`` after the tokens it had,
    its blocks go back once (also from under an in-flight decode step),
    and a neighbour without a deadline finishes untouched."""
    import time

    from ray_tpu_torch.exceptions import DeadlineExceededError

    want = _port_engine().generate([3, 1, 4], max_new_tokens=12)
    eng = _port_engine()
    late = eng.submit([1, 5, 9], max_new_tokens=40, deadline_s=0.05)
    keep = eng.submit([3, 1, 4], max_new_tokens=12)
    for _ in range(4):
        eng.step()
    assert eng.stats()["decode_inflight"] == 1  # lag 1 when it expires
    time.sleep(0.06)
    while eng.step():
        pass
    got = []
    with pytest.raises(DeadlineExceededError, match="deadline"):
        for t in late:
            got.append(t)
    assert 0 < len(got) < 40
    assert list(keep) == want
    assert eng.stats()["deadline_exceeded_total"] == 1
    _assert_pool_whole(eng)
    waiting = eng.submit([2, 7], max_new_tokens=4, deadline_s=0.0)
    eng.step()
    with pytest.raises(DeadlineExceededError):
        list(waiting)
    assert eng.stats()["deadline_exceeded_total"] == 2
    _assert_pool_whole(eng)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("fam", ["gpt", "llama"])
@pytest.mark.parametrize("sampling", [dict(), dict(temperature=0.8,
                                                   top_p=0.9, seed=21)],
                         ids=["greedy", "nucleus"])
def test_constrained_resume_equals_jax(fam, sampling):
    """Failover resume with a grammar: prompt + delivered re-prefilled on a
    fresh engine, the FSM replayed over the delivered tokens; the resumed
    stream equals the rest of the full one and the JAX engine's resumed
    stream (speculation on for the port)."""
    full = _port_engine(fam).generate([7, 7, 7], max_new_tokens=15,
                                      structured=IP, **sampling)
    assert len(full) >= 8, full
    _assert_valid(IP, full, 15)
    k = 3
    resume = ([7, 7, 7] + full[:k], dict(max_new_tokens=15 - k, structured=IP,
                                         start_index=k, **sampling))
    resumed = _run(_port_engine(fam, speculative_k=3), [resume])[0]
    assert resumed == full[k:]
    assert resumed == _run(_jax_engine(fam), [resume])[0]


def test_bad_grammar_and_resume_raise_at_submit():
    from ray_tpu_torch.serve.llm.structured import GrammarError

    eng = _port_engine()
    with pytest.raises(GrammarError):
        eng.submit([1, 2, 3, ord("z"), ord("z")], max_new_tokens=4,
                   structured={"type": "regex", "pattern": "ab*"},
                   start_index=2)
    with pytest.raises(GrammarError):
        eng.submit([1, 2], structured={"type": "regex", "pattern": "(a"})
    assert eng.stats()["waiting"] == 0


def test_json_mode_stream_parses():
    """JSON mode with speculation on: a grammar-valid stream, a whole
    object when it ends before its budget."""
    toks = _port_engine(speculative_k=3).generate(
        [9, 8, 7], max_new_tokens=96, structured="json")
    body = _assert_valid("json", toks, 96)
    if len(toks) < 96:
        assert isinstance(json.loads(body), dict)
    else:
        assert body.startswith(b"{")
