"""Speculative decoding and structured output on the card (marked
``gpu``: skips without an NVIDIA card of compute capability 9.0 or
more): the prefill kernel (B5, and B5q on int8 / fp8 pools) at verify
windows, k + 1 = 5 columns at query groups of 3 (Llama-125M's 12 query
heads on 4 kv heads of 64), windows starting mid-block, padding columns
at position 0, against its plain version; a verify graph replayed after
block moves (a copy-on-write under a window and a landing, the pool
written in place) against the eager verify step; the masked decode
graph against the eager masked step; and an f32 engine whose spec-on
streams equal its spec-off streams, every verify step a graph replay."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_kernels import (  # noqa: F401 — cuda is a fixture
    _assert_close,
    _padded_pool,
    _prefill_inputs,
    cuda,
)

pytestmark = pytest.mark.gpu

W = 5  # speculative_k = 4


@pytest.mark.parametrize("kind", [None, "int8", "fp8"])
@pytest.mark.parametrize("qdtype", [torch.bfloat16, torch.float32])
def test_prefill_kernel_at_verify_windows(cuda, kind, qdtype):
    """B5 / B5q over [8, 5] windows at true positions ``starts + s`` for
    the valid columns (draft lengths 0-4) and position 0 for the padding
    columns: every column, padding included, finite and within the
    kernel tolerance of the plain version."""
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.ops.kv_cache import paged_prefill_attention

    starts = [37, 130, 0, 511, 64, 15, 700, 1018]
    dlen = [4, 3, 0, 2, 4, 1, 0, 1]
    pool_dtype = torch.float32 if kind else qdtype
    q, k, v, tables, pos, valid = _prefill_inputs(
        cuda, pool_dtype, starts, W, [d + 1 for d in dlen], 4, 3, 64, 16)
    q = q.to(qdtype)
    k, v = _padded_pool(k, v, kind)
    key = "paged_prefill" + (f"_{kind}" if kind else "")
    before = pa.LAUNCHES[key]
    got = pa.paged_prefill_attention_cuda(q, k, v, tables, pos)
    torch.cuda.synchronize()
    assert pa.LAUNCHES[key] == before + 1
    assert torch.isfinite(got).all()
    want = paged_prefill_attention(q, k, v, tables, pos)
    _assert_close(got, want, qdtype)


def _llama_engine(kind=None, dtype=torch.bfloat16, **kw):
    """A small Llama at Llama-125M's heads (12 query heads on 4 kv heads
    of 64) behind the engine."""
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    cfg = LlamaConfig(vocab_size=512, max_seq_len=256, n_layer=2, n_head=12,
                      n_kv_head=4, d_model=768, d_mlp=512, dtype=dtype)
    return LLMEngine(EngineConfig(model_config=cfg, num_blocks=64,
                                  block_size=16, quantization=kind, **kw),
                     auto_step=False)


def _pointers(cache):
    """The addresses of every plane of the pool (a quantized side's data
    and scales)."""
    return [t.data_ptr() for side in (cache.k, cache.v)
            for t in ((side.data, side.scale) if hasattr(side, "scale")
                      else (side,))]


def _sample(B, sampled):
    temp = np.zeros(B, np.float32)
    if sampled:
        temp[:3] = [0.8, 0.0, 1.2]
    return {"seeds": np.arange(B, dtype=np.int64) + 7, "temperature": temp,
            "top_k": np.zeros(B, np.int32),
            "top_p": np.full(B, 0.9 if sampled else 1.0, np.float32)}


@pytest.mark.parametrize("kind", [None, "int8"])
@pytest.mark.parametrize("sampled", [False, True])
def test_verify_graph_after_block_moves(cuda, kind, sampled):
    """A verify window captured as a graph, replayed after a landing
    rewrote row 0's blocks and a copy-on-write moved the block under row
    1's window (its table now naming the copy): the pool keeps its
    addresses, the replay gives the eager verify step's verdicts on the
    new content, and the window's logits from a graph of the logits step
    equal the eager ones within the engine bar."""
    eng = _llama_engine(kind)
    ex, cache = eng.executor, eng.cache
    rng = np.random.default_rng(1)
    B, nb = 4, 8
    tables = np.zeros((B, nb), np.int32)
    tables[:3] = np.arange(1, 1 + 3 * nb, dtype=np.int32).reshape(3, nb)
    lengths = np.array([40, 53, 17, 1], np.int32)  # row 3: padding
    tokens = rng.integers(0, 512, (B, 64)).astype(np.int32)
    first = ex.sync_tokens(ex.prefill(tokens, lengths, tables))
    window = rng.integers(0, 512, (B, W)).astype(np.int32)
    window[:, 0] = first
    starts = lengths.copy()
    starts[3] = 0
    dlen = np.array([4, 4, 2, 0], np.int32)
    sample = _sample(B, sampled)
    g = ex.stage_verify(window, starts, dlen, tables, sample)
    assert (g.sampled, g.masked, g.kind) == (sampled, False, "verify")
    before = ex.sync_verify(ex._ids("verify", g.run()))
    ptrs = _pointers(cache)
    k, v = ex.export_blocks([1, 2, 3])
    ex.land_blocks([1, 2, 3], v, k)  # row 0's context: K and V swapped
    ex.copy_blocks([(12, 30)])  # row 1's window block (53 // 16 = 3)
    tables[1, 3] = 30
    assert _pointers(cache) == ptrs
    g = ex.stage_verify(window, starts, dlen, tables, sample)
    replayed = g.run().clone()
    eager = ex.fns.verify(g.inputs, sampled, False).clone()
    torch.cuda.synchronize()
    # the padding row reads block 0, where every padding write lands
    assert torch.equal(replayed[:3], eager[:3])
    assert not torch.equal(replayed[:1].cpu(), torch.from_numpy(before[:1]))
    assert ex.fns.graphs_by_kind() == {"decode": 0, "verify": 1}
    assert ex.fns.kind_replays["verify"] == 2

    want = ex.fns.verify(g.inputs, sampled, False, logits=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ex.fns.verify(g.inputs, sampled, False, logits=True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=ex.fns.pool):
        out = ex.fns.verify(g.inputs, sampled, False, logits=True)
    graph.replay()
    torch.cuda.synchronize()
    assert (out[:3] - want[:3]).abs().max().item() <= 0.1


@pytest.mark.parametrize("kind", [None, "int8"])
@pytest.mark.parametrize("sampled", [False, True])
def test_masked_decode_graph_matches_eager(cuda, kind, sampled):
    """A decode step with a grammar mask runs its own (masked) signature:
    the graph replay gives the eager masked step's ids, and every id is
    one its row's mask allows (row 2 all-ones: unconstrained)."""
    from ray_tpu_torch.serve.llm import structured

    eng = _llama_engine(kind)
    ex = eng.executor
    rng = np.random.default_rng(2)
    B, nb = 4, 8
    tables = np.zeros((B, nb), np.int32)
    tables[:3] = np.arange(1, 1 + 3 * nb, dtype=np.int32).reshape(3, nb)
    lengths = np.array([30, 7, 90, 1], np.int32)
    tokens = rng.integers(0, 512, (B, 128)).astype(np.int32)
    first = ex.sync_tokens(ex.prefill(tokens, lengths, tables))
    dfa = structured.compile_grammar(
        structured.parse_response_format("json"), 512, None)
    mask = np.full((B, dfa.words), 0xFFFFFFFF, np.uint32)
    mask[0] = dfa.mask[0]             # "{" only
    mask[1] = dfa.mask[dfa.trans[0, ord("{")]]
    sample = dict(_sample(B, sampled), mask=mask)
    g = ex.stage_decode(first, lengths, tables, sample)
    assert (g.sampled, g.masked) == (sampled, True)
    eager = ex.fns.step(g.inputs, sampled, True).clone()
    graphed = g.run().clone()
    again = g.run().clone()
    torch.cuda.synchronize()
    # row 3, a padding row, reads block 0
    assert torch.equal(graphed[:3], eager[:3])
    assert torch.equal(again[:3], eager[:3])
    ids = graphed.cpu().numpy()
    assert ids[0] == ord("{")
    assert dfa.trans[dfa.trans[0, ord("{")], ids[1]] >= 0
    plain = ex.stage_decode(first, lengths, tables, _sample(B, sampled))
    assert not plain.masked and plain is not g
    assert int(plain.run()[2]) == int(ids[2])


def test_spec_engine_f32_streams_equal_spec_off(cuda):
    """f32 (B4 and B5 on the CUDA-core walk): spec-on streams equal
    spec-off streams on a motif prompt, greedy and sampled; a warm pass
    replays a graph for every verify step, with one lag-0 verify sync a
    step."""
    motif = np.random.default_rng(3).integers(0, 512, 12).tolist()
    reqs = [(motif * 6, {}), (motif * 4, {"temperature": 0.8, "top_p": 0.9,
                                          "seed": 7}), ([5] * 30, {})]

    def run(eng):
        streams = [eng.submit(p, max_new_tokens=40, **kw) for p, kw in reqs]
        while eng.step():
            pass
        return [list(s) for s in streams]

    off = run(_llama_engine(dtype=torch.float32))
    eng = _llama_engine(dtype=torch.float32, speculative_k=4)
    assert run(eng) == off
    steps, replays = eng.stats()["spec_steps"], eng.fns.kind_replays["verify"]
    graphs = eng.fns.graphs_captured
    assert run(eng) == off
    st = eng.stats()
    assert st["spec_steps"] - steps > 0
    assert eng.fns.kind_replays["verify"] - replays == st["spec_steps"] - steps
    assert eng.fns.graphs_captured == graphs
    syncs = [r for r in eng.debug_dump()["steps"] if r["kind"] == "verify"]
    assert syncs and all(r["sync_lag"] == 0 for r in syncs)
