"""Mixture-of-Experts on the card (marked ``gpu``: skips without an NVIDIA
card of compute capability 9.0 or more): the MoE decode and verify steps
capture as CUDA graphs under ``torch.cuda.set_sync_debug_mode("error")``
(no host sync, no shape that depends on the data); a replay gives the
eager step's ids and, on a graph of the step with the route log on, its
routes (experts, slots, keep) exactly; and the index dispatch equals
``moe_reference_dense`` when the capacity drops nothing, bf16 and f32.

The model is a small Llama-MoE at Llama-125M-MoE's widths (12 query
heads on 4 kv heads of 64, 8 experts of 768 -> 512 -> 768, top 2), two
layers, behind the engine."""
from __future__ import annotations

import contextlib
import math

import numpy as np
import pytest
import torch

from test_torch_kernels import cuda  # noqa: F401 — a fixture

pytestmark = pytest.mark.gpu

W = 5  # speculative_k = 4


def _moe_engine(kind=None, **kw):
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    cfg = LlamaConfig(vocab_size=512, max_seq_len=256, n_layer=2, n_head=12,
                      n_kv_head=4, d_model=768, d_mlp=512, num_experts=8,
                      top_k=2)
    return LLMEngine(EngineConfig(model_config=cfg, num_blocks=64,
                                  block_size=16, quantization=kind, **kw),
                     auto_step=False)


@contextlib.contextmanager
def _no_host_sync():
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _sample(B, sampled):
    temp = np.zeros(B, np.float32)
    if sampled:
        temp[:3] = [0.8, 0.0, 1.2]
    return {"seeds": np.arange(B, dtype=np.int64) + 7, "temperature": temp,
            "top_k": np.zeros(B, np.int32),
            "top_p": np.full(B, 0.9 if sampled else 1.0, np.float32)}


def _prefilled(ex, rng):
    """Three sequences (and a padding row) prefilled into the pool."""
    B, nb = 4, 8
    tables = np.zeros((B, nb), np.int32)
    tables[:3] = np.arange(1, 1 + 3 * nb, dtype=np.int32).reshape(3, nb)
    lengths = np.array([40, 53, 17, 1], np.int32)  # row 3: padding
    tokens = rng.integers(0, 512, (B, 64)).astype(np.int32)
    return ex.sync_tokens(ex.prefill(tokens, lengths, tables)), lengths, \
        tables


def _routes_equal(a, b, tokens):
    """The first ``tokens`` routed tokens (the real rows; padding rows come
    last and read the garbage block) route alike at every layer."""
    assert len(a) == len(b) > 0
    for ra, rb in zip(a, b):
        for name in ("experts", "slots", "keep"):
            assert torch.equal(getattr(ra, name)[:tokens],
                               getattr(rb, name)[:tokens]), name


def _graph_of(step, pool):
    """``step()`` captured as a graph (warm-up on a side stream first) and
    replayed once, under the sync debug mode "error"; its output."""
    with _no_host_sync():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            out = step()
    graph.replay()
    torch.cuda.synchronize()
    return graph, out


@pytest.mark.parametrize("kind", [None, "int8"])
@pytest.mark.parametrize("sampled", [False, True])
def test_moe_decode_graph_capture_and_replay(cuda, kind, sampled):
    """The engine's decode graph captures with host syncs raising; its
    replay gives the eager step's ids on the real rows, and a graph of the
    step with the route log on replays the eager step's routes."""
    eng = _moe_engine(kind)
    ex = eng.executor
    first, lengths, tables = _prefilled(ex, np.random.default_rng(1))
    g = ex.stage_decode(first, lengths, tables, _sample(4, sampled))
    with _no_host_sync():
        graphed = g.run().clone()
    assert ex.fns.graphs_by_kind() == {"decode": 1, "verify": 0}
    model = ex.model
    model.route_log = []
    eager = ex.fns.step(g.inputs, sampled).clone()
    eager_routes, model.route_log = model.route_log, []
    torch.cuda.synchronize()
    assert torch.equal(graphed[:3], eager[:3])

    def step():
        model.route_log = []
        return ex.fns.step(g.inputs, sampled)

    graph, out = _graph_of(step, ex.fns.pool)
    graph_routes, model.route_log = model.route_log, None
    assert torch.equal(out[:3], eager[:3])
    _routes_equal(graph_routes, eager_routes, 3)


@pytest.mark.parametrize("kind", [None, "int8"])
def test_moe_verify_graph_capture_and_replay(cuda, kind):
    """A verify window ([4, 5], draft lengths 4, 2, 0 and a padding row)
    captures with host syncs raising; its verdicts equal the eager step's,
    and a graph of the logits step with the route log on gives its routes
    exactly and its window logits within the engine bar (0.1)."""
    eng = _moe_engine(kind, speculative_k=4)
    ex = eng.executor
    rng = np.random.default_rng(2)
    first, lengths, tables = _prefilled(ex, rng)
    window = rng.integers(0, 512, (4, W)).astype(np.int32)
    window[:, 0] = first
    starts = lengths.copy()
    starts[3] = 0
    dlen = np.array([4, 2, 0, 0], np.int32)
    g = ex.stage_verify(window, starts, dlen, tables, _sample(4, True))
    with _no_host_sync():
        replayed = g.run().clone()
    eager = ex.fns.verify(g.inputs, True, False).clone()
    torch.cuda.synchronize()
    assert torch.equal(replayed[:3], eager[:3])
    model = ex.model
    model.route_log = []
    want = ex.fns.verify(g.inputs, True, False, logits=True).clone()
    eager_routes = model.route_log

    def step():
        model.route_log = []
        return ex.fns.verify(g.inputs, True, False, logits=True)

    graph, out = _graph_of(step, ex.fns.pool)
    graph_routes, model.route_log = model.route_log, None
    _routes_equal(graph_routes, eager_routes, 3 * W)
    assert (out[:3] - want[:3]).abs().max().item() <= 0.1  # the engine bar


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_index_dispatch_equals_dense_reference(cuda, dtype):
    """With capacity for every pair (capacity factor 4 >= E / k), the
    index dispatch drops nothing and equals ``moe_reference_dense`` (f32:
    1e-4; bf16: four bf16 ulps of the largest |y|, since the expert
    products come from other matmul calls, [E, C] batches against the
    reference's [E, T], and the combine sums in another order)."""
    from ray_tpu_torch.ops.moe import (
        MoEConfig,
        moe_forward,
        moe_init,
        moe_reference_dense,
        moe_route,
    )

    cfg = MoEConfig(d_model=768, d_hidden=2048, num_experts=8, top_k=2,
                    capacity_factor=4.0, dtype=dtype)
    gen = torch.Generator(device=cuda).manual_seed(3)
    params = moe_init(gen, cfg, cuda)
    x = torch.randn(1024, 768, generator=gen, device=cuda).to(dtype)
    assert bool(moe_route(x, params["router"], cfg).keep.all())
    y, aux = moe_forward(params, x, cfg)
    want = moe_reference_dense(params, x, cfg)
    top = want.float().abs().max().item()
    tol = (1e-4 if dtype == torch.float32
           else 4 * 2.0 ** (math.floor(math.log2(top)) - 7))
    assert (y.float() - want.float()).abs().max().item() <= tol
    assert torch.isfinite(aux)
