"""The prefix cache's device side on the card (marked ``gpu``: skips
without an NVIDIA card of compute capability 9.0 or more): the block
moves write the pool in place, so its addresses do not change and a
decode graph replayed after them reads the new content; a copy-on-write
of a quantized pool moves the scale planes with the data; and the
prefill kernel (B5, B5q) at the offsets a prefix hit gives it (a
one-token chunk at 575 after a full-chain hit, a suffix chunk at 512)
against its plain version, at Llama-125M's heads (4 kv heads of 64,
query groups of 3)."""
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


def _engine(kind):
    from ray_tpu_torch.models.gpt import GPTConfig
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    return LLMEngine(EngineConfig(model="gpt", model_config=GPTConfig.tiny(),
                                  num_blocks=32, block_size=16,
                                  quantization=kind), auto_step=False)


def _planes(side):
    return (side.data, side.scale) if hasattr(side, "scale") else (side,)


def _scaled(side, f):
    """A host payload's values times ``f`` (a quantized one's scales)."""
    from ray_tpu_torch.ops.quantization import QuantizedKV

    if hasattr(side, "scale"):
        return QuantizedKV(side.data, side.scale * f)
    bf16 = torch.from_numpy(side.view(np.int16)).view(torch.bfloat16)
    return (bf16 * f).view(torch.int16).numpy().view(np.uint16)


def _pointers(cache):
    return [t.data_ptr() for side in (cache.k, cache.v) for t in _planes(side)]


@pytest.mark.parametrize("kind", [None, "int8", "fp8"])
def test_block_moves_in_place_under_a_decode_graph(cuda, kind):
    """``copy_blocks`` and ``land_blocks`` keep the pool's addresses, and
    the captured decode graph, replayed after them, gives the eager
    step's ids on the new content (which changes them)."""
    eng = _engine(kind)
    ex, cache = eng.executor, eng.cache
    rng = np.random.default_rng(0)
    B, nb = 2, 4
    tables = np.arange(1, 1 + B * nb, dtype=np.int32).reshape(B, nb)
    lengths = np.array([40, 50], np.int32)
    tokens = rng.integers(0, 512, (B, 64)).astype(np.int32)
    first = ex.sync_tokens(ex.prefill(tokens, lengths, tables))
    g = ex.stage_decode(first, lengths, tables)
    before = g.run().clone()
    ptrs = _pointers(cache)
    # row 0's keys and values scaled by 50 (landed), block 5 copied onto 3
    k, v = ex.export_blocks([1, 2, 3])
    k, v = _scaled(k, 50), _scaled(v, 50)
    ex.land_blocks([1, 2, 3], k, v)
    ex.copy_blocks([(5, 3)])
    assert _pointers(cache) == ptrs
    for got, want in zip(ex.export_blocks([1, 2]), (k, v)):
        for a, b in zip(_planes(got), _planes(want)):
            assert np.array_equal(a, b[:, :2])
    g = ex.stage_decode(first, lengths, tables)
    replayed = g.run().clone()
    eager = ex.fns.step(g.inputs, False).clone()
    torch.cuda.synchronize()
    assert torch.equal(replayed, eager)
    assert not torch.equal(replayed, before)


@pytest.mark.parametrize("kind", [None, "int8", "fp8"])
def test_copy_on_write_moves_every_plane(cuda, kind):
    """A copy-on-write pair clones data (and a quantized pool's scale
    plane) in every layer; the source block and every other block keep
    their bytes."""
    eng = _engine(kind)
    ex, cache = eng.executor, eng.cache
    gen = torch.Generator(device=cuda).manual_seed(1)
    planes = []
    for side in (cache.k, cache.v):
        for t in ((side.data.view(torch.uint8), side.scale) if kind
                  else (side,)):
            if t.dtype == torch.uint8:
                t.copy_(torch.randint(0, 120, t.shape, generator=gen,
                                      device=cuda, dtype=torch.uint8))
            else:
                t.copy_(torch.randn(t.shape, generator=gen, device=cuda))
            planes.append(t)
    saved = [t.clone() for t in planes]
    ex.copy_blocks([(4, 9), (7, 11)])
    torch.cuda.synchronize()
    for t, s in zip(planes, saved):
        want = s.clone()
        want[:, 9], want[:, 11] = s[:, 4], s[:, 7]
        assert torch.equal(t, want)
    assert len(planes) == (4 if kind else 2)


@pytest.mark.parametrize("kind", [None, "int8", "fp8"])
@pytest.mark.parametrize("start,S", [(575, 1), (512, 64)],
                         ids=["one-token@575", "suffix@512"])
def test_prefill_kernel_at_prefix_hit_offsets(cuda, kind, start, S):
    """B5 (B5q on an int8 / fp8 pool) with a bf16 q for a chunk that
    starts past a prefix hit: the one token a full-chain hit of a
    576-token prompt recomputes, and a 64-token suffix after a 512-token
    hit, beside a fresh row, against the plain version."""
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.ops.kv_cache import paged_prefill_attention

    pool_dtype = torch.float32 if kind else torch.bfloat16
    q, k, v, tables, pos, valid = _prefill_inputs(
        cuda, pool_dtype, [start, 0], S, [S, S], 4, 3, 64, 16)
    q = q.to(torch.bfloat16)
    k, v = _padded_pool(k, v, kind)
    key = "paged_prefill" + (f"_{kind}" if kind else "")
    before = pa.LAUNCHES[key]
    got = pa.paged_prefill_attention_cuda(q, k, v, tables, pos)
    torch.cuda.synchronize()
    assert pa.LAUNCHES[key] == before + 1
    want = paged_prefill_attention(q, k, v, tables, pos)
    _assert_close(got[valid], want[valid], torch.bfloat16)
