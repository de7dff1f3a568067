"""The streaming branch of the port's plain paged prefill
(``ray_tpu_torch/ops/kv_cache.py`` ``_paged_prefill_streaming``) against
the JAX package's (``ray_tpu/ops/kv_cache.py``), on the CPU.

At a context of ``PREFILL_STREAM_MIN_T`` (2048) tokens and more both
packages scan block slabs with an online softmax. With the threshold set
to 1 in both packages, the port's branch matches JAX's within 1e-5 (f32
output) over f32, bf16 and int8 pools, with and without a window, at
query-group sizes 1 and 3; one case at the real T = 2048 (tiny heads)
shows the branch is taken there and not at 2032. On a card,
``test_torch_prefill_stream_gpu.py`` holds B5 against the streaming twin
at T = 2048."""
from __future__ import annotations

import numpy as np
import pytest
import torch

TOL = 1e-5  # f32 out: the same online softmax over the same slabs


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)).copy())


def _tables(rng, lengths, bs, NB):
    ids = 1 + rng.permutation(len(lengths) * NB)
    rows, nxt = [], 0
    for n in lengths:
        need = -(-n // bs)
        rows.append(list(ids[nxt:nxt + need]) + [0] * (NB - need))
        nxt += need
    return np.asarray(rows, np.int32)


def _pools(rng, kind, num_blocks, bs, Hkv, hd):
    """(JAX k, v), (port k, v): the same values, f32 / bf16 / int8."""
    import jax.numpy as jnp
    from ray_tpu.ops.quantization import QuantizedKV as JaxKV
    from ray_tpu.ops.quantization import quantize_kv

    from ray_tpu_torch.ops.quantization import QuantizedKV

    jax_side, port_side = [], []
    for _ in range(2):
        x = rng.normal(size=(num_blocks, bs, Hkv, hd)).astype(np.float32)
        if kind == "int8":
            data, scale = quantize_kv(jnp.asarray(x), "int8")
            jax_side.append(JaxKV(data, scale))
            port_side.append(QuantizedKV(_t(data), _t(scale)))
        elif kind == "bfloat16":
            jax_side.append(jnp.asarray(x).astype(jnp.bfloat16))
            port_side.append(_t(x).to(torch.bfloat16))
        else:
            jax_side.append(jnp.asarray(x))
            port_side.append(_t(x))
    return jax_side, port_side


def _case(rng, kind, starts, S, Hkv, G, hd, bs, NB):
    lens = [S] * len(starts)
    tables = _tables(rng, [s + S for s in starts], bs, NB)
    (jk, jv), (tk, tv) = _pools(rng, kind, 1 + len(starts) * NB, bs, Hkv,
                                hd)
    q = rng.normal(size=(len(starts), S, Hkv * G, hd)).astype(np.float32)
    pos = np.asarray(starts, np.int32)[:, None] + np.arange(
        S, dtype=np.int32)[None, :]
    pos = np.where(np.arange(S)[None, :] < np.asarray(lens)[:, None], pos, 0)
    return q, pos.astype(np.int32), tables, (jk, jv), (tk, tv)


def _both(q, pos, tables, jkv, tkv, window):
    import jax.numpy as jnp
    from ray_tpu.ops.kv_cache import paged_prefill_attention as jax_prefill

    from ray_tpu_torch.ops.kv_cache import paged_prefill_attention

    out = paged_prefill_attention(_t(q), *tkv, _t(tables), _t(pos),
                                  window=window).numpy()
    ref = np.asarray(jax_prefill(jnp.asarray(q), *jkv, jnp.asarray(tables),
                                 jnp.asarray(pos), window=window))
    return out, ref


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("G,window", [(1, None), (3, None), (3, 5)])
def test_streaming_prefill_matches_jax(jax_cpu, monkeypatch, kind, G,
                                       window):
    from ray_tpu.ops import kv_cache as jax_kv

    from ray_tpu_torch.ops import kv_cache as port_kv

    monkeypatch.setattr(jax_kv, "PREFILL_STREAM_MIN_T", 1)
    monkeypatch.setattr(port_kv, "PREFILL_STREAM_MIN_T", 1)
    rng = np.random.default_rng(30 + G)
    q, pos, tables, jkv, tkv = _case(rng, kind, [0, 3, 13], 12, 2, G, 16,
                                     8, 4)
    out, ref = _both(q, pos, tables, jkv, tkv, window)
    assert float(np.max(np.abs(out - ref))) <= TOL


def test_streaming_branch_taken_at_2048(jax_cpu, monkeypatch):
    """At the real threshold: T = 2048 streams (and matches JAX, which
    streams too), T = 2032 stays dense."""
    from ray_tpu_torch.ops import kv_cache as port_kv

    calls = []
    stream = port_kv._paged_prefill_streaming

    def counted(*args, **kw):
        calls.append(args[3].shape)
        return stream(*args, **kw)

    monkeypatch.setattr(port_kv, "_paged_prefill_streaming", counted)
    assert port_kv.PREFILL_STREAM_MIN_T == 2048
    rng = np.random.default_rng(7)
    bs = 16
    for NB, streams in ((128, True), (127, False)):
        T = NB * bs
        q, pos, tables, jkv, tkv = _case(rng, "float32", [T - 4], 4, 1, 2, 8,
                                         bs, NB)
        out, ref = _both(q, pos, tables, jkv, tkv, None)
        assert float(np.max(np.abs(out - ref))) <= TOL
        assert bool(calls) == streams, (T, calls)
        calls.clear()
