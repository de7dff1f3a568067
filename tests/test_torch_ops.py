"""The port's tensor ops (``ray_tpu_torch.ops``) against the JAX package.

The same inputs, made with numpy from a seed, go through the JAX function
and its port in f32 on the CPU. The paged-attention plain versions — what
the CUDA kernels are held to on the card — are checked against both the
JAX XLA formulations and the Pallas kernels in interpret mode, with GQA
1/2/4, shuffled tables, ragged lengths and starts, a sliding window and
q-block padding. Tolerance 1e-5 (f32; the one-shot and online softmaxes
sum in different orders).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu(jax_cpu):
    return jax_cpu


def _j(x):
    import jax.numpy as jnp

    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(port, ref, tol=TOL):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = float(np.max(np.abs(port - ref))) if port.size else 0.0
    assert err <= tol, err


def test_layer_norm_and_gelu():
    from ray_tpu.ops.layers import gelu, layer_norm

    from ray_tpu_torch.ops import layers

    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3 + 1
    scale = rng.normal(size=(64,)).astype(np.float32)
    bias = rng.normal(size=(64,)).astype(np.float32)
    _close(layers.layer_norm(_t(x), _t(scale), _t(bias)),
           layer_norm(_j(x), _j(scale), _j(bias)))
    _close(layers.gelu(_t(x)), gelu(_j(x)))


@pytest.mark.parametrize("heads", [(4, 4), (4, 2)])
@pytest.mark.parametrize("s_q", [7, 12])
def test_mha_reference(heads, s_q):
    from ray_tpu.ops.attention import mha_reference

    from ray_tpu_torch.ops.attention import mha_reference as port

    hq, hkv = heads
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, hq, s_q, 16)).astype(np.float32)
    k = rng.normal(size=(2, hkv, 12, 16)).astype(np.float32)
    v = rng.normal(size=(2, hkv, 12, 16)).astype(np.float32)
    _close(port(_t(q), _t(k), _t(v)), mha_reference(_j(q), _j(k), _j(v)))


def _tables(rng, lengths, bs, NB, shuffle):
    """[B, NB] int32 tables of distinct physical blocks from 1.., padded
    with the garbage block 0 past each length."""
    ids = np.arange(1, 1 + len(lengths) * NB)
    if shuffle:
        rng.shuffle(ids)
    rows, nxt = [], 0
    for n in lengths:
        need = -(-n // bs)
        rows.append(list(ids[nxt:nxt + need]) + [0] * (NB - need))
        nxt += need
    return np.asarray(rows, np.int32)


def _pool(rng, num_blocks, bs, Hkv, hd):
    k = rng.normal(size=(num_blocks, bs, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(num_blocks, bs, Hkv, hd)).astype(np.float32)
    return k, v


def test_write_and_gather_kv():
    from ray_tpu.ops.kv_cache import gather_kv, physical_slots, write_kv

    from ray_tpu_torch.ops import kv_cache as port

    rng = np.random.default_rng(2)
    bs, NB, Hkv, hd = 4, 3, 2, 8
    tables = _tables(rng, [10, 7], bs, NB, shuffle=True)
    k_layer, v_layer = _pool(rng, 1 + 2 * NB, bs, Hkv, hd)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32) + 3, (2, 6)).copy()
    valid = np.array([[1, 1, 1, 1, 1, 1], [1, 1, 1, 1, 0, 0]], bool)
    kk = rng.normal(size=(2, 6, Hkv, hd)).astype(np.float32)
    vv = rng.normal(size=(2, 6, Hkv, hd)).astype(np.float32)

    blk, slot = physical_slots(_j(pos), _j(tables), bs)
    pblk, pslot = port.physical_slots(_t(pos), _t(tables), bs)
    np.testing.assert_array_equal(pblk.numpy(), np.asarray(blk))
    np.testing.assert_array_equal(pslot.numpy(), np.asarray(slot))

    jk, jv = write_kv(_j(k_layer), _j(v_layer), _j(kk), _j(vv), _j(pos),
                      _j(tables), valid=_j(valid))
    tk, tv = _t(k_layer.copy()), _t(v_layer.copy())
    port.write_kv(tk, tv, _t(kk), _t(vv), _t(pos), _t(tables),
                  valid=_t(valid))
    # block 0 takes every padding write (order unspecified): compare the rest
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(jk)[1:])
    np.testing.assert_array_equal(tv.numpy()[1:], np.asarray(jv)[1:])
    # decode-shaped write: one token per row
    dk = rng.normal(size=(2, Hkv, hd)).astype(np.float32)
    dpos = np.array([10, 7], np.int32)
    jk, jv = write_kv(jk, jv, _j(dk), _j(dk), _j(dpos), _j(tables))
    port.write_kv(tk, tv, _t(dk), _t(dk), _t(dpos), _t(tables))
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(jk)[1:])

    gk, gv = gather_kv(jk, jv, _j(tables))
    pk, pv = port.gather_kv(tk, tv, _t(tables))
    live = tables != 0  # garbage-block entries differ by write order
    for b in range(2):
        for i in np.nonzero(live[b])[0]:
            sl = slice(i * bs, (i + 1) * bs)
            np.testing.assert_array_equal(pk.numpy()[b, sl],
                                          np.asarray(gk)[b, sl])
            np.testing.assert_array_equal(pv.numpy()[b, sl],
                                          np.asarray(gv)[b, sl])


@pytest.mark.parametrize("gqa", [1, 2, 4])
def test_paged_attention_plain_matches_jax(gqa):
    from ray_tpu.ops.kv_cache import paged_attention
    from ray_tpu.ops.paged_attention import paged_attention_pallas

    from ray_tpu_torch.ops.kv_cache import paged_attention as port

    rng = np.random.default_rng(10 + gqa)
    lengths = [1, 6, 18, 32]
    Hkv, hd, bs, NB = 2, 16, 8, 4
    tables = _tables(rng, lengths, bs, NB, shuffle=True)
    k, v = _pool(rng, 1 + len(lengths) * NB, bs, Hkv, hd)
    q = rng.normal(size=(len(lengths), Hkv * gqa, hd)).astype(np.float32)
    pos = np.asarray(lengths, np.int32) - 1
    out = port(_t(q), _t(k), _t(v), _t(tables), _t(pos))
    args = (_j(q), _j(k), _j(v), _j(tables), _j(pos))
    _close(out, paged_attention(*args))
    _close(out, paged_attention_pallas(*args))


@pytest.mark.parametrize("gqa,window,q_block", [
    (1, None, None), (2, None, 8), (4, None, None), (2, 5, None),
])
def test_paged_prefill_plain_matches_jax(gqa, window, q_block):
    from ray_tpu.ops.kv_cache import paged_prefill_attention
    from ray_tpu.ops.paged_attention import paged_prefill_attention_pallas

    from ray_tpu_torch.ops.kv_cache import paged_prefill_attention as port

    rng = np.random.default_rng(20 + gqa)
    starts = np.array([0, 3, 9], np.int32)   # ragged, nonzero
    S = 12                                  # not a multiple of q_block=8
    lens = np.array([12, 7, 10], np.int32)  # valid queries per row
    Hkv, hd, bs, NB = 2, 16, 8, 3
    tables = _tables(rng, list(starts + S), bs, NB, shuffle=True)
    k, v = _pool(rng, 1 + len(starts) * NB, bs, Hkv, hd)
    q = rng.normal(size=(3, S, Hkv * gqa, hd)).astype(np.float32)
    pos = starts[:, None] + np.arange(S, dtype=np.int32)[None, :]
    pos = np.where(np.arange(S)[None, :] < lens[:, None], pos, 0)
    pos = pos.astype(np.int32)
    out = port(_t(q), _t(k), _t(v), _t(tables), _t(pos), window=window)
    args = (_j(q), _j(k), _j(v), _j(tables), _j(pos))
    _close(out, paged_prefill_attention(*args, window=window))
    _close(out, paged_prefill_attention_pallas(*args, window=window,
                                               q_block=q_block))


def test_pool_head_dim_pads_only_unaligned_heads():
    """A pool is held at its head dim rounded up to a 16-byte row (8
    elements, 16 for a 1-byte pool): GPT-2's 64 keeps its layout and
    bytes, and the int8 pool stays (64 + 4) / 128 = 0.53125 of bf16's."""
    from ray_tpu_torch.ops.kv_cache import pool_head_dim
    from ray_tpu_torch.serve.llm.kv_cache import KVCacheConfig, PagedKVCache

    assert [pool_head_dim(h) for h in (64, 100, 72, 8, 1, 256)] == [
        64, 104, 72, 8, 8, 256]
    assert [pool_head_dim(h, True) for h in (64, 100, 72, 8, 256)] == [
        64, 112, 80, 16, 256]
    nbytes = {}
    for kind in (None, "int8"):
        cache = PagedKVCache(KVCacheConfig(
            n_layer=2, n_kv_head=12, head_dim=64, num_blocks=4, block_size=16,
            dtype=torch.bfloat16, quantization=kind))
        assert cache.k.shape[-1] == 64
        nbytes[kind] = cache.nbytes()
    assert nbytes[None] == 2 * 2 * 4 * 16 * 12 * 64 * 2
    assert nbytes["int8"] / nbytes[None] == 0.53125
    cache = PagedKVCache(KVCacheConfig(n_layer=1, n_kv_head=2, head_dim=100,
                                       num_blocks=4, quantization="fp8"))
    assert tuple(cache.k.shape) == (1, 4, 16, 2, 112)


@pytest.mark.parametrize("kind", [None, "int8", "fp8"])
def test_paged_plain_at_unaligned_head_dim_matches_pallas(kind):
    """Head dim 100: the port's pool is allocated at pool_head_dim (104,
    or 112 for a 1-byte pool) and written by the port's write_kv, JAX's at
    100 by its own; the port's plain decode and prefill attentions equal
    the Pallas kernels in interpret mode (and the XLA versions), and the
    padding columns stay zero."""
    import jax.numpy as jnp
    from ray_tpu.ops.kv_cache import (
        paged_attention,
        paged_prefill_attention,
        write_kv,
    )
    from ray_tpu.ops.paged_attention import (
        paged_attention_pallas,
        paged_prefill_attention_pallas,
    )
    from ray_tpu.ops.quantization import QuantizedKV as JaxKV
    from ray_tpu.ops.quantization import quant_dtype

    from ray_tpu_torch.ops import kv_cache as port
    from ray_tpu_torch.serve.llm.kv_cache import KVCacheConfig, PagedKVCache

    rng = np.random.default_rng(40)
    starts = np.array([0, 3, 9], np.int32)
    S, Hkv, gqa, hd, bs, NB = 12, 2, 2, 100, 8, 3
    lens = np.array([12, 7, 10], np.int32)
    num_blocks = 1 + len(starts) * NB
    tables = _tables(rng, list(starts + S), bs, NB, shuffle=True)
    cache = PagedKVCache(KVCacheConfig(
        n_layer=1, n_kv_head=Hkv, head_dim=hd, num_blocks=num_blocks,
        block_size=bs, dtype=torch.float32, quantization=kind))
    shape = (num_blocks, bs, Hkv, hd)
    if kind is None:
        jk = jv = jnp.zeros(shape, jnp.float32)
    else:
        jk = jv = JaxKV(jnp.zeros(shape, quant_dtype(kind)),
                        jnp.zeros(shape[:-1], jnp.float32))
    # the whole context of every row, positions 0 .. start + S - 1
    T = int((starts + S).max())
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (3, T)).copy()
    valid = pos < (starts + S)[:, None]
    kk, vv = (rng.normal(size=(3, T, Hkv, hd)).astype(np.float32)
              for _ in range(2))
    jk, jv = write_kv(jk, jv, _j(kk), _j(vv), _j(pos), _j(tables),
                      valid=_j(valid))
    tk, tv = cache.k[0], cache.v[0]
    port.write_kv(tk, tv, _t(kk), _t(vv), _t(pos), _t(tables),
                  valid=_t(valid))
    pad = (tk.data if kind else tk)[..., hd:]
    assert pad.shape[-1] == port.pool_head_dim(hd, kind is not None) - hd
    assert not pad.view(torch.uint8).any() if kind else not pad.any()

    q = rng.normal(size=(3, Hkv * gqa, hd)).astype(np.float32)
    dpos = starts + S - 1
    out = port.paged_attention(_t(q), tk, tv, _t(tables), _t(dpos))
    args = (_j(q), jk, jv, _j(tables), _j(dpos))
    _close(out, paged_attention(*args))
    _close(out, paged_attention_pallas(*args, interpret=True))

    q = rng.normal(size=(3, S, Hkv * gqa, hd)).astype(np.float32)
    qpos = starts[:, None] + np.arange(S, dtype=np.int32)[None, :]
    qpos = np.where(np.arange(S)[None, :] < lens[:, None], qpos, 0)
    qpos = qpos.astype(np.int32)
    out = port.paged_prefill_attention(_t(q), tk, tv, _t(tables), _t(qpos))
    args = (_j(q), jk, jv, _j(tables), _j(qpos))
    _close(out, paged_prefill_attention(*args))
    _close(out, paged_prefill_attention_pallas(*args, interpret=True))
