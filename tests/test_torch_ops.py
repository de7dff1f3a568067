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
