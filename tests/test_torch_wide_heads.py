"""The column-chunked order of the kernels at head dims above 256, on the
CPU. The CUDA kernels cannot run here, so this file emulates their order
in plain PyTorch and holds it against the plain versions the kernels are
held against on the card (and, for one case each, against the JAX
package's Pallas kernels in interpret mode):

- B1-B3 (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``): tiles of 32 rows
  at D 256; output chunk c (columns 256c .. 256c + 255) is its own block,
  whose scores (and dP) sum over the whole head in slices of 256; the
  forward's online softmax runs over 32-key tiles with the TPU's bf16
  rounding of ``s - m`` and ``exp2``; every chunk reaches the same m and
  l, and chunk 0's LSE is the one written.
- B4/B5 (``csrc/paged_common.cuh`` ``attend_wide``): 16 tokens a step,
  gathered through the block table, scores over the whole head in slices
  of 256, the online softmax per chunk; B4 splits the table into ranges
  and combines them in f32 per chunk.

Bars: f32 1e-5; bf16 1e-2 + 2 bf16 ulps of the value, the bars of
``tests/test_torch_kernels.py``. Inputs from numpy seeds, small shapes.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

COLS, TILE, KEYS = 256, 32, 16
NEG = -1e30
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1.6e-2)}


@pytest.fixture(autouse=True)
def _cpu(jax_cpu):
    return jax_cpu


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= atol + rtol * want.float().abs()).all()), diff.max()


def _r(x, dtype):
    """Round through ``dtype`` (identity for f32)."""
    return x.to(dtype).float()


def _sliced(a, b):
    """``a @ b^T`` summed over slices of COLS columns, in order."""
    D = a.shape[-1]
    out = 0
    for c0 in range(0, D, COLS):
        out = out + a[..., c0:c0 + COLS] @ b[..., c0:c0 + COLS].transpose(
            -1, -2)
    return out


def _online(s, v, step, dtype):
    """(m, l, acc) of an online base-2 softmax over the last axis of the
    scores s [..., T] (masked entries NEG) in steps of ``step``, p rounded
    through ``dtype``; acc = sum p v, v [..., T, Dv]."""
    m = torch.full(s.shape[:-1], NEG)
    l = torch.zeros(s.shape[:-1])
    acc = torch.zeros(*s.shape[:-1], v.shape[-1])
    for t0 in range(0, s.shape[-1], step):
        blk = s[..., t0:t0 + step]
        m_new = torch.maximum(m, blk.amax(-1))
        p = _r(torch.exp2(_r(blk - m_new[..., None], dtype)), dtype)
        alpha = torch.exp2(m - m_new)
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + p @ v[..., t0:t0 + step, :]
        m = m_new
    return m, l, acc


def chunked_flash_forward(q, k, v, *, causal, scale):
    """B1's order above D 256: (o, base-2 lse), one chunk at a time."""
    dtype, (B, H, S, D) = q.dtype, q.shape
    c = _r(torch.tensor(scale * math.log2(math.e)), dtype)
    qs, kf, vf = _r(q.float() * c, dtype), k.float(), v.float()
    mask = torch.ones(S, S, dtype=torch.bool).tril() if causal else None
    o, stats = torch.empty(B, H, S, D), []
    for c0 in range(0, D, COLS):
        s = _sliced(qs, kf)
        if causal:
            s = s.masked_fill(~mask, NEG)
        m, l, acc = _online(s, vf[..., c0:c0 + COLS], TILE, dtype)
        stats.append((m, l))
        l = torch.where(l == 0, torch.ones_like(l), l)
        o[..., c0:c0 + COLS] = acc / l[..., None]
    for m, l in stats[1:]:  # every chunk reaches chunk 0's m and l
        assert torch.equal(m, stats[0][0]) and torch.equal(l, stats[0][1])
    m, l = stats[0]
    l = torch.where(l == 0, torch.ones_like(l), l)
    return o.to(dtype), m + torch.log2(l)


def chunked_flash_backward(q, k, v, o, lse, do, *, causal, scale):
    """B2's and B3's order above D 256: (dq, dk, dv), one chunk at a time;
    p and ds recomputed in each chunk from the sliced s and dP."""
    dtype, (B, H, S, D) = q.dtype, q.shape
    c = _r(torch.tensor(scale * math.log2(math.e)), dtype)
    qs = _r(q.float() * c, dtype)
    kf, vf, dof = k.float(), v.float(), do.float()
    delta = (dof * o.float()).sum(-1)
    grads = [torch.empty(B, H, S, D) for _ in range(3)]
    for c0 in range(0, D, COLS):
        cols = slice(c0, c0 + COLS)
        s, dp = _sliced(qs, kf), _sliced(dof, vf)
        p = _r(torch.exp2(_r(s - lse[..., None], dtype)), dtype)
        if causal:
            p = p.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), 0.0)
        ds = _r(p * (dp - delta[..., None]) * math.log(2.0), dtype)
        grads[0][..., cols] = _r(ds @ kf[..., cols], dtype) * c
        grads[1][..., cols] = ds.transpose(-1, -2) @ qs[..., cols]
        grads[2][..., cols] = p.transpose(-1, -2) @ dof[..., cols]
    return tuple(g.to(dtype) for g in grads)


def _flash_inputs(D, dtype, S=70, seed=0):
    rng = np.random.default_rng(seed + D)
    return tuple(torch.from_numpy(rng.standard_normal((1, 2, S, D))
                                  .astype(np.float32)).to(dtype)
                 for _ in range(4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,causal", [(264, True), (320, False),
                                      (512, True)])
def test_chunked_flash_order_matches_plain(dtype, D, causal):
    from ray_tpu_torch.ops import attention as at

    q, k, v, do = _flash_inputs(D, dtype)
    kw = dict(causal=causal, scale=D ** -0.5)
    o, lse = chunked_flash_forward(q, k, v, **kw)
    o_ref, lse_ref = at.flash_forward_reference(q, k, v, **kw)
    _close(o, o_ref, dtype)
    _close(lse, lse_ref, dtype)
    grads = chunked_flash_backward(q, k, v, o_ref, lse_ref, do, **kw)
    refs = at.flash_backward_reference(q, k, v, o_ref, lse_ref, do, **kw)
    for got, want in zip(grads, refs):
        _close(got, want, dtype)


def test_chunked_flash_order_matches_pallas():
    """D 264, f32: the chunked forward against the Pallas forward kernel
    in interpret mode (``flash_attention`` on the CPU)."""
    import jax.numpy as jnp
    from ray_tpu.ops.attention import flash_attention

    q, k, v, _ = _flash_inputs(264, torch.float32, S=64)
    o, _ = chunked_flash_forward(q, k, v, causal=True, scale=264 ** -0.5)
    want = flash_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                           causal=True, block_q=32, block_kv=32)
    _close(o, torch.from_numpy(np.array(want)), torch.float32)


# ---- B4 / B5 above 256: attend_wide


def _paged_case(hd, dtype, kind, lengths, Hkv, G, bs, seed):
    """A shuffled pool of just the blocks each sequence needs, held at the
    engine's padded width (``pool_head_dim``), quantized with ``kind``."""
    from ray_tpu_torch.ops.kv_cache import pad_head, pool_head_dim
    from ray_tpu_torch.ops.quantization import QuantizedKV, quantize_kv

    rng = np.random.default_rng(seed)
    used = [-(-n // bs) for n in lengths]
    NB = max(used)
    perm = rng.permutation(len(lengths) * NB) + 1
    tables = torch.zeros(len(lengths), NB, dtype=torch.int32)
    for b, n in enumerate(used):
        tables[b, :n] = torch.from_numpy(perm[b * NB:b * NB + n])
    width = pool_head_dim(hd, kind is not None)
    k, v = (pad_head(torch.from_numpy(rng.standard_normal(
        (1 + len(lengths) * NB, bs, Hkv, hd)).astype(np.float32)), width)
        for _ in range(2))
    if kind:
        k, v = (QuantizedKV(*quantize_kv(x, kind)) for x in (k, v))
    else:
        k, v = k.to(dtype), v.to(dtype)
    return rng, k, v, tables


def _gathered(layer, tables, b, kvh, T):
    """Tokens 0..T-1 of sequence b's kv head kvh as f32 rows (quantized:
    code * scale), in the pool's padded width."""
    from ray_tpu_torch.ops.kv_cache import gather_kv

    keys, _ = gather_kv(layer, layer, tables[b:b + 1])
    return keys[0, :T, kvh].float()


def wide_paged(q, k, v, tables, pos, *, nsplit=1, window=None):
    """attend_wide's order: q [B, S, Hq, hd] at true positions pos [B, S];
    each row attends t <= pos (and t > pos - window); the table's tokens
    in nsplit ranges (B4's split-K, combined in f32 per chunk)."""
    dtype = torch.float32 if hasattr(k, "scale") else q.dtype
    B, S, Hq, hd = q.shape
    bs, Hkv, width = k.shape[1], k.shape[2], k.shape[3]
    G = Hq // Hkv
    c = _r(torch.tensor(hd ** -0.5 * math.log2(math.e)), q.dtype)
    qs = torch.nn.functional.pad(_r(q.float() * c, q.dtype),
                                 (0, width - hd))
    NB = tables.shape[1]
    span = -(-NB // nsplit) * bs
    out = torch.empty(B, S, Hq, hd)
    for b in range(B):
        T = NB * bs
        t = torch.arange(T)
        p = pos[b].long()[:, None]
        vis = (t[None] <= p) & (t[None] <= T - 1)
        if window is not None:
            vis &= t[None] > p - window
        for h in range(Hkv):
            keys = _gathered(k, tables, b, h, T)
            vals = _gathered(v, tables, b, h, T)
            rows = qs[b, :, h * G:(h + 1) * G]            # [S, G, width]
            for c0 in range(0, width, COLS):
                parts = []
                for lo in range(0, T, span):
                    sl = slice(lo, lo + span)
                    s = _sliced(rows, keys[sl][None].expand(S, -1, -1))
                    s = s.masked_fill(~vis[:, None, sl], NEG)
                    parts.append(_online(s, vals[sl, c0:c0 + COLS][None]
                                         .expand(S, -1, -1), KEYS, dtype))
                m = torch.stack([x[0] for x in parts])
                mc = m.amax(0)
                f = torch.exp2(m - mc)
                lc = (torch.stack([x[1] for x in parts]) * f).sum(0)
                acc = (torch.stack([x[2] for x in parts])
                       * f[..., None]).sum(0)
                lc = torch.where(lc == 0, torch.ones_like(lc), lc)
                o = acc / lc[..., None]
                n = min(COLS, hd - c0)
                if n > 0:
                    out[b, :, h * G:(h + 1) * G, c0:c0 + n] = o[..., :n]
    return out.to(q.dtype)


@pytest.mark.parametrize("kind", [None, "int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,G,nsplit", [(288, 3, 2), (512, 1, 3)])
def test_wide_paged_decode_order_matches_plain(kind, dtype, hd, G, nsplit):
    from ray_tpu_torch.ops.kv_cache import paged_attention

    lengths = [40, 7, 70]
    rng, k, v, tables = _paged_case(hd, dtype, kind, lengths, 2, G, 16,
                                    seed=hd + G)
    q = torch.from_numpy(rng.standard_normal((3, 2 * G, hd))
                         .astype(np.float32)).to(dtype)
    pos = torch.tensor([n - 1 for n in lengths], dtype=torch.int32)
    got = wide_paged(q[:, None], k, v, tables, pos[:, None], nsplit=nsplit)
    _close(got[:, 0], paged_attention(q, k, v, tables, pos), dtype)


@pytest.mark.parametrize("kind", [None, "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,window", [(288, None), (512, 20)])
def test_wide_paged_prefill_order_matches_plain(kind, dtype, hd, window):
    from ray_tpu_torch.ops.kv_cache import paged_prefill_attention

    starts, S = [0, 9], 24
    rng, k, v, tables = _paged_case(hd, dtype, kind, [s + S for s in starts],
                                    2, 3, 8, seed=hd)
    q = torch.from_numpy(rng.standard_normal((2, S, 6, hd))
                         .astype(np.float32)).to(dtype)
    pos = (torch.tensor(starts)[:, None] + torch.arange(S)).to(torch.int32)
    got = wide_paged(q, k, v, tables, pos, window=window)
    _close(got, paged_prefill_attention(q, k, v, tables, pos, window=window),
           dtype)


def test_wide_paged_decode_order_matches_pallas():
    """hd 288, f32, G 3, 2 ranges: against the Pallas decode kernel in
    interpret mode."""
    import jax.numpy as jnp
    from ray_tpu.ops.paged_attention import paged_attention_pallas

    lengths = [40, 17]
    rng, k, v, tables = _paged_case(288, torch.float32, None, lengths, 1, 3,
                                    16, seed=1)
    q = torch.from_numpy(rng.standard_normal((2, 3, 288)).astype(np.float32))
    pos = torch.tensor([n - 1 for n in lengths], dtype=torch.int32)
    got = wide_paged(q[:, None], k, v, tables, pos[:, None], nsplit=2)[:, 0]
    want = paged_attention_pallas(
        *(jnp.asarray(t.numpy()) for t in (q, k, v, tables, pos)),
        interpret=True)
    _close(got, torch.from_numpy(np.array(want)), torch.float32)
