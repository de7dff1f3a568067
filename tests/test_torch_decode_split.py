"""The summation order of the split-K decode kernel (B4,
``ray_tpu_torch/csrc/paged_decode.cu``) against the JAX package's
``paged_attention_pallas`` (Pallas in interpret mode), on the CPU.

The kernel cannot run here, so this file emulates its order in plain
PyTorch: each sequence's context split into ``nsplit`` ranges of table
entries; inside a range, four warps each score eight tokens a step (head
dim 64: eight lanes a token, four lane groups of two tokens) under a
running max of their own, with the TPU's bf16 rounding of ``s - m`` and
of ``exp2``; the warps merged, then the ranges combined in f32 in rank
order. Held against the reference at
1, 2, 4 and 8 splits within the kernel's bf16 bar (1e-2 + 1.6e-2 ·
|reference|, ``tests/test_torch_kernels.py``). Also the wrapper's choice
of ``nsplit``, from shapes only. Inputs from a numpy seed; B and kv heads
stay small because the interpret-mode grid runs step by step.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

ATOL, RTOL = 1e-2, 1.6e-2
NEG = -1e30
WARPS, STEP = 4, 8      # B4 at head dim 64: 4 warps x 8 tokens a step
B, HKV, G, HD, BS, NB = 2, 1, 2, 64, 16, 64
LENGTHS = [1024, 700]


@pytest.fixture(autouse=True)
def _cpu(jax_cpu):
    return jax_cpu


@pytest.fixture(scope="module")
def case(jax_cpu):
    """bf16 inputs (numpy seed) and the Pallas kernel's output on them."""
    import jax.numpy as jnp
    from ray_tpu.ops.paged_attention import paged_attention_pallas

    rng = np.random.default_rng(0)
    perm = rng.permutation(B * NB) + 1
    tables = np.zeros((B, NB), np.int32)
    for b, n in enumerate(LENGTHS):
        used = -(-n // BS)
        tables[b, :used] = perm[b * NB:b * NB + used]
    shape = (1 + B * NB, BS, HKV, HD)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((B, HKV * G, HD)).astype(np.float32)
    pos = np.asarray(LENGTHS, np.int32) - 1
    want = paged_attention_pallas(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        jnp.asarray(tables), jnp.asarray(pos), interpret=True)
    ref = torch.from_numpy(np.array(want.astype(jnp.float32)))
    return {"q": torch.from_numpy(q).bfloat16(),
            "k": torch.from_numpy(k).bfloat16(),
            "v": torch.from_numpy(v).bfloat16(),
            "tables": torch.from_numpy(tables), "pos": torch.from_numpy(pos),
            "ref": ref}


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _merge(m, l, acc):
    """f32 combine of partials along dim 0: m [n, G], l [n, G], acc
    [n, G, hd] -> (m, l, acc) of the whole."""
    mc = m.max(dim=0).values
    f = torch.exp2(m - mc)
    return mc, (l * f).sum(0), (acc * f[..., None]).sum(0)


def _range_partial(s, vals, lo, hi):
    """One block's (m, l, acc) over tokens lo..hi: scores s [G, T] f32,
    values [T, hd] f32. Token lo + i goes to warp (i % 32) // 8 in step
    i // 32; each warp's running max moves once a step, and its p are
    rounded against the max of their own step."""
    per_step = WARPS * STEP
    n = hi - lo + 1
    steps = -(-n // per_step)
    sp = torch.full((s.shape[0], steps * per_step), NEG)
    sp[:, :n] = s[:, lo:hi + 1]
    vp = torch.zeros(steps * per_step, vals.shape[1])
    vp[:n] = vals[lo:hi + 1]
    valid = torch.arange(steps * per_step) < n
    sp = sp.reshape(-1, steps, WARPS, STEP)
    valid = valid.reshape(steps, WARPS, STEP)
    m_step = torch.cummax(sp.amax(-1), dim=1).values      # [G, steps, W]
    p = _bf16(torch.exp2(_bf16(sp - m_step[..., None])))
    p = torch.where(valid, p, torch.zeros(()))
    m_w = m_step[:, -1]                                     # [G, W]
    w = p * torch.exp2(m_step - m_w[:, None])[..., None]    # alpha chain
    l_w = w.sum((1, 3))
    acc_w = torch.einsum("gswj,swjd->gwd", w,
                         vp.reshape(steps, WARPS, STEP, -1))
    return _merge(m_w.T, l_w.T, acc_w.transpose(0, 1))


def split_k_decode(q, k, v, tables, pos, nsplit, scale=None):
    """B4's order in plain PyTorch: q [B, Hq, hd] and the pool in bf16,
    ranges of ceil(NB / nsplit) table entries, bf16 output."""
    Bq, Hq, hd = q.shape
    _, bs, Hkv, _ = k.shape
    nb = tables.shape[1]
    g = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    c = _bf16(torch.tensor(scale * math.log2(math.e)))
    qs = _bf16(q.float() * c)
    span = -(-nb // nsplit) * bs
    out = torch.empty(Bq, Hq, hd)
    for b in range(Bq):
        t_end = min(int(pos[b]), nb * bs - 1)
        t = torch.arange(t_end + 1)
        blk, slot = tables[b, t // bs].long(), t % bs
        for h in range(Hkv):
            keys, vals = k[blk, slot, h].float(), v[blk, slot, h].float()
            s = qs[b, h * g:(h + 1) * g] @ keys.T
            parts = [_range_partial(s, vals, lo, min(t_end, lo + span - 1))
                     for lo in range(0, t_end + 1, span)]
            _, l, acc = _merge(*(torch.stack(x) for x in zip(*parts)))
            l = torch.where(l == 0, 1.0, l)
            out[b, h * g:(h + 1) * g] = acc / l[:, None]
    return out.bfloat16()


@pytest.mark.parametrize("nsplit", [1, 2, 4, 8])
def test_split_k_order_matches_pallas(case, nsplit):
    got = split_k_decode(case["q"], case["k"], case["v"], case["tables"],
                         case["pos"], nsplit).float()
    want = case["ref"]
    assert got.shape == want.shape
    diff = (got - want).abs()
    assert bool((diff <= ATOL + RTOL * want.abs()).all()), diff.max()


def test_split_k_order_matches_plain_version(case):
    """At 8 splits, also within the bar of the port's plain decode (the
    one-shot softmax the kernel is held against on the card)."""
    from ray_tpu_torch.ops.kv_cache import paged_attention

    args = (case["q"], case["k"], case["v"], case["tables"], case["pos"])
    got = split_k_decode(*args, 8).float()
    want = paged_attention(*args).float()
    diff = (got - want).abs()
    assert bool((diff <= ATOL + RTOL * want.abs()).all()), diff.max()


# on an H100 SXM (132 SMs) unless stated; the PCIe card has 114
@pytest.mark.parametrize("B_,Hkv,NB_,bs,sms,want", [
    (8, 12, 64, 16, 132, 8),   # the engine's decode: 768 blocks, 128 tokens
    (1, 12, 256, 16, 132, 8),  # one long sequence: at most a portable cluster
    (32, 12, 64, 16, 132, 2),  # 768 blocks at 2 splits
    (64, 12, 64, 16, 132, 1),  # enough blocks unsplit
    (8, 12, 4, 16, 132, 1),    # 64 tokens: no range below 64 tokens
    (2, 2, 3, 128, 132, 2),    # at most one table entry a range
    (40, 12, 64, 16, 132, 2),  # 480 blocks, short of 4 an SM: split
    (40, 12, 64, 16, 114, 1),  # the same shapes fill 114 SMs unsplit
])
def test_decode_splits_from_shapes(B_, Hkv, NB_, bs, sms, want):
    from ray_tpu_torch.ops.paged_attention import (
        DECODE_MAX_SPLITS,
        decode_splits,
    )

    n = decode_splits(B_, Hkv, NB_, bs, sms)
    assert n == want
    assert 1 <= n <= min(DECODE_MAX_SPLITS, NB_)
