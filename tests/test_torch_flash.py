"""The port's flash attention (``ray_tpu_torch.ops.attention``, plain
backend) against ``ray_tpu.ops.attention.flash_attention`` (Pallas in
interpret mode) on the same numpy inputs: the output, and dq/dk/dv from
``torch.autograd`` against ``jax.grad`` of the same weighted sum.

JAX block 32 at S = 160 gives 5 kv blocks, so JAX takes its two-pass
backward (more than 4); block 64 at S = 128 gives 2, its fused path; S = 96
with block 64 clamps the block to 32. f32 bars as in
``tests/test_ops.py``: out 2e-5, grads 5e-4."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

OUT_TOL, GRAD_TOL = 2e-5, 5e-4


@pytest.fixture(autouse=True)
def _cpu(jax_cpu):
    return jax_cpu


def _inputs(seed, B, H, Hkv, S, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal((B, H, S, D)).astype(np.float32)
    return q, k, v, g


def _jax(q, k, v, g, causal, block):
    import jax
    import jax.numpy as jnp
    from ray_tpu.ops.attention import flash_attention

    def f(q, k, v):
        return flash_attention(q, k, v, causal=causal, block_q=block,
                               block_kv=block)

    out = f(q, k, v)
    grads = jax.grad(lambda *a: jnp.sum(f(*a) * g), argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), [np.asarray(x) for x in grads]


def _port(q, k, v, g, causal):
    from ray_tpu_torch.ops.attention import flash_attention

    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = flash_attention(*leaves, causal=causal, backend="torch")
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize(
    "B,H,Hkv,S,D,block,causal",
    [
        (1, 2, 2, 160, 32, 32, True),    # 5 kv blocks: JAX two-pass backward
        (1, 2, 2, 128, 32, 64, True),    # 2 kv blocks: JAX fused backward
        (1, 2, 2, 128, 32, 64, False),   # full attention
        (2, 8, 2, 64, 32, 64, True),     # GQA, 4 query heads per kv head
        (1, 2, 2, 96, 32, 64, True),     # JAX clamps its block to 32
    ],
)
def test_flash_attention_matches_jax(B, H, Hkv, S, D, block, causal):
    q, k, v, g = _inputs(S + H, B, H, Hkv, S, D)
    want_out, want_grads = _jax(q, k, v, g, causal, block)
    got_out, got_grads = _port(q, k, v, g, causal)
    assert np.abs(got_out - want_out).max() <= OUT_TOL
    for got, want in zip(got_grads, want_grads):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= GRAD_TOL


def test_flash_reference_bf16_matches_jax():
    """bf16 inputs: the plain forward keeps the TPU kernel's rounding points
    (bf16 exp2 and probabilities), so it lands within one bf16 ulp of the
    output's magnitude (2^-7 relative, outputs here are below 4) of JAX."""
    import jax.numpy as jnp
    from ray_tpu.ops.attention import flash_attention

    from ray_tpu_torch.ops.attention import flash_forward_reference

    q, k, v, _ = _inputs(7, 1, 2, 2, 128, 32)
    want = flash_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                           causal=True, block_q=128, block_kv=128)
    got, lse = flash_forward_reference(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
        causal=True, scale=1 / math.sqrt(32))
    assert got.dtype == torch.bfloat16 and lse.dtype == torch.float32
    err = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
    assert err.max() <= 4 * 2 ** -7


@pytest.mark.parametrize(
    "S,D,block,causal,q_mult",
    [
        (160, 32, 32, True, 1),    # 5 kv blocks: JAX two-pass backward
        (128, 32, 64, True, 1),    # 2 kv blocks: JAX fused backward
        (128, 32, 64, False, 1),   # full attention
        (160, 64, 32, True, 1),    # GPT-2's head dim
        (160, 32, 32, True, 8),    # large scores: most p underflow
    ],
)
def test_flash_backward_reference_bf16_matches_jax(S, D, block, causal,
                                                    q_mult):
    """bf16 inputs: the plain backward (B2 and B3's plain versions) against
    the Pallas backward in interpret mode, both fed the same saved o and
    lse. Both keep the TPU kernels' rounding points (pre-scaled q, bf16
    ``s - lse``, ``exp2``, p and ds), but XLA-CPU's bf16 ``exp2`` is up to
    14 bf16 ulps from the exact value where ``torch.exp2`` is within half
    an ulp, so the two p differ by a few ulps and the gradients by up to
    about 2.4 bf16 ulps (1.84% of the largest magnitude measured): each
    gradient within 4 * 2^-7 of its largest |JAX| entry."""
    import jax.numpy as jnp
    from ray_tpu.ops.attention import _flash_backward

    from ray_tpu_torch.ops.attention import (
        flash_backward_reference,
        flash_forward_reference,
    )

    q, k, v, g = _inputs(S + block, 1, 2, 2, S, D)
    q, k, v, g = (torch.from_numpy(x).bfloat16() for x in (q_mult * q, k, v, g))
    scale = 1 / math.sqrt(D)
    o, lse = flash_forward_reference(q, k, v, causal=causal, scale=scale)
    got = flash_backward_reference(q, k, v, o, lse, g, causal=causal,
                                   scale=scale)

    def to_jax(t):
        return jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16
                           if t.dtype == torch.bfloat16 else jnp.float32)

    want = _flash_backward(*(to_jax(t) for t in (q, k, v, o, lse, g)),
                           causal=causal, scale=scale, block_q=block,
                           block_kv=block, interpret=True)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
        b = np.asarray(b.astype(jnp.float32))
        err = np.abs(a.float().numpy() - b).max()
        assert err <= 4 * 2 ** -7 * np.abs(b).max(), (name, err)


def test_flash_lse_is_base2_logsumexp():
    from ray_tpu_torch.ops.attention import flash_forward_reference

    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(3, 1, 2, 2, 40, 32))
    scale = 1 / math.sqrt(32)
    _, lse = flash_forward_reference(q, k, v, causal=True, scale=scale)
    s = (q @ k.transpose(-1, -2)) * scale
    s = s.masked_fill(~torch.ones(40, 40, dtype=torch.bool).tril(), -1e30)
    want = torch.logsumexp(s, dim=-1) / math.log(2)
    assert (lse - want).abs().max().item() <= 1e-5


def test_flash_wrappers_refuse_cpu_tensors():
    from ray_tpu_torch.ops import attention as at

    x = torch.zeros(1, 2, 8, 32)
    lse = torch.zeros(1, 2, 8)
    before = dict(at.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        at.flash_forward_cuda(x, x, x, causal=True, scale=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        at.flash_backward_cuda(x, x, x, x, lse, x, causal=True, scale=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        at.flash_attention(x, x, x, backend="cuda")
    assert at.LAUNCHES == before
