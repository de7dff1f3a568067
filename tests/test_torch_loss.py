"""``ray_tpu_torch.ops.loss.fused_lm_head_loss`` against
``ray_tpu.ops.loss.fused_lm_head_loss`` on the same numpy inputs: the
loss, dx and dW, with and without a mask, with N not a multiple of the
chunk, and a scaled upstream gradient. f32; tolerance 1e-5 (f32 sums in
another order)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu(jax_cpu):
    return jax_cpu


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("chunk", [16, 4096])
def test_fused_loss_matches_jax(masked, chunk):
    import jax
    import jax.numpy as jnp
    from ray_tpu.ops.loss import fused_lm_head_loss as jax_loss

    from ray_tpu_torch.ops.loss import fused_lm_head_loss

    rng = np.random.default_rng(chunk + masked)
    N, D, V = 50, 16, 97
    x = rng.standard_normal((N, D)).astype(np.float32)
    w = (0.1 * rng.standard_normal((V, D))).astype(np.float32)
    t = rng.integers(0, V, N).astype(np.int32)
    m = (rng.random(N) > 0.2).astype(np.float32) if masked else None
    up = 1.7  # upstream gradient

    def f(x, w):
        return up * jax_loss(x, w, jnp.asarray(t),
                             None if m is None else jnp.asarray(m), chunk)

    want, (wdx, wdw) = jax.value_and_grad(f, argnums=(0, 1))(x, w)
    tx, tw = (torch.tensor(a, requires_grad=True) for a in (x, w))
    got = up * fused_lm_head_loss(
        tx, tw, torch.from_numpy(t),
        None if m is None else torch.from_numpy(m), chunk=chunk)
    got.backward()
    assert got.dtype == torch.float32
    assert abs(got.item() - float(want)) <= TOL
    assert np.abs(tx.grad.numpy() - np.asarray(wdx)).max() <= TOL
    assert np.abs(tw.grad.numpy() - np.asarray(wdw)).max() <= TOL


def test_fused_loss_matches_materialized_logits():
    """Against plain cross-entropy over the full logits, in torch."""
    from ray_tpu_torch.ops.loss import fused_lm_head_loss

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(37, 8, generator=gen, requires_grad=True)
    w = torch.randn(29, 8, generator=gen, requires_grad=True)
    t = torch.randint(0, 29, (37,), generator=gen)
    loss = fused_lm_head_loss(x, w, t, chunk=10)
    gx, gw = torch.autograd.grad(loss, (x, w))
    ref = torch.nn.functional.cross_entropy(x @ w.t(), t)
    rx, rw = torch.autograd.grad(ref, (x, w))
    assert abs(loss.item() - ref.item()) <= TOL
    assert (gx - rx).abs().max().item() <= TOL
    assert (gw - rw).abs().max().item() <= TOL
