"""The port's keyed sampler (``ray_tpu_torch.ops.sampling``) against
``ray_tpu.ops.sampling``: the keyed uniform equals
``jax.random.uniform(fold_in(PRNGKey(seed), position))`` bit for bit, and
``sample_tokens`` picks the same ids on the same logits for greedy,
temperature, top-k, top-p and allow-masked rows."""
from __future__ import annotations

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def _cpu(jax_cpu):
    return jax_cpu


def test_keyed_uniform_is_jax_bitwise():
    import jax
    import jax.numpy as jnp

    from ray_tpu_torch.ops.sampling import keyed_uniform

    seeds = np.array([0, 1, 7, 12345, 2**31 - 1, 2**31, 2**31 + 5,
                      3_000_000_000, 2**32 - 1], np.uint32)
    positions = np.array([0, 1, 2, 15, 16, 511, 1023, 4096, 2**20], np.int32)
    s_grid, p_grid = (a.ravel() for a in np.meshgrid(seeds, positions))
    ref = jax.jit(jax.vmap(lambda s, p: jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(s), p), dtype=jnp.float32
    )))(jnp.asarray(s_grid), jnp.asarray(p_grid))
    got = keyed_uniform(torch.from_numpy(s_grid.astype(np.int64)),
                        torch.from_numpy(p_grid))
    np.testing.assert_array_equal(
        got.numpy().view(np.uint32), np.asarray(ref).view(np.uint32)
    )


def _controls(case, B, V, rng):
    seeds = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
    temp = np.zeros(B, np.float32)
    top_k = np.zeros(B, np.int32)
    top_p = np.ones(B, np.float32)
    mask = None
    if case == "temperature":
        temp[:] = [0.7, 1.0, 1.3, 0.0, 0.5, 2.0]
    elif case == "top_k":
        temp[:] = 0.9
        top_k[:] = [1, 2, 5, 0, -1, 40]
    elif case == "top_p":
        temp[:] = 1.1
        top_p[:] = [0.9, 0.5, 0.05, 1.0, 0.99, 0.3]
    elif case == "mask":
        temp[:] = [0.0, 0.8, 0.0, 1.0, 0.0, 0.6]
        words = (V + 31) // 32
        mask = rng.integers(0, 2**32, (B, words), dtype=np.uint64).astype(
            np.uint32)
        mask[2] = 0  # allows nothing: left unmasked
    return {"seeds": seeds, "temperature": temp, "top_k": top_k,
            "top_p": top_p, "mask": mask}


CASES = ["greedy", "temperature", "top_k", "top_p", "mask"]


def _staged(ctl, positions):
    """The port's sampling inputs as the engine stages them from host
    values: the controls, the keyed draw of each row at its sampled
    position, and the all-greedy flag."""
    from ray_tpu_torch.ops.sampling import keyed_uniform

    out = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32
                               else v)
           for k, v in ctl.items() if v is not None and k != "seeds"}
    out["uniform"] = keyed_uniform(ctl["seeds"], positions)
    out["all_greedy"] = bool(((ctl["temperature"] <= 0)
                              | (ctl["top_k"] == 1)).all())
    return out


@pytest.mark.parametrize("case", CASES)
def test_sample_tokens_matches_jax(case):
    import jax.numpy as jnp
    from ray_tpu.ops.sampling import sample_tokens

    from ray_tpu_torch.ops.sampling import sample_tokens as port

    B, V = 6, 300
    rng = np.random.default_rng(CASES.index(case))
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    logits[0, 17] = logits[0, 200] = logits[0].max() + 1  # greedy tie
    positions = rng.integers(0, 1000, B).astype(np.int32)
    ctl = _controls(case, B, V, rng)
    jax_sample = {k: jnp.asarray(v) for k, v in ctl.items() if v is not None}
    ref = np.asarray(sample_tokens(jnp.asarray(logits),
                                   jnp.asarray(positions), jax_sample))
    port_sample = _staged(ctl, positions)
    got = port(torch.from_numpy(logits), port_sample)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_staged_draws_match_keyed_sampling():
    """Draws staged for the sampling rows alone (a greedy row's draw left
    at 0, as the executor stages them) pick the ids of the full keyed
    draws, which are JAX's; an all-greedy step reads no control; nothing
    is read back from a device (a tensor off the CPU is refused)."""
    import jax.numpy as jnp
    from ray_tpu.ops.sampling import sample_tokens as jax_sample_tokens

    from ray_tpu_torch.ops.sampling import (
        greedy_rows,
        keyed_uniform,
        sample_tokens,
    )

    B, V = 6, 300
    rng = np.random.default_rng(7)
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    positions = rng.integers(0, 1000, B).astype(np.int32)
    ctl = _controls("mask", B, V, rng)
    want = np.asarray(jax_sample_tokens(
        jnp.asarray(logits), jnp.asarray(positions),
        {k: jnp.asarray(v) for k, v in ctl.items()}))
    full = _staged(ctl, positions)
    rows = ~greedy_rows(full).numpy()
    assert 0 < rows.sum() < B
    part = dict(full, uniform=torch.zeros(B))
    part["uniform"][rows] = keyed_uniform(ctl["seeds"][rows],
                                          positions[rows])
    for staged in (full, part):
        got = sample_tokens(torch.from_numpy(logits), staged)
        np.testing.assert_array_equal(got.numpy(), want)
    greedy = sample_tokens(torch.from_numpy(logits), {"all_greedy": True})
    assert torch.equal(greedy, torch.from_numpy(logits).argmax(-1).to(
        torch.int32))
    meta = torch.zeros(B, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="host values"):
        keyed_uniform(meta, meta)
    with pytest.raises(ValueError, match="logits' device"):
        sample_tokens(torch.from_numpy(logits).to("meta"), full)
