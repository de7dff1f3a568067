"""The port's GPT serving paths (``ray_tpu_torch.models.gpt``) against
``ray_tpu.models.gpt`` on the same converted weights: fresh prefill,
chunked prefill at ragged true-position starts and a decode step — logits
and the written K/V pool — with the JAX side under both its XLA and its
Pallas (interpret) attention backends. Tiny f32 config; tolerance 1e-4
(f32 through two layers, sums in different orders)."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

TOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu(jax_cpu):
    return jax_cpu


def _configs(jax_backend):
    import jax.numpy as jnp
    from ray_tpu.models.gpt import GPTConfig as JaxGPTConfig

    from ray_tpu_torch.models.gpt import GPTConfig

    jcfg = dataclasses.replace(JaxGPTConfig.tiny(), dtype=jnp.float32,
                               attention="xla", attention_backend=jax_backend)
    tcfg = dataclasses.replace(GPTConfig.tiny(), dtype=torch.float32,
                               attention_backend="torch")
    return jcfg, tcfg


def _jax_params(jcfg, seed=0):
    import jax
    from ray_tpu.models.gpt import gpt_init

    return jax.tree.map(np.asarray, gpt_init(jax.random.PRNGKey(seed), jcfg))


def _port_model(tree, tcfg):
    from ray_tpu_torch.convert import gpt_params_from_numpy
    from ray_tpu_torch.models.gpt import GPT

    model = GPT(tcfg, device="cpu")
    model.load_state_dict(gpt_params_from_numpy(tree, tcfg))
    return model


def _close(port, ref, tol=TOL):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    err = float(np.max(np.abs(port - np.asarray(ref))))
    assert err <= tol, err


def test_convert_round_trip():
    from ray_tpu_torch.convert import gpt_params_to_numpy

    jcfg, tcfg = _configs("xla")
    tree = _jax_params(jcfg, seed=3)
    model = _port_model(tree, tcfg)
    back = gpt_params_to_numpy(model.state_dict(), tcfg)
    for name in ("wte", "wpe", "ln_f_scale", "ln_f_bias"):
        np.testing.assert_array_equal(back[name], tree[name])
    assert set(back["blocks"]) == set(tree["blocks"])
    for name, arr in tree["blocks"].items():
        np.testing.assert_array_equal(back["blocks"][name], arr)


@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
def test_prefill_chunk_decode_match_jax(jax_backend):
    import jax.numpy as jnp
    from ray_tpu.models.gpt import gpt_decode_step, gpt_prefill

    jcfg, tcfg = _configs(jax_backend)
    tree = _jax_params(jcfg)
    model = _port_model(tree, tcfg)
    rng = np.random.default_rng(5)
    B, S1, S2, bs, NB = 2, 16, 8, 8, 5
    num_blocks = 1 + B * NB
    tables = (1 + rng.permutation(B * NB)).reshape(B, NB).astype(np.int32)
    shape = (jcfg.n_layer, num_blocks, bs, jcfg.n_head, jcfg.head_dim)
    jk = jv = jnp.zeros(shape, jnp.float32)
    tk, tv = torch.zeros(shape), torch.zeros(shape)

    def both(jax_out, port_out):
        (jl, jk2, jv2), (tl, tk2, tv2) = jax_out, port_out
        _close(tl, jl)
        _close(tk2[:, 1:], np.asarray(jk2)[:, 1:])  # block 0: padding sink
        _close(tv2[:, 1:], np.asarray(jv2)[:, 1:])
        return jk2, jv2

    # fresh prefill, ragged lengths
    toks = rng.integers(0, jcfg.vocab_size, (B, S1)).astype(np.int32)
    lens = np.array([16, 11], np.int32)
    jk, jv = both(
        gpt_prefill(tree, jk, jv, jnp.asarray(toks), jnp.asarray(lens),
                    jnp.asarray(tables), jcfg),
        model.prefill(tk, tv, torch.from_numpy(toks), torch.from_numpy(lens),
                      torch.from_numpy(tables)),
    )
    # chunked prefill at ragged true-position starts
    toks2 = rng.integers(0, jcfg.vocab_size, (B, S2)).astype(np.int32)
    lens2 = np.array([8, 5], np.int32)
    jk, jv = both(
        gpt_prefill(tree, jk, jv, jnp.asarray(toks2), jnp.asarray(lens2),
                    jnp.asarray(tables), jcfg, start=jnp.asarray(lens)),
        model.prefill(tk, tv, torch.from_numpy(toks2),
                      torch.from_numpy(lens2), torch.from_numpy(tables),
                      start=torch.from_numpy(lens)),
    )
    # one decode step
    step = rng.integers(0, jcfg.vocab_size, B).astype(np.int32)
    pos = (lens + lens2).astype(np.int32)
    both(
        gpt_decode_step(tree, jk, jv, jnp.asarray(step), jnp.asarray(pos),
                        jnp.asarray(tables), jcfg),
        model.decode_step(tk, tv, torch.from_numpy(step),
                          torch.from_numpy(pos), torch.from_numpy(tables)),
    )


def test_seeded_init_is_deterministic():
    from ray_tpu_torch.models.gpt import gpt_init

    _, tcfg = _configs("xla")
    a = gpt_init(tcfg, seed=4, device="cpu").state_dict()
    b = gpt_init(tcfg, seed=4, device="cpu").state_dict()
    c = gpt_init(tcfg, seed=5, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["wte"], c["wte"])
    assert a["blocks.0.ln1_scale"].dtype == torch.float32
