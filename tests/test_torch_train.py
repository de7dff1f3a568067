"""The port's GPT training path against the JAX package on the same
weights and tokens: ``GPT.loss`` and every parameter's gradient against
``jax.value_and_grad(gpt_loss)``, one AdamW step against ``optax.adamw``,
and three steps of ``run_gpt_bench`` against the JAX train step. Tiny f32
config; tolerances: loss 1e-5, gradients 1e-4 (f32 through two layers,
sums in other orders), the optimizer step 1e-6, bench losses 1e-4."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

B, S = 2, 32


@pytest.fixture(autouse=True)
def _cpu(jax_cpu):
    return jax_cpu


def _configs(**kw):
    import jax.numpy as jnp
    from ray_tpu.models.gpt import GPTConfig as JaxGPTConfig

    from ray_tpu_torch.models.gpt import GPTConfig

    jcfg = dataclasses.replace(JaxGPTConfig.tiny(), dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(GPTConfig.tiny(), dtype=torch.float32, **kw)
    return jcfg, tcfg


def _train_model(tree, tcfg):
    from ray_tpu_torch.convert import gpt_params_from_numpy
    from ray_tpu_torch.models.gpt import GPT

    model = GPT(tcfg, "cpu", train=True)
    model.load_state_dict(gpt_params_from_numpy(tree, tcfg))
    return model


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.mark.parametrize("attention,fused_loss,remat,masked", [
    ("flash", True, False, False),
    ("xla", True, False, True),
    ("flash", False, False, True),
    ("xla", False, False, False),
    ("flash", True, True, True),
])
def test_loss_and_grads_match_jax(attention, fused_loss, remat, masked):
    import jax
    from ray_tpu.models.gpt import gpt_init, gpt_loss

    from ray_tpu_torch.convert import gpt_params_to_numpy

    jcfg, tcfg = _configs(attention=attention, fused_loss=fused_loss,
                          remat=remat)
    tree = jax.tree.map(np.asarray, gpt_init(jax.random.PRNGKey(1), jcfg))
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S + 1))
             .astype(np.int32)}
    if masked:  # token-aligned [B, S + 1]: shifts with the targets
        batch["mask"] = (rng.random((B, S + 1)) > 0.3).astype(np.float32)
    want, jgrads = jax.value_and_grad(gpt_loss)(tree, batch, jcfg)

    model = _train_model(tree, tcfg)
    loss = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert loss.dtype == torch.float32
    assert abs(loss.item() - float(want)) <= 1e-5
    grads = gpt_params_to_numpy(
        {n: p.grad for n, p in model.named_parameters()}, tcfg)
    jgrads = jax.tree.map(np.asarray, jgrads)
    for name in ("wte", "wpe", "ln_f_scale", "ln_f_bias"):
        assert _max_err(grads[name], jgrads[name]) <= 1e-4, name
    for name, g in jgrads["blocks"].items():
        assert _max_err(grads["blocks"][name], g) <= 1e-4, name


def test_inputs_targets_batch_equals_tokens_batch():
    import jax
    from ray_tpu.models.gpt import gpt_init

    jcfg, tcfg = _configs(attention="xla")
    tree = jax.tree.map(np.asarray, gpt_init(jax.random.PRNGKey(0), jcfg))
    model = _train_model(tree, tcfg)
    tokens = torch.randint(0, tcfg.vocab_size, (B, S + 1),
                           generator=torch.Generator().manual_seed(0))
    a = model.loss({"tokens": tokens})
    b = model.loss({"inputs": tokens[:, :-1], "targets": tokens[:, 1:]})
    assert a.item() == b.item()


def test_training_model_keeps_f32_masters():
    """load_state_dict copies into the f32 masters; the serving model keeps
    cfg.dtype weights (and f32 layer norms) without gradients."""
    import jax
    from ray_tpu.models.gpt import gpt_init

    from ray_tpu_torch.convert import gpt_params_from_numpy
    from ray_tpu_torch.models.gpt import GPT, GPTConfig, gpt_num_params

    jcfg, _ = _configs()
    tcfg = GPTConfig.tiny()  # bf16
    tree = jax.tree.map(np.asarray, gpt_init(jax.random.PRNGKey(0), jcfg))
    train = GPT(tcfg, "cpu", train=True)
    train.load_state_dict(gpt_params_from_numpy(tree, tcfg))
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in train.parameters())
    np.testing.assert_array_equal(train.wte.detach().numpy(), tree["wte"])
    serve = GPT(tcfg, "cpu")
    serve.load_state_dict(train.state_dict())
    assert serve.wte.dtype == torch.bfloat16 and not serve.wte.requires_grad
    assert serve.blocks[0].ln1_scale.dtype == torch.float32
    n = sum(a.size for a in jax.tree.leaves(tree))
    assert gpt_num_params(tcfg) == n


def test_adamw_step_matches_optax():
    import jax
    import optax

    from ray_tpu_torch.benchmarks.gpt_mfu import OPTIMIZER

    rng = np.random.default_rng(4)
    params = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
    grads = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
    tx = optax.adamw(3e-4, b1=0.9, b2=0.95, weight_decay=0.1)
    state = tx.init(params)
    updates, _ = tx.update(grads, state, params)
    want = optax.apply_updates(params, updates)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = torch.optim.AdamW(tp.values(), **OPTIMIZER)
    for k, p in tp.items():
        p.grad = torch.from_numpy(grads[k])
    opt.step()
    for k, p in tp.items():
        assert _max_err(p.detach().numpy(), jax.device_get(want[k])) <= 1e-6


def test_run_gpt_bench_follows_jax_train_step():
    import jax
    import optax
    from ray_tpu.models.gpt import gpt_loss

    from ray_tpu_torch.benchmarks.gpt_mfu import bench_batch, run_gpt_bench
    from ray_tpu_torch.convert import gpt_params_to_numpy
    from ray_tpu_torch.models.gpt import gpt_init

    jcfg, tcfg = _configs()
    out = run_gpt_bench(batch_size=B, seq_len=S, steps=2, warmup=1,
                        config=tcfg, device="cpu")
    assert out["device"] == "cpu" and out["mfu"] is None
    assert len(out["losses"]) == 3

    params = gpt_params_to_numpy(
        gpt_init(tcfg, seed=0, device="cpu", train=True).state_dict(), tcfg)
    batch = {"tokens": bench_batch(tcfg, B, S, 1, "cpu")["tokens"]
             .numpy().astype(np.int32)}
    tx = optax.adamw(3e-4, b1=0.9, b2=0.95, weight_decay=0.1)
    state = tx.init(params)
    want = []
    for _ in range(3):
        loss, grads = jax.value_and_grad(gpt_loss)(params, batch, jcfg)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        want.append(float(loss))
    assert np.abs(np.array(out["losses"]) - np.array(want)).max() <= 1e-4
    assert out["losses"][-1] < out["losses"][0]
