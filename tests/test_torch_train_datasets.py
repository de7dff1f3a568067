"""Trainer datasets on the port (``DataParallelTrainer(datasets=...)``,
``WorkerGroup``'s ``streaming_split`` of each dataset across the gang,
``get_dataset_shard``) against the JAX package's Train, one cluster per
package for the module.

- Two gloo workers read their shards of a seeded, shuffled dataset: each
  rank's rows (gathered through ``torch.distributed``) equal the JAX
  trainer's rank, and so do the shard counts and the dataset names in the
  experiment config.
- GPT-tiny trained from a dataset (``iter_torch_batches`` on the port,
  ``iter_batches`` under JAX's ``JaxTrainer``) on the same weights and
  tokens: losses within 1e-4.
- A gang restart shards the dataset again: attempt 1 reads its whole
  shard, as in the JAX package.
- An unknown shard name raises the JAX text; a dataset that is neither a
  Dataset nor a DataIterator fails the attempt with the JAX TypeError.

Train loops are defined inside the tests, so both picklers carry them by
value."""
from __future__ import annotations

import contextlib
import dataclasses
import gc

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module")
def torch_rt():
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def jax_rt():
    pytest.importorskip("jax")
    import ray_tpu

    if ray_tpu.is_initialized():  # left by a file run before in this process
        ray_tpu.shutdown()
    with _collector_off():
        ray_tpu.init(num_cpus=4)
    yield ray_tpu
    with _collector_off():
        ray_tpu.shutdown()


@contextlib.contextmanager
def _collector_off():
    """For calls into the JAX package's cluster (``tests/test_torch_core.py``)."""
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.collect()


def _fit(pkg, loop, tmp_path, name, datasets, n=1, config=None,
         max_failures=0, trainer="TorchTrainer"):
    import importlib

    train = importlib.import_module(pkg + ".train")
    tt = importlib.import_module(pkg + ".train.torch")
    cls = getattr(tt if trainer == "TorchTrainer" else train, trainer)
    if pkg == "ray_tpu":
        scaling = train.ScalingConfig(num_workers=n,
                                      resources_per_worker={"CPU": 1})
    else:
        scaling = train.ScalingConfig(num_workers=n, use_gpu=False)
    run = train.RunConfig(name=name, storage_path=str(tmp_path / pkg),
                          failure_config=train.FailureConfig(
                              max_failures=max_failures))
    fit = cls(loop, train_loop_config=config, scaling_config=scaling,
              run_config=run, datasets=datasets).fit
    if pkg == "ray_tpu":
        with _collector_off():
            return fit()
    return fit()


def _data(pkg):
    import importlib

    return importlib.import_module(pkg + ".data")


@pytest.mark.timeout(120)
def test_each_rank_reads_the_jax_ranks_rows(torch_rt, jax_rt, tmp_path):
    def loop(config):
        import importlib

        import torch.distributed as dist

        train = importlib.import_module(config["pkg"] + ".train")
        shard = train.get_dataset_shard("train")
        rows = [[int(i), float(x)] for b in shard.iter_batches(batch_size=4)
                for i, x in zip(b["id"], b["x"])]
        try:
            train.get_dataset_shard("nope")
            missing = None
        except KeyError as e:
            missing = str(e)
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, rows)
        train.report({"rows": every, "count": shard.count(),
                      "names": train.get_context().experiment_config[
                          "datasets"], "missing": missing})

    res = {}
    for pkg in ("ray_tpu_torch", "ray_tpu"):
        ds = (_data(pkg).range(30, parallelism=4)
              .map(lambda r: {"id": r["id"], "x": r["id"] / 4})
              .random_shuffle(seed=3))
        res[pkg] = _fit(pkg, loop, tmp_path, "ranks", {"train": ds}, n=2,
                        config={"pkg": pkg})
    got, want = res["ray_tpu_torch"], res["ray_tpu"]
    assert got.error is None and want.error is None, (got.error, want.error)
    assert got.metrics_history == want.metrics_history
    every = got.metrics["rows"]
    assert len(every[0]) == len(every[1]) == 15 == got.metrics["count"]
    assert sorted(r[0] for rank in every for r in rank) == list(range(30))
    assert got.metrics["names"] == ["train"]
    assert "no dataset shard named 'nope'" in got.metrics["missing"]


def _tokens():
    return np.random.default_rng(1).integers(0, 128, (12, 33)).astype(
        np.int32)


@pytest.mark.timeout(120)
def test_gpt_tiny_from_a_dataset_equals_jax_trainer(torch_rt, jax_rt,
                                                    tmp_path):
    import jax
    import jax.numpy as jnp
    from ray_tpu.models.gpt import GPTConfig as JaxGPTConfig
    from ray_tpu.models.gpt import gpt_init

    from ray_tpu_torch.convert import gpt_params_from_numpy
    from ray_tpu_torch.models.gpt import GPTConfig

    def jax_loop(config):
        import jax

        jax.config.update("jax_platforms", "cpu")
        import dataclasses

        import jax.numpy as jnp
        import optax
        from ray_tpu.models.gpt import GPTConfig, gpt_init, gpt_loss
        from ray_tpu.train import get_dataset_shard, report

        cfg = dataclasses.replace(GPTConfig.tiny(vocab_size=128),
                                  dtype=jnp.float32, attention="xla")
        params = gpt_init(jax.random.PRNGKey(0), cfg)
        tx = optax.adamw(1e-3)
        opt_state = tx.init(params)

        @jax.jit
        def step(params, opt_state, tokens):
            loss, grads = jax.value_and_grad(gpt_loss)(
                params, {"tokens": tokens}, cfg)
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss

        for i, b in enumerate(get_dataset_shard("train").iter_batches(
                batch_size=4, drop_last=True)):
            params, opt_state, loss = step(params, opt_state,
                                           jnp.asarray(b["data"]))
            report({"loss": float(loss), "step": i,
                    "first": int(b["data"][0, 0])})

    def torch_loop(config):
        import dataclasses

        import torch
        from ray_tpu_torch.models.gpt import GPT, GPTConfig
        from ray_tpu_torch.train import get_dataset_shard, report
        from ray_tpu_torch.train.torch import get_device

        device = get_device()
        cfg = dataclasses.replace(GPTConfig.tiny(vocab_size=128),
                                  dtype=torch.float32)
        model = GPT(cfg, device, train=True)
        model.load_state_dict(config["params"])
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)  # optax.adamw's defaults
        for i, b in enumerate(get_dataset_shard("train").iter_torch_batches(
                batch_size=4, drop_last=True, dtypes=torch.int64,
                device=device)):
            loss = model.loss({"tokens": b["data"]})
            loss.backward()
            opt.step()
            opt.zero_grad(set_to_none=True)
            report({"loss": float(loss.detach()), "step": i,
                    "first": int(b["data"][0, 0])})

    jcfg = dataclasses.replace(JaxGPTConfig.tiny(vocab_size=128),
                               dtype=jnp.float32, attention="xla")
    tree = jax.tree.map(np.asarray, gpt_init(jax.random.PRNGKey(0), jcfg))
    tcfg = dataclasses.replace(GPTConfig.tiny(vocab_size=128),
                               dtype=torch.float32)

    # token files read by read_numpy (the JAX package's from_numpy of 2-D
    # arrays can crash its Arrow tensor path: ROADMAP C 6)
    for i, part in enumerate(np.split(_tokens(), 3)):
        np.save(tmp_path / f"tokens_{i}.npy", part)

    def dataset(pkg):
        return _data(pkg).read_numpy(
            str(tmp_path / "tokens_*.npy")).random_shuffle(seed=1)

    want = _fit("ray_tpu", jax_loop, tmp_path, "gpt",
                {"train": dataset("ray_tpu")}, trainer="JaxTrainer")
    got = _fit("ray_tpu_torch", torch_loop, tmp_path, "gpt",
               {"train": dataset("ray_tpu_torch")},
               config={"params": gpt_params_from_numpy(tree, tcfg)})
    assert want.error is None and got.error is None, (want.error, got.error)
    assert [m["step"] for m in got.metrics_history] == [0, 1, 2]
    assert [m["first"] for m in got.metrics_history] == \
        [m["first"] for m in want.metrics_history]
    jl = np.array([m["loss"] for m in want.metrics_history])
    tl = np.array([m["loss"] for m in got.metrics_history])
    assert np.max(np.abs(jl - tl)) <= 1e-4, (jl, tl)


@pytest.mark.timeout(120)
def test_a_restarted_gang_reads_its_shard_again(torch_rt, jax_rt, tmp_path):
    def loop(config):
        import importlib

        train = importlib.import_module(config["pkg"] + ".train")
        attempt = train.get_context().experiment_config["attempt"]
        batches = train.get_dataset_shard("train").iter_batches(batch_size=5)
        first = [int(i) for i in next(iter(batches))["id"]]
        train.report({"attempt": attempt, "first": first})
        if attempt == 0:
            raise RuntimeError("first attempt dies")
        rest = [int(i) for b in batches for i in b["id"]]
        train.report({"attempt": attempt, "rows": first + rest})

    res = {}
    for pkg in ("ray_tpu_torch", "ray_tpu"):
        ds = _data(pkg).range(17, parallelism=3).random_shuffle(seed=8)
        res[pkg] = _fit(pkg, loop, tmp_path, "restart", {"train": ds},
                        config={"pkg": pkg}, max_failures=1,
                        trainer="JaxTrainer" if pkg == "ray_tpu"
                        else "DataParallelTrainer")
    got, want = res["ray_tpu_torch"], res["ray_tpu"]
    assert got.error is None and want.error is None, (got.error, want.error)
    assert got.metrics_history == want.metrics_history
    assert got.metrics["attempt"] == 1
    assert sorted(got.metrics["rows"]) == list(range(17))


def test_unknown_shard_name_raises_the_jax_text():
    from ray_tpu.train import session as js

    from ray_tpu_torch.train import session as ts

    texts = []
    for s in (ts, js):
        s.init_session(s.TrainContext(dataset_shards={"train": 1,
                                                      "eval": 2}))
        assert s.get_dataset_shard("eval") == 2
        with pytest.raises(KeyError) as err:
            s.get_dataset_shard("test")
        texts.append(str(err.value))
    assert texts[0] == texts[1]
    assert "no dataset shard named 'test'" in texts[0]


@pytest.mark.timeout(60)
def test_a_dataset_of_another_type_fails_the_attempt(torch_rt, tmp_path):
    from ray_tpu.train.worker_group import _shard_dataset as jax_shard

    from ray_tpu_torch.train.worker_group import _shard_dataset

    with pytest.raises(TypeError) as theirs:
        jax_shard([1, 2], 2)
    with pytest.raises(TypeError) as mine:
        _shard_dataset([1, 2], 2)
    assert str(mine.value) == str(theirs.value)

    def loop():
        raise AssertionError("the loop must not run")

    result = _fit("ray_tpu_torch", loop, tmp_path, "bad", {"train": [1, 2]})
    assert result.error == f"TypeError: {theirs.value}"
    assert result.metrics_history == []
