"""The port's Train (``ray_tpu_torch.train``: configs, checkpoints, the
session, the worker gang, ``DataParallelTrainer`` / ``TorchTrainer``)
against the JAX package's, one cluster per package for the module.

- One DDP loop (a seeded ``nn.Linear``, gloo, 2 workers) under both
  packages' ``TorchTrainer``: equal ``metrics_history`` and equal
  synced weights on every rank.
- GPT-tiny trained by JAX's ``JaxTrainer`` (``tests/test_train.py``'s
  loop, f32) and by the port's ``TorchTrainer(use_gpu=False)`` on the
  same weights (``convert.py``) and tokens: losses within 1e-4, the final
  weights (the port's read back from its checkpoint) within 1e-4.
- A raise on attempt 0 recovers with ``max_failures=1`` and surfaces as
  ``worker 0 failed`` with 0, as in the JAX package; a worker that dies
  outright (``os._exit``) ends its attempt as a gang failure that counts
  the same way.
- ``CheckpointManager`` keeps the JAX manager's set for scripted metric
  sequences; ``write_metadata`` is byte-equal.
- The port alone: the torch state round trip, whole GPUs only, a GPU gang
  without CUDA fails at its rendezvous (no fallback to the CPU), a
  dataset of another type raises the JAX ``TypeError``, and a gang
  worker loads no JAX, ``ray_tpu``,
  cloudpickle or msgpack."""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os

import numpy as np
import pytest
import torch

FORBIDDEN = ("jax", "jaxlib", "ray_tpu", "cloudpickle", "msgpack")


@pytest.fixture(scope="module")
def torch_rt():
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
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
    """For calls into the JAX package's cluster: its RpcClient guards
    call_async with a plain Lock that an ObjectRef's __del__ re-enters
    when the collector runs inside it (``tests/test_torch_core.py``)."""
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.collect()


def _train(pkg):
    import importlib

    return (importlib.import_module(pkg + ".train"),
            importlib.import_module(pkg + ".train.torch"))


def _scaling(pkg, n):
    train, _ = _train(pkg)
    if pkg == "ray_tpu":
        return train.ScalingConfig(num_workers=n,
                                   resources_per_worker={"CPU": 1})
    return train.ScalingConfig(num_workers=n, use_gpu=False)


def _fit(pkg, loop, tmp_path, name, n=1, config=None, max_failures=0,
         trainer="TorchTrainer"):
    train, tt = _train(pkg)
    cls = getattr(tt if trainer == "TorchTrainer" else train, trainer)
    run = train.RunConfig(name=name, storage_path=str(tmp_path / pkg),
                          failure_config=train.FailureConfig(
                              max_failures=max_failures))
    fit = cls(loop, train_loop_config=config, scaling_config=_scaling(pkg, n),
              run_config=run).fit
    if pkg == "ray_tpu":
        with _collector_off():
            return fit()
    return fit()


def _ddp_loop():
    """The DDP loop (nested, so it travels by value in both packages)."""
    def loop(config):
        import importlib

        import torch
        import torch.distributed as dist
        from torch import nn

        train = importlib.import_module(config["pkg"] + ".train")
        tt = importlib.import_module(config["pkg"] + ".train.torch")
        torch.manual_seed(0)  # identical init on every rank
        model = tt.prepare_model(nn.Linear(8, 1))
        opt = torch.optim.SGD(model.parameters(), lr=0.05)
        rank = dist.get_rank()
        g = torch.Generator().manual_seed(100 + rank)  # different data
        x = torch.randn(64, 8, generator=g)
        y = (x @ torch.arange(8, dtype=torch.float32))[:, None]
        ctx = train.get_context()
        for step in range(5):
            opt.zero_grad()
            loss = ((model(x) - y) ** 2).mean()
            loss.backward()  # DDP all-reduces gradients here
            opt.step()
            train.report({"step": step, "loss": float(loss.detach()),
                          "rank": rank, "world": ctx.get_world_size(),
                          "wrapped": type(model).__name__})
        weights = [p.detach().reshape(-1).tolist()
                   for p in model.parameters()]
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, weights)
        train.report({"weights": every, "device": str(tt.get_device()),
                      "trial": os.path.basename(ctx.get_trial_dir())})

    return loop


@pytest.mark.timeout(120)
def test_ddp_history_and_synced_weights_equal_jax(torch_rt, jax_rt, tmp_path):
    loop = _ddp_loop()
    got = _fit("ray_tpu_torch", loop, tmp_path, "ddp", n=2,
               config={"pkg": "ray_tpu_torch"})
    want = _fit("ray_tpu", loop, tmp_path, "ddp", n=2,
                config={"pkg": "ray_tpu"})
    assert got.error is None and want.error is None, (got.error, want.error)
    assert got.metrics_history == want.metrics_history
    last = got.metrics_history[-1]
    assert last["weights"][0] == last["weights"][1]  # DDP kept them synced
    assert got.metrics_history[0]["wrapped"] == "DistributedDataParallel"
    assert last["device"] == "cpu" and last["trial"] == "worker_0"
    losses = [m["loss"] for m in got.metrics_history[:-1]]
    assert losses[-1] < losses[0]


def _gpt_batch():
    rng = np.random.default_rng(1)
    return rng.integers(0, 128, (4, 33)).astype(np.int32)


@pytest.mark.timeout(120)
def test_gpt_tiny_losses_equal_jax_trainer(torch_rt, jax_rt, tmp_path):
    import jax
    import jax.numpy as jnp
    from ray_tpu.models.gpt import GPTConfig as JaxGPTConfig
    from ray_tpu.models.gpt import gpt_init

    from ray_tpu_torch.convert import gpt_params_from_numpy
    from ray_tpu_torch.models.gpt import GPTConfig

    tokens = _gpt_batch()

    def jax_loop(config):
        import jax

        jax.config.update("jax_platforms", "cpu")
        import dataclasses

        import jax.numpy as jnp
        import numpy as np
        import optax
        from ray_tpu.models.gpt import GPTConfig, gpt_init, gpt_loss
        from ray_tpu.train import report

        cfg = dataclasses.replace(GPTConfig.tiny(vocab_size=128),
                                  dtype=jnp.float32, attention="xla")
        params = gpt_init(jax.random.PRNGKey(0), cfg)
        tx = optax.adamw(1e-3)
        opt_state = tx.init(params)
        batch = {"tokens": jnp.asarray(config["tokens"])}

        @jax.jit
        def step(params, opt_state):
            loss, grads = jax.value_and_grad(gpt_loss)(params, batch, cfg)
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss

        for i in range(3):
            params, opt_state, loss = step(params, opt_state)
            report({"loss": float(loss), "step": i})
        report({"params": jax.tree.map(np.asarray, params)})

    def torch_loop(config):
        import dataclasses
        import sys

        import torch
        from ray_tpu_torch.models.gpt import GPT, GPTConfig
        from ray_tpu_torch.train import Checkpoint, get_context, report
        from ray_tpu_torch.train.torch import get_device

        device = get_device()
        cfg = dataclasses.replace(GPTConfig.tiny(vocab_size=128),
                                  dtype=torch.float32)
        model = GPT(cfg, device, train=True)
        model.load_state_dict(config["params"])
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)  # optax.adamw's defaults
        batch = {"tokens": torch.from_numpy(config["tokens"]).to(device)}
        for i in range(3):
            loss = model.loss(batch)
            loss.backward()
            opt.step()
            opt.zero_grad(set_to_none=True)
            report({"loss": float(loss.detach()), "step": i})
        ckpt = Checkpoint.from_state(
            os.path.join(get_context().get_trial_dir(), "ckpt"),
            {"model": model.state_dict(), "optimizer": opt.state_dict()})
        report({"loaded": sorted(m for m in sys.modules if m.split(".")[0]
                                 in config["forbidden"])}, checkpoint=ckpt)

    jcfg = dataclasses.replace(JaxGPTConfig.tiny(vocab_size=128),
                               dtype=jnp.float32, attention="xla")
    tree = jax.tree.map(np.asarray, gpt_init(jax.random.PRNGKey(0), jcfg))
    tcfg = dataclasses.replace(GPTConfig.tiny(vocab_size=128),
                               dtype=torch.float32)
    want = _fit("ray_tpu", jax_loop, tmp_path, "gpt", config={
        "tokens": tokens}, trainer="JaxTrainer")
    got = _fit("ray_tpu_torch", torch_loop, tmp_path, "gpt", config={
        "tokens": tokens, "params": gpt_params_from_numpy(tree, tcfg),
        "forbidden": FORBIDDEN})
    assert want.error is None and got.error is None, (want.error, got.error)
    jl = [m["loss"] for m in want.metrics_history[:3]]
    tl = [m["loss"] for m in got.metrics_history[:3]]
    assert np.max(np.abs(np.array(jl) - np.array(tl))) <= 1e-4, (jl, tl)
    assert tl[-1] < tl[0]
    assert got.metrics_history[-1]["loaded"] == []
    from ray_tpu_torch.convert import gpt_params_to_numpy

    state = got.checkpoint.load_state(map_location="cpu")
    mine = gpt_params_to_numpy(state["model"], tcfg)
    theirs = want.metrics_history[-1]["params"]
    flat = jax.tree_util.tree_leaves_with_path(theirs)
    assert flat
    for path, leaf in flat:
        node = mine
        for k in path:
            node = node[k.key]
        assert np.max(np.abs(node - leaf)) <= 1e-4, path


def _raise_loop():
    def loop(config):
        import importlib

        train = importlib.import_module(config["pkg"] + ".train")
        attempt = train.get_context().experiment_config["attempt"]
        train.report({"attempt": attempt, "step": 0})
        if attempt == 0:
            raise RuntimeError("first attempt dies")
        train.report({"recovered": 1})

    return loop


@pytest.mark.parametrize("max_failures", [1, 0])
@pytest.mark.timeout(120)
def test_raise_restarts_the_gang_as_jax(torch_rt, jax_rt, tmp_path,
                                        max_failures):
    loop = _raise_loop()
    res = {pkg: _fit(pkg, loop, tmp_path, "raise", config={"pkg": pkg},
                     max_failures=max_failures,
                     trainer="JaxTrainer" if pkg == "ray_tpu"
                     else "DataParallelTrainer")
           for pkg in ("ray_tpu_torch", "ray_tpu")}
    got, want = res["ray_tpu_torch"], res["ray_tpu"]
    assert got.metrics_history == want.metrics_history
    if max_failures:
        assert got.error is None and want.error is None
        assert got.metrics == {"recovered": 1}
    else:
        first = [r.error.splitlines()[0] for r in (got, want)]
        assert first == ["worker 0 failed:"] * 2
        assert "RuntimeError: first attempt dies" in got.error
        assert got.error.splitlines()[-1] == want.error.splitlines()[-1]


def _death_loop():
    def loop(config):
        import os

        from ray_tpu_torch.train import get_context, report
        from ray_tpu_torch.train.session import get_session

        attempt = get_context().experiment_config["attempt"]
        report({"attempt": attempt, "pid": os.getpid()})
        if attempt == 0:
            session = get_session()
            while session.consumed < 1:  # the trainer has the report
                import time

                time.sleep(0.01)
            os._exit(1)

    return loop


@pytest.mark.parametrize("max_failures", [1, 0])
@pytest.mark.timeout(120)
def test_worker_death_is_a_gang_failure(torch_rt, tmp_path, max_failures):
    from ray_tpu_torch.train import RunConfig
    from ray_tpu_torch.util import state

    attempts = []
    train, tt = _train("ray_tpu_torch")

    class Recording(tt.TorchTrainer):
        def _run_attempt(self, storage, manager, attempt):
            attempts.append(super()._run_attempt(storage, manager, attempt))
            return attempts[-1]

    result = Recording(_death_loop(), scaling_config=_scaling(
        "ray_tpu_torch", 1), run_config=RunConfig(
        storage_path=str(tmp_path), failure_config=train.FailureConfig(
            max_failures=max_failures))).fit()
    assert attempts[0].error.startswith("ActorDiedError")
    assert [m["attempt"] for m in attempts[0].metrics_history] == [0]
    if max_failures:
        assert result.error is None and result.metrics["attempt"] == 1
        assert attempts[1].metrics_history[0]["pid"] != \
            attempts[0].metrics_history[0]["pid"]
    else:
        assert result is attempts[0] and len(attempts) == 1
    dead = [a for a in state.list_actors()
            if a.get("class_name") == "TrainWorker"]
    assert dead and all(a["state"] == "DEAD" for a in dead)


SEQUENCES = [
    # (num_to_keep, attribute, order, metrics of each checkpoint in turn)
    (2, "loss", "min", [{"loss": x} for x in (5.0, 3.0, 4.0, 1.0, 2.0)]),
    (2, "acc", "max", [{"acc": x} for x in (0.1, 0.5, 0.3, 0.9, 0.2)]),
    (1, "loss", "min", [{"loss": x} for x in (3.0, 3.0, 1.0)]),
    (3, None, "max", [{"loss": x} for x in (1.0, 2.0, 3.0, 4.0, 5.0)]),
    (None, "loss", "min", [{"loss": x} for x in (2.0, 1.0)]),
    (2, "loss", "min", [{"step": i} for i in range(4)]),  # no attribute
]


@pytest.mark.parametrize("keep,attr,order,seq", SEQUENCES)
def test_checkpoint_manager_keeps_jax_set(tmp_path, keep, attr, order, seq):
    from ray_tpu.train.checkpoint import Checkpoint as JaxCheckpoint
    from ray_tpu.train.checkpoint import CheckpointManager as JaxManager

    from ray_tpu_torch.train import Checkpoint, CheckpointManager

    out = {}
    for pkg, mgr_cls, ckpt_cls in (
            ("jax", JaxManager, JaxCheckpoint),
            ("torch", CheckpointManager, Checkpoint)):
        root = tmp_path / pkg
        mgr = mgr_cls(num_to_keep=keep, score_attribute=attr,
                      score_order=order)
        for i, metrics in enumerate(seq):
            path = root / f"ckpt_{i}"
            path.mkdir(parents=True)
            ckpt_cls(str(path)).write_metadata({"step": i, **metrics})
            mgr.register(str(path), metrics)
        out[pkg] = (sorted(os.listdir(root)),
                    os.path.basename(mgr.best()), os.path.basename(
                        mgr.latest()),
                    {n: (root / n / "metadata.json").read_bytes()
                     for n in os.listdir(root)},
                    [ckpt_cls(str(root / n)).read_metadata()
                     for n in sorted(os.listdir(root))])
    assert out["torch"] == out["jax"]


def test_checkpoint_state_round_trip(tmp_path):
    from ray_tpu_torch.train import Checkpoint

    model = torch.nn.Linear(4, 3)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    model(torch.ones(2, 4)).sum().backward()
    opt.step()
    state = {"model": model.state_dict(), "optimizer": opt.state_dict(),
             "step": 7}
    ckpt = Checkpoint.from_state(str(tmp_path / "c"), state)
    assert os.listdir(ckpt.path) == ["state.pt"]
    back = ckpt.load_state(map_location="cpu")
    assert back["step"] == 7
    for k, v in state["model"].items():
        assert torch.equal(back["model"][k], v)
    opt2 = torch.optim.AdamW(torch.nn.Linear(4, 3).parameters(), lr=1e-3)
    opt2.load_state_dict(back["optimizer"])
    assert torch.equal(opt2.state_dict()["state"][0]["exp_avg"],
                       state["optimizer"]["state"][0]["exp_avg"])
    with pytest.raises(FileExistsError):
        Checkpoint.from_state(ckpt.path, state, force=False)
    copy = ckpt.to_directory(str(tmp_path / "d"))
    assert Checkpoint.from_directory(copy).load_state()["step"] == 7
    assert Checkpoint(str(tmp_path / "e")).read_metadata() == {}
    ckpt.write_metadata({"a": 1})
    assert json.loads((tmp_path / "c" / "metadata.json").read_text()) == \
        {"a": 1}


def test_configs(monkeypatch, tmp_path):
    from ray_tpu.train import RunConfig as JaxRunConfig

    from ray_tpu_torch.train import RunConfig, ScalingConfig

    assert ScalingConfig().worker_resources() == {"CPU": 1.0, "GPU": 1.0}
    assert ScalingConfig(use_gpu=False, resources_per_worker={
        "x": 2}).worker_resources() == {"CPU": 1.0, "x": 2}
    assert ScalingConfig(gpus_per_worker=2).worker_resources()["GPU"] == 2.0
    for bad in (dict(gpus_per_worker=0.5),
                dict(use_gpu=False, resources_per_worker={"GPU": 1.5})):
        with pytest.raises(ValueError, match="whole number of GPUs"):
            ScalingConfig(**bad)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert RunConfig(name="n").resolved_storage_path() == str(
        tmp_path / "ray_tpu_torch_results" / "n")
    assert RunConfig(storage_path="/s").resolved_storage_path() == \
        JaxRunConfig(storage_path="/s").resolved_storage_path()


def test_data_is_not_ported_yet(torch_rt):
    """Trainer datasets are ported now (``ray_tpu_torch.data``; the name
    is the old pin's). What stays refused is what the JAX package
    refuses: a dataset that is neither a Dataset nor a DataIterator
    fails the attempt with the JAX package's ``TypeError``, and a shard
    name the trainer was not given raises its ``KeyError``."""
    from ray_tpu.train.worker_group import _shard_dataset as jax_shard

    from ray_tpu_torch.train import DataParallelTrainer, get_dataset_shard
    from ray_tpu_torch.train.session import TrainContext, init_session
    from ray_tpu_torch.train.worker_group import _shard_dataset

    trainer = DataParallelTrainer(lambda: None, datasets={"train": [1]})
    assert trainer.datasets == {"train": [1]}
    with pytest.raises(TypeError) as theirs:
        jax_shard([1], 1)
    with pytest.raises(TypeError, match="must be ray_tpu.data Datasets") \
            as mine:
        _shard_dataset([1], 1)
    assert str(mine.value) == str(theirs.value)
    init_session(TrainContext())
    with pytest.raises(KeyError, match="no dataset shard named 'train'"):
        get_dataset_shard("train")


def test_exports_match_jax():
    import ray_tpu.train as jt

    import ray_tpu_torch.train as tt

    want = set(jt.__all__) - {"JaxTrainer", "GBDTTrainer", "LightGBMTrainer",
                              "XGBoostTrainer"}
    assert set(tt.__all__) == want | {"DataParallelTrainer"}


@pytest.mark.timeout(120)
def test_gpu_gang_without_cuda_fails_at_rendezvous(torch_rt, tmp_path):
    """``use_gpu=True`` on a node that has a GPU slot but a worker without
    CUDA: the attempt fails at the rendezvous with an error, no quiet
    fallback to the CPU."""
    from ray_tpu_torch.train import RunConfig, ScalingConfig
    from ray_tpu_torch.train.torch import TorchTrainer

    def loop():
        raise AssertionError("the loop must not run")

    result = TorchTrainer(loop, scaling_config=ScalingConfig(num_workers=1),
                          run_config=RunConfig(storage_path=str(
                              tmp_path))).fit()
    assert result.error is not None
    assert "needs CUDA" in result.error and "use_gpu=False" in result.error
    assert result.metrics_history == []
