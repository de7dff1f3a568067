"""The port's Tune (``ray_tpu_torch.tune``) against the JAX package's, one
cluster per package for the module.

- A deterministic trainable (its loss a function of the config and the
  step, a small JSON file as its checkpoint, restored where there is one)
  runs under both packages' ``Tuner`` with ``max_concurrent_trials=1``:
  grid search with FIFO, ASHA, seeded PBT and synchronous HyperBand give
  equal (config, status, iteration, last result) per trial in creation
  order and an equal best config.
- A raise with ``max_failures=1`` resumes from the trial's checkpoint as
  in the JAX package; with none the error surfaces alike.
- ``Tuner.restore`` after a run stopped partway (the controller left
  after its first trial ended) continues the search as the JAX one does.
- The port alone, on ``init(num_cpus=4, num_gpus=1)``: ``GPU`` trials
  hold the card one at a time and see ``CUDA_VISIBLE_DEVICES`` "0", CPU
  trials see ""; a ``"TPU"`` key raises; a trial worker loads no JAX,
  ``ray_tpu``, cloudpickle or msgpack; a worker whose actor thread is
  still importing torch when a task ends does not fail the task."""
from __future__ import annotations

import contextlib
import gc
import importlib
import os
import sys
import time
import types

import pytest

FORBIDDEN = ("jax", "jaxlib", "ray_tpu", "cloudpickle", "msgpack")
PKGS = ("ray_tpu", "ray_tpu_torch")


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


@pytest.fixture
def both(jax_rt, torch_rt):
    return {"ray_tpu": jax_rt, "ray_tpu_torch": torch_rt}


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


def _calling(pkg):
    return _collector_off() if pkg == "ray_tpu" else contextlib.nullcontext()


def _trainable(pkg):
    """The deterministic trainable (nested, so it travels by value in both
    packages). ``config``: ``lr``, ``steps`` (6), ``fail_at`` (a step at
    which an attempt with no checkpoint raises)."""

    def trainable(config):
        import importlib
        import json
        import os
        import shutil
        import tempfile

        tune = importlib.import_module(pkg + ".tune")
        Checkpoint = importlib.import_module(
            pkg + ".train.checkpoint").Checkpoint
        state = {"step": 0, "acc": 0.0}
        restored = tune.get_checkpoint()
        if restored is not None:
            with open(os.path.join(restored.path, "state.json")) as f:
                state = json.load(f)
        while state["step"] < config.get("steps", 6):
            state["step"] += 1
            if restored is None and config.get("fail_at") == state["step"]:
                raise RuntimeError("transient failure")
            state["acc"] += config["lr"] * (1 + state["step"] % 3)
            d = tempfile.mkdtemp()
            with open(os.path.join(d, "state.json"), "w") as f:
                json.dump(state, f)
            tune.report({"loss": round(1.0 / (1.0 + state["acc"]), 12),
                         "step": state["step"]},
                        checkpoint=Checkpoint.from_directory(d))
            shutil.rmtree(d)  # report copied it into the trial dir

    return trainable


def _summary(grid):
    trials = [r.trial for r in grid]
    return {"trials": [(t.config, t.status, t.iteration, t.last_result,
                        [m["step"] for m in t.results]) for t in trials],
            "errors": [e.splitlines()[0] for e in grid.errors]}


def _fit(pkg, tmp_path, name, space, scheduler=None, max_failures=0):
    tune = importlib.import_module(pkg + ".tune")
    with _calling(pkg):
        grid = tune.Tuner(
            _trainable(pkg), param_space=space,
            tune_config=tune.TuneConfig(
                metric="loss", mode="min", max_concurrent_trials=1,
                scheduler=scheduler(tune) if scheduler else None, seed=0),
            run_config=tune.TuneRunConfig(
                name=name, storage_path=str(tmp_path / pkg),
                max_failures=max_failures)).fit()
    out = _summary(grid)
    if not grid.errors:
        best = grid.get_best_result()
        out["best"] = (best.config, best.metrics["loss"],
                       os.path.basename(best.checkpoint.path))
    return out


SEARCHES = {
    "fifo": (lambda tune: {"lr": tune.grid_search([0.1, 0.5, 0.2])}, None),
    "asha": (lambda tune: {"lr": tune.grid_search([0.1, 0.5, 0.05, 0.3])},
             lambda tune: tune.ASHAScheduler(grace_period=1,
                                             reduction_factor=2, max_t=6)),
    "pbt": (lambda tune: {"lr": tune.grid_search([0.5, 0.05, 0.1])},
            lambda tune: tune.PopulationBasedTraining(
                perturbation_interval=2, quantile_fraction=0.34, seed=3,
                hyperparam_mutations={"lr": [0.05, 0.1, 0.2, 0.5, 1.0]})),
    "hyperband": (lambda tune: {"lr": tune.grid_search([0.1, 0.5, 0.05,
                                                        0.3])},
                  lambda tune: tune.HyperBandScheduler(
                      grace_period=1, reduction_factor=2, max_t=4)),
}


@pytest.mark.parametrize("search", sorted(SEARCHES))
def test_tuner_runs_alike(both, tmp_path, search):
    space, scheduler = SEARCHES[search]
    jax_out, port_out = (
        _fit(pkg, tmp_path, search,
             space(importlib.import_module(pkg + ".tune")), scheduler)
        for pkg in PKGS)
    assert port_out == jax_out
    statuses = {t[1] for t in port_out["trials"]}
    assert statuses == {"TERMINATED"}, port_out
    if search == "asha":  # a stop before max_t
        assert min(t[2] for t in port_out["trials"]) < 6
    if search in ("pbt", "hyperband"):  # an exploit, a cut at a barrier
        assert any(len(t[4]) < 6 for t in port_out["trials"]), port_out


@pytest.mark.parametrize("max_failures", [1, 0])
def test_failure_resumes_from_checkpoint_alike(both, tmp_path, max_failures):
    jax_out, port_out = (
        _fit(pkg, tmp_path, f"fail{max_failures}",
             {"lr": 0.2, "fail_at": 3}, max_failures=max_failures)
        for pkg in PKGS)
    assert port_out == jax_out
    (config, status, it, last, steps), = port_out["trials"]
    if max_failures:
        assert status == "TERMINATED" and steps == [1, 2, 3, 4, 5, 6]
    else:
        assert status == "ERROR" and steps == [1, 2]
        assert port_out["errors"][0].startswith("RuntimeError: transient")


def _stopped_then_restored(pkg, tmp_path):
    """A controller left after its first trial ended (the second made,
    not launched), then ``Tuner.restore`` with the same space."""
    tune = importlib.import_module(pkg + ".tune")
    ctl_mod = importlib.import_module(pkg + ".tune.tune_controller")
    space = {"lr": tune.grid_search([0.1, 0.4, 0.2, 0.8]), "steps": 3}
    exp = str(tmp_path / pkg / "exp")
    with _calling(pkg):
        searcher = tune.BasicVariantGenerator(space)
        searcher.set_search_properties("loss", "min")
        ctl = ctl_mod.TuneController(
            _trainable(pkg), searcher=searcher, scheduler=None, metric="loss",
            mode="min", experiment_dir=exp, max_concurrent_trials=1)
        deadline = time.monotonic() + 60
        while not any(t.status == "TERMINATED" for t in ctl.trials):
            assert time.monotonic() < deadline
            ctl.step()
            time.sleep(0.02)
        ctl.save_state()
        left = [(t.config, t.status) for t in ctl.trials]
        for t in ctl.trials:
            ctl._stop_actor(t)
        grid = tune.Tuner.restore(
            exp, _trainable(pkg), param_space=space,
            tune_config=tune.TuneConfig(metric="loss", mode="min",
                                        max_concurrent_trials=1)).fit()
    return left, _summary(grid), grid.get_best_result().config


def test_restore_continues_the_search_alike(both, tmp_path):
    jax_out, port_out = (_stopped_then_restored(pkg, tmp_path)
                         for pkg in PKGS)
    assert port_out == jax_out
    left, summary, best = port_out
    assert [s for _, s in left] == ["TERMINATED", "PENDING"]
    assert [t[0]["lr"] for t in summary["trials"]] == [0.1, 0.4, 0.2, 0.8]
    assert best["lr"] == 0.8


# ------------------------------------------------------------ the port

def _probe():
    """A trainable that reports its slot's CUDA_VISIBLE_DEVICES, its walls
    and the forbidden modules loaded in its process, importing torch on
    its thread as a card's trainable does (nested, so it travels by
    value)."""

    def probe(config):
        import os
        import sys
        import time

        import torch  # noqa: F401
        from ray_tpu_torch import tune

        t0 = time.time()
        time.sleep(0.2)
        tune.report({"loss": config["lr"], "start": t0, "end": time.time(),
                     "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                     "loaded": sorted(m for m in sys.modules
                                      if m.split(".")[0] in FORBIDDEN)})

    return probe


def _probe_run(torch_rt, tmp_path, resources):
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune.tune_controller import TuneController

    ctl = TuneController(
        _probe(), searcher=tune.BasicVariantGenerator(
            {"lr": tune.grid_search([0.3, 0.1, 0.2])}),
        scheduler=None, metric="loss", mode="min",
        experiment_dir=str(tmp_path / "probe"),
        resources_per_trial=resources)
    grid = tune.ResultGrid(ctl.run(), "loss", "min")
    assert not grid.errors
    return ctl.max_concurrent, [r.metrics for r in grid]


def test_gpu_trials_hold_the_card_one_at_a_time(torch_rt, tmp_path):
    cap, runs = _probe_run(torch_rt, tmp_path, {"CPU": 1, "GPU": 1})
    assert cap == 1  # the cap counts GPU as every resource
    assert [m["visible"] for m in runs] == ["0", "0", "0"]
    spans = sorted((m["start"], m["end"]) for m in runs)
    assert all(b[0] >= a[1] for a, b in zip(spans, spans[1:])), spans
    assert all(m["loaded"] == [] for m in runs), runs
    deadline = time.monotonic() + 10  # the last trial's actor let go
    while torch_rt.available_resources().get("GPU") != 1.0:
        assert time.monotonic() < deadline
        time.sleep(0.05)


def test_cpu_trials_see_no_card(torch_rt, tmp_path):
    cap, runs = _probe_run(torch_rt, tmp_path, {"CPU": 1})
    assert cap == 4
    assert [m["visible"] for m in runs] == ["", "", ""]


def test_a_tpu_key_raises(torch_rt, tmp_path):
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune.tune_controller import TuneController

    with pytest.raises(ValueError, match="GPU"):
        TuneController(_probe(), searcher=tune.BasicVariantGenerator({}),
                       scheduler=None, metric="loss", mode="min",
                       experiment_dir=str(tmp_path),
                       resources_per_trial={"CPU": 1, "TPU": 1})


def test_a_task_ending_while_torch_imports_is_not_cuda_bound(monkeypatch):
    """An actor's thread may be importing torch when a task of its
    process ends: a ``torch`` module without ``cuda`` yet is no CUDA
    binding (the check used to raise ``AttributeError`` there, failing
    the actor's creation)."""
    from ray_tpu_torch._private.worker import CoreWorker

    monkeypatch.setitem(sys.modules, "torch", types.ModuleType("torch"))
    worker = types.SimpleNamespace(_cuda_devices=None, _current_gpus=[0])
    assert CoreWorker._cuda_bound(worker) is False
    assert worker._cuda_devices is None
