"""The port's Tune on the card (marked ``gpu``: skips without an NVIDIA
card of compute capability 9.0 or more): two tiny-Llama trials under
``TuneController`` with ``resources_per_trial={"CPU": 1, "GPU": 1}``, one
at a time, each on ``cuda:0`` under ``CUDA_VISIBLE_DEVICES`` "0" with
B1-B3 launching once a layer a step in its process, and each loss equal
to the same steps run in the test's process."""
from __future__ import annotations

import pytest
import torch

pytestmark = pytest.mark.gpu

STEPS = 3


def _helpers():
    """(model, losses): the tiny Llama with AdamW on ``device``, and its
    steps at ``lr`` (nested, so a trial takes them by value)."""

    def model(device):
        from ray_tpu_torch.benchmarks.gpt_mfu import make_optimizer
        from ray_tpu_torch.models.families import family

        fam = family("llama")
        cfg = fam.config.tiny()
        net = fam.init(cfg, seed=0, device=device, train=True)
        return cfg, net, make_optimizer(net)

    def losses(cfg, net, opt, lr, device):
        from ray_tpu_torch.benchmarks.gpt_mfu import bench_batch, train_step

        for group in opt.param_groups:
            group["lr"] = lr
        return [float(train_step(net, opt, bench_batch(cfg, 4, 64, 10 + s,
                                                       device)))
                for s in range(1, STEPS + 1)]

    return model, losses


def _trainable():
    """The trial (nested, so it travels by value)."""
    model, losses = _helpers()

    def trainable(config):
        import os

        import torch
        from ray_tpu_torch import tune
        from ray_tpu_torch.ops import attention as at

        device = torch.device("cuda", 0)
        cfg, net, opt = model(device)
        at.reset_launches()
        out = losses(cfg, net, opt, config["lr"], device)
        tune.report({"loss": out[-1], "losses": out,
                     "launches": dict(at.LAUNCHES), "n_layer": cfg.n_layer,
                     "device": str(device),
                     "visible": os.environ.get("CUDA_VISIBLE_DEVICES")})

    return trainable


@pytest.mark.timeout(600)
def test_tiny_llama_trials_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability >= 9.0 (kernels target sm_90a)")
    import ray_tpu_torch as rt
    from ray_tpu_torch import _build, tune
    from ray_tpu_torch.tune.tune_controller import TuneController

    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    lrs = [1e-3, 3e-4]
    device = torch.device("cuda", 0)
    model, losses = _helpers()
    want = {}
    for lr in lrs:
        cfg, net, opt = model(device)
        want[lr] = losses(cfg, net, opt, lr, device)
        del net, opt
    rt.init(num_cpus=4, num_gpus=1)
    try:
        ctl = TuneController(
            _trainable(), searcher=tune.BasicVariantGenerator(
                {"lr": tune.grid_search(lrs)}),
            scheduler=None, metric="loss", mode="min",
            experiment_dir=str(tmp_path), resources_per_trial={"CPU": 1,
                                                                "GPU": 1})
        assert ctl.max_concurrent == 1
        grid = tune.ResultGrid(ctl.run(), "loss", "min")
    finally:
        rt.shutdown()
    assert not grid.errors
    for r in grid:
        m = r.metrics
        assert (m["device"], m["visible"]) == ("cuda:0", "0")
        assert m["launches"] == {k: m["n_layer"] * STEPS for k in (
            "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}
        gaps = [abs(a - b) for a, b in zip(m["losses"], want[r.config["lr"]])]
        assert max(gaps) <= 1e-3, (m["losses"], want[r.config["lr"]])
