"""The port's Train on the card (marked ``gpu``: skips without an NVIDIA
card of compute capability 9.0 or more): ``chip_smoke.trainer_phase``,
Llama-125M at full width through ``TorchTrainer`` in a ``num_gpus=1``
gang, killed after step 5 and resumed from its step-4 checkpoint, every
reported loss against the same loop run in the test's process, B1-B3 12
times a step in the worker, and the cluster whole after ``fit``."""
from __future__ import annotations

import importlib.util
import os

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.mark.timeout(600)
def test_trainer_phase_resumes_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability >= 9.0 (kernels target sm_90a)")
    from ray_tpu_torch import _build

    # loaded from its file and not registered as a module, so the train
    # loop travels to the worker by value, as under python3 chip_smoke.py
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = cs.trainer_phase(torch, cs.card_line())
    steps = cs.TRAINER["die_after"] + cs.TRAINER["steps"] - (
        cs.TRAINER["checkpoint_at"][0])
    assert out["launches"] == {name: 12 * steps for name in (
        "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}
    assert out["death_to_step_s"] > 0
