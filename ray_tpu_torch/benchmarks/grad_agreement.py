"""How far a model's bf16 training gradients through the CUDA kernels
(B1-B3) sit from the same model in f32, beside how far the plain
backend's bf16 gradients sit from it: the control runs from which
``chip_smoke.py``'s gradient gate (``gate``) is derived.

One loss and backward of the model at full width, weights from seed 0,
on each batch given (``gpt_mfu.bench_batch``: [batch, 1025] token ids
from a seed). The models: ``gpt`` (GPT-2 125M), ``llama`` (Llama-125M)
and ``llama_moe`` (Llama-125M-MoE, ``families.llama_125m_moe``). The
default batches are the training phase's first step ([16, 1025] from
seed 1, on which chip_smoke.py checks the gradients) and four [2, 1025]
batches from seeds 1, 5, 6 and 7.

Three runs on the same weights and batch, the backend chosen through the
config: ``cuda`` (the kernels, bf16), ``torch`` (the plain versions,
bf16) and ``f32`` (the plain versions on the model in f32, the reference
that neither bf16 run equals). For every parameter p it records the
relative L2 ``||g - g_f32|| / ||g_f32||`` of the CUDA run (``cuda_f32``)
and of the plain run (``plain_f32``), and the CUDA run against the plain
one (``cuda_plain``). Per run it prints one JSON line with the loss and
the worst and median of each over the parameters, and the gate's worst
reading; with ``--out FILE`` it writes every parameter's three numbers
as JSON.

The gate: for every parameter, ``cuda_f32 <= GATE_RATIO * plain_f32 +
GATE_ABS * median(plain_f32)``: the kernels' gradients are no further
from f32 than bf16's own plain path is, up to 1.1x and an absolute term
scaled by the model's own bf16 spread (the median over its parameters of
the plain path's distance from f32: about 1.1e-2 for GPT-2 125M,
1.9e-2 for Llama-125M, 0.29 for Llama-125M-MoE, whose routes flip
between bf16 and f32). Derived from these control runs on an H100: at 1.1x,
the largest absolute term any parameter needed, with either bf16 path
as the one tested, was 0.140 of that median.

Run on a card from the root of a checkout:
``python -m ray_tpu_torch.benchmarks.grad_agreement --model gpt llama
llama_moe --out grad_controls.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics

import torch

from ray_tpu_torch.benchmarks.gpt_mfu import bench_batch
from ray_tpu_torch.models.families import MODELS, family, full_config

# the gate (module docstring), derived from the control runs
GATE_RATIO = 1.1
GATE_ABS = 0.15  # of the median over the parameters of plain_f32

CONTROL_BATCHES = ((16, 1), (2, 1), (2, 5), (2, 6), (2, 7))  # (batch, seed)


def backend_configs(cfg) -> dict:
    """The three runs' configs: ``cuda`` and ``torch`` in ``cfg.dtype``,
    ``f32`` the plain backend at f32."""
    return {
        "cuda": dataclasses.replace(cfg, attention_backend="cuda"),
        "torch": dataclasses.replace(cfg, attention_backend="torch"),
        "f32": dataclasses.replace(cfg, dtype=torch.float32,
                                   attention_backend="torch"),
    }


def gradients(fam: str, cfg, batch: dict,
              device="cuda") -> tuple[float, dict]:
    """Loss and f32 gradients of one step of the ``fam`` model at ``cfg``
    on ``batch``, weights from seed 0."""
    net = family(fam).init(cfg, seed=0, device=device, train=True)
    loss = net.loss(batch)
    loss.backward()
    return loss.item(), {n: p.grad.float() for n, p in net.named_parameters()}


def rel_l2(got: dict, want: dict) -> dict:
    """Relative L2 ``||got - want|| / ||want||`` of each parameter."""
    return {n: ((got[n] - want[n]).norm() / want[n].norm().clamp(min=1e-30))
            .item() for n in want}


def gate(cuda_f32: dict, plain_f32: dict) -> dict:
    """The gate's reading: the worst parameter's ``cuda_f32`` against its
    bar ``GATE_RATIO * plain_f32 + GATE_ABS * median(plain_f32)``
    (``slack`` = reading / bar; the gate passes at slack <= 1), and the
    largest ratio ``cuda_f32 / plain_f32`` over the parameters."""
    absolute = GATE_ABS * statistics.median(plain_f32.values())
    bars = {n: GATE_RATIO * plain_f32[n] + absolute for n in plain_f32}
    worst = max(bars, key=lambda n: cuda_f32[n] / bars[n])
    ratio = max(plain_f32, key=lambda n: cuda_f32[n]
                / max(plain_f32[n], 1e-30))
    return {"param": worst, "cuda_f32": cuda_f32[worst],
            "plain_f32": plain_f32[worst], "bar": bars[worst],
            "absolute": absolute,
            "slack": cuda_f32[worst] / bars[worst], "ok":
            all(cuda_f32[n] <= bars[n] for n in bars),
            "max_ratio": cuda_f32[ratio] / max(plain_f32[ratio], 1e-30),
            "max_ratio_param": ratio}


def summary(r: dict) -> dict:
    worst = max(r, key=r.get)
    return {"worst": r[worst], "param": worst,
            "median": statistics.median(r.values())}


def controls(name: str, batch: int, seed: int, device="cuda") -> dict:
    """The three runs of model ``name`` on one batch: losses, and every
    parameter's ``cuda_f32``, ``plain_f32`` and ``cuda_plain``."""
    fam, cfg = full_config(name)
    configs = backend_configs(cfg)
    data = bench_batch(configs["cuda"], batch, 1024, seed, device)
    loss, grads = {}, {}
    for run, cfg in configs.items():
        loss[run], grads[run] = gradients(fam, cfg, data, device=device)
        torch.cuda.empty_cache()
    return {"model": name, "batch": batch, "seed": seed, "loss": loss,
            "cuda_f32": rel_l2(grads["cuda"], grads["f32"]),
            "plain_f32": rel_l2(grads["torch"], grads["f32"]),
            "cuda_plain": rel_l2(grads["cuda"], grads["torch"])}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", nargs="+", default=["llama"],
                        choices=sorted(MODELS))
    parser.add_argument("--out", help="write every parameter's readings "
                        "to this JSON file")
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    rows = []
    for name in args.model:
        for batch, seed in CONTROL_BATCHES:
            row = controls(name, batch, seed)
            rows.append(row)
            print("grad agreement: " + json.dumps({
                "model": name, "batch": batch, "seed": seed, "card": card,
                "loss": row["loss"],
                **{k: summary(row[k]) for k in ("cuda_f32", "plain_f32",
                                                "cuda_plain")},
                "gate": gate(row["cuda_f32"], row["plain_f32"])}),
                flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
