"""How far a model family's bf16 training gradients through the CUDA
kernels (B1-B3) sit from the plain backend's, beside how far each sits
from the same model in f32: one loss and backward of the family at full
width (``Family.full``), weights from seed 0, a [batch, 1025] batch from
each seed given (``gpt_mfu.bench_batch``). The defaults, 16 sequences
from seed 1, are the training phase's first step, on which chip_smoke.py
checks the gradients.

Three runs on the same weights and batch, the backend chosen through the
config: ``cuda`` (the kernels, bf16), ``torch`` (the plain versions,
bf16) and ``f32`` (the plain versions on the model in f32, the control
that neither bf16 run equals). For each run it prints one JSON line with
the loss and, against the plain backend's gradients and against the f32
model's, the worst gradient's relative L2 ||g - g_ref|| / ||g_ref||
(with its parameter) and the median over parameters.

Run on a card from the root of a checkout:
``python -m ray_tpu_torch.benchmarks.grad_agreement --model llama``
(``--batch 2 --seeds 5 6`` for smaller batches from other seeds).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics

import torch

from ray_tpu_torch.benchmarks.gpt_mfu import bench_batch
from ray_tpu_torch.models.families import family


def gradients(cfg, model: str, seed: int, batch: int,
              device) -> tuple[float, dict]:
    """Loss and f32 gradients of one step of ``model`` at ``cfg``."""
    net = family(model).init(cfg, seed=0, device=device, train=True)
    loss = net.loss(bench_batch(cfg, batch, 1024, seed, device))
    loss.backward()
    return loss.item(), {n: p.grad.float() for n, p in net.named_parameters()}


def rel_l2(got: dict, want: dict) -> dict:
    """Worst (with its parameter) and median relative L2 over parameters."""
    r = {n: ((got[n] - want[n]).norm() / want[n].norm().clamp(min=1e-30))
         .item() for n in want}
    worst = max(r, key=r.get)
    return {"worst": r[worst], "param": worst,
            "median": statistics.median(r.values())}


def agreement(model: str, seed: int, batch: int,
              device="cuda") -> list[dict]:
    base = family(model).full()
    configs = {
        "cuda": dataclasses.replace(base, attention_backend="cuda"),
        "torch": dataclasses.replace(base, attention_backend="torch"),
        "f32": dataclasses.replace(base, dtype=torch.float32,
                                   attention_backend="torch"),
    }
    runs = {name: gradients(cfg, model, seed, batch, device)
            for name, cfg in configs.items()}
    return [{"model": model, "seed": seed, "batch": batch, "run": name,
             "loss": loss,
             "vs_plain": rel_l2(g, runs["torch"][1]),
             "vs_f32": rel_l2(g, runs["f32"][1])}
            for name, (loss, g) in runs.items()]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", default="llama", choices=("gpt", "llama"))
    parser.add_argument("--seeds", type=int, nargs="+", default=[1],
                        help="seeds of the batch")
    parser.add_argument("--batch", type=int, default=16,
                        help="sequences of 1025 tokens in the batch")
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    for seed in args.seeds:
        for row in agreement(args.model, seed, args.batch):
            print("grad agreement: " + json.dumps(dict(row, card=card)),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
