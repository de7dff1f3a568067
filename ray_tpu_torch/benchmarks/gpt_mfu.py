"""Train-step benchmark of the port (counterpart of
``ray_tpu/benchmarks/gpt_mfu.py``): tokens per second and MFU of a
next-token training step on one card, for a model family of the engine's
registry (``model``: "gpt", or "llama").

The step is ``loss = model.loss(batch)``, ``loss.backward()``,
``opt.step()``, ``opt.zero_grad(set_to_none=True)`` on f32 master
parameters with ``cfg.dtype`` activations, flash attention through
kernels B1-B3 on a card, and ``torch.optim.AdamW(lr=3e-4, betas=(0.9,
0.95), weight_decay=0.1, eps=1e-8)``: the JAX bench's ``optax.adamw``
(decay on every leaf; decoupled decay, since the update does not depend
on p). Weights are seeded random and the batch is one fixed draw of random
token ids, reused every step.

MFU: 6 * active params * tokens/s over the card's dense bf16 peak
(attention flops excluded, as in the JAX bench). The active parameters
are those one token's forward uses: every parameter of a dense model; an
MoE model's less the experts a token is not routed to
(``llama.llama_active_params``: Llama-125M-MoE uses 143,616,768 of its
370,109,184). The peak table holds the port's own cards; on the CPU MFU
is not reported.

Full width: each family's ``full()`` (``models/families.py``), GPT-2 125M
and Llama-125M; ``config=families.llama_125m_moe()`` (with
``model="llama"``) trains Llama-125M-MoE.

Run: ``python -m ray_tpu_torch.benchmarks.gpt_mfu`` prints one JSON line
(GPT-2 125M, batch 16 x 1024, on ``cuda:0``).
"""
from __future__ import annotations

import dataclasses
import json
import time

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.families import family
from ray_tpu_torch.models.llama import LlamaConfig, llama_active_params

# dense bf16 tensor-core peak by device-name substring (NVIDIA data sheets,
# SXM parts at their full power limit)
CARD_PEAK_TFLOPS = [("H100", 989.0)]

OPTIMIZER = dict(lr=3e-4, betas=(0.9, 0.95), weight_decay=0.1, eps=1e-8)


def card_peak_tflops(device: torch.device) -> float | None:
    """The card's dense bf16 peak, None off the card or for a card the
    table does not know."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for sub, peak in CARD_PEAK_TFLOPS:
        if sub in name:
            return peak
    return None


def bench_batch(cfg, batch_size: int, seq_len: int, seed: int,
                device) -> dict:
    """The bench's fixed batch: [batch_size, seq_len + 1] random token ids
    from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (batch_size, seq_len + 1),
                           generator=gen, device=device)
    return {"tokens": tokens}


def make_optimizer(model) -> torch.optim.Optimizer:
    return torch.optim.AdamW(model.parameters(), **OPTIMIZER)


def train_step(model, opt, batch) -> torch.Tensor:
    """One step; returns the loss (not synchronised)."""
    loss = model.loss(batch)
    loss.backward()
    opt.step()
    opt.zero_grad(set_to_none=True)
    return loss.detach()


def run_gpt_bench(
    batch_size: int = 16,
    seq_len: int = 1024,
    steps: int = 8,
    warmup: int = 2,
    config=None,
    remat: bool = False,
    device=None,
    model: str = "gpt",
) -> dict:
    """Run ``warmup`` then ``steps`` timed train steps on one batch (weights
    from seed 0, tokens from seed 1); returns the losses of every step,
    step time, tokens/s and (on a card) MFU. ``model`` is the family;
    ``config`` names a constructor of its config class (``gpt2_small``,
    ``tiny``) or is a config, None its full width (``Family.full``); a ``seq_len`` past its table grows the positional
    (or rotary) table. Runs on ``cuda:0`` unless ``device`` says
    otherwise."""
    dev = resolve_device(device)
    fam = family(model)
    if config is None:
        cfg = fam.full()
    elif isinstance(config, str):
        cfg = getattr(fam.config, config)()
    else:
        cfg = config
    if not isinstance(cfg, fam.config):
        raise TypeError(f"model={model!r} takes a {fam.config.__name__}, "
                        f"got {type(cfg).__name__}")
    cfg = dataclasses.replace(cfg, remat=remat or cfg.remat,
                              max_seq_len=max(seq_len, cfg.max_seq_len))
    net = fam.init(cfg, seed=0, device=dev, train=True)
    n_params = sum(p.numel() for p in net.parameters())
    n_active = (llama_active_params(cfg) if isinstance(cfg, LlamaConfig)
                else n_params)
    opt = make_optimizer(net)
    batch = bench_batch(cfg, batch_size, seq_len, 1, dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    losses = [train_step(net, opt, batch) for _ in range(warmup)]
    sync()
    t0 = time.perf_counter()
    losses += [train_step(net, opt, batch) for _ in range(steps)]
    sync()
    seconds = time.perf_counter() - t0
    tps = batch_size * seq_len * steps / seconds if steps else 0.0
    peak = card_peak_tflops(dev)
    achieved = 6.0 * n_active * tps / 1e12
    return {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "model": model,
        "n_params": n_params,
        "n_active_params": n_active,
        "batch_size": batch_size,
        "seq_len": seq_len,
        "remat": cfg.remat,
        "warmup": warmup,
        "steps": steps,
        "losses": [float(x) for x in losses],
        "step_ms": 1e3 * seconds / steps if steps else None,
        "tokens_per_s": tps,
        "achieved_tflops": achieved if peak else None,
        "peak_tflops": peak,
        "mfu": achieved / peak if peak else None,
    }


def main() -> None:
    print(json.dumps(run_gpt_bench()), flush=True)


if __name__ == "__main__":
    main()
