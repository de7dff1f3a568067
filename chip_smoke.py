#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card's name and power limit (nvidia-smi) and checks that its
   compute capability is at least 9.0;
2. builds the CUDA kernels from ``ray_tpu_torch/csrc`` and prints the
   build time, and the registers and local (spill) bytes per thread of
   every flash-backward instantiation;
3. holds each kernel against its plain PyTorch version at its path's
   shapes, in bf16 and f32, and times kernel, plain version, one PyTorch
   library call for the same function (SDPA, a yardstick the port never
   calls), the card's bound and the achieved TFLOP/s (the operations
   the bound counts over the kernel's time): the paged kernels B4/B5 at
   the serving shapes, the flash-attention kernels B1-B3 at the training
   shapes (B 16, 12 heads of 64, S 1024, causal and full);
   the quantized variants of B4/B5 on int8 and fp8-e4m3 pools at the
   serving shapes (bf16 q; windowed, G = 2 and f32-q cases for agreement);
4. trains GPT-2 125M at full width and depth (bf16 activations, f32
   masters, seeded random weights, one fixed [16, 1025] batch) through the
   port's ``run_gpt_bench``: the loss must stay finite and fall, and each
   flash kernel must launch 12 layers x steps times; then, on one set of
   weights and a [2, 1025] batch, the loss and every gradient through the
   CUDA kernels against the plain backend;
5. serves 8 requests on GPT-2 125M at full width (bf16, seeded random
   weights) through ``LLMEngine`` and checks every stream, the pool and
   that both kernels' launch counts equal 12 layers x the engine's calls;
6. on the same weights runs one prefill plus decode steps with the CUDA
   kernels and with the plain backend and compares the logits;
7. repeats 5 and 6 with ``quantization="int8"`` and ``"fp8"``: quantized
   weights and pool, the quantized kernels launching 12 layers x calls and
   the unquantized ones never, and the weights' and pool's device bytes
   about half of the bf16 engine's;
8. prints the kernels' JSON line, then ``{"ok": true, "device": ...}`` last.

Any failure raises, so the exit code is not 0. Without a CUDA card, or
outside a checkout, it exits 2 and prints no result. ``--quick`` stops
after one comparison per kernel (a first check of a new kernel);
``--profile`` adds a profiled train step and profiled warm passes of the
bf16 and the int8 engine's requests (device time by kernel, device idle
share, step times).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12              # H100 SXM (NVIDIA data sheet)
PEAK_OPS = {"bfloat16": 989e12,        # dense bf16 tensor cores
            "float32": 67e12,          # f32 outside the tensor cores
            "int8": 1979e12, "fp8": 1979e12}  # dense int8 / fp8 tensor cores
QUANT_KINDS = ("int8", "fp8")
# |kernel - plain| <= atol + rtol * |plain| on the same inputs: f32 differs
# only by the online vs one-shot softmax order; bf16 adds the kernel's bf16
# rounding of exp2 and of the probabilities and one output rounding, so
# bf16 allows two ulps (2 * 2^-7 relative) of the value plus 1e-2
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1.6e-2)}
# max |logits(cuda kernels) - logits(plain backend)| on the bf16 model:
# bf16 attention outputs differ by a few ulps per layer over 12 layers
# (the quantized models too: both backends read the same pool bytes)
LOGIT_TOL = 0.1
# a quantized engine's weights and pool against the bf16 engine's: 1-byte
# data plus f32 scales (pool: hd + 4 bytes a row against 2 hd)
BYTES_RATIO_MAX = 0.55
# training, CUDA kernels vs plain backend on the bf16 model: the two
# attentions differ by bf16 ulps (2^-8 relative rounding) at B1's online
# softmax; through 12 layers forward and back those perturbations stay a
# few rounding units of each gradient's norm, and of the loss
LOSS_TOL = 1e-2        # absolute, on a loss of about 10.8
GRAD_REL_TOL = 2e-2    # ||g_cuda - g_plain|| / ||g_plain||, each parameter

DECODE = dict(B=8, H=12, hd=64, bs=16, num_blocks=1024, max_len=1024)
FLASH = dict(B=16, H=12, S=1024, D=64)   # GPT-2 125M training shapes
TRAIN = dict(batch_size=16, seq_len=1024, warmup=2, steps=4)
PREFILL = dict(B=4, S=512, H=12, hd=64, bs=16, num_blocks=1024, max_len=1024)


def log(*args):
    print(*args, flush=True)


def compare(label: str, got, want, dtype_name: str) -> float:
    """Max |got - want|; raises when any element is outside the tolerance."""
    atol, rtol = TOL[dtype_name]
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    log(f"{label} {dtype_name}: max_abs_err {err:.3e} "
        f"(tol {atol} + {rtol} * |plain|) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} {dtype_name} disagrees with its plain "
                             f"version: max_abs_err {err}")
    return err


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------- timing

class Timer:
    """Median device time of one call, L2 flushed before each call (the
    serving path finds each layer's K/V cold: 12 layers of pool outgrow
    the 50 MB L2)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")

    def __call__(self, fn, iters: int = 20) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


# ------------------------------------------------------------- kernel inputs

def make_pool(torch, gen, dtype, num_blocks, bs, H, hd):
    k = torch.randn(num_blocks, bs, H, hd, generator=gen, device="cuda")
    v = torch.randn(num_blocks, bs, H, hd, generator=gen, device="cuda")
    return k.to(dtype), v.to(dtype)


def make_tables(torch, gen, B, NB, used):
    """[B, NB] int32 tables: row b holds used[b] distinct shuffled blocks
    from 1.., the rest padded with block 0."""
    perm = torch.randperm(B * NB, generator=gen, device="cuda") + 1
    tables = torch.zeros(B, NB, dtype=torch.int32, device="cuda")
    for b in range(B):
        tables[b, : used[b]] = perm[b * NB: b * NB + used[b]].to(torch.int32)
    return tables


def decode_case(torch, dtype):
    c = DECODE
    gen = torch.Generator(device="cuda").manual_seed(1)
    B, H, hd, bs = c["B"], c["H"], c["hd"], c["bs"]
    NB = c["max_len"] // bs
    # mixed lengths up to the model's 1024
    lengths = [1024, 900, 700, 512, 333, 200, 64, 30]
    pos = torch.tensor([n - 1 for n in lengths], dtype=torch.int32,
                       device="cuda")
    tables = make_tables(torch, gen, B, NB, [-(-n // bs) for n in lengths])
    k, v = make_pool(torch, gen, dtype, c["num_blocks"], bs, H, hd)
    q = torch.randn(B, H, hd, generator=gen, device="cuda").to(dtype)
    return dict(q=q, k=k, v=v, tables=tables, pos=pos, lengths=lengths)


def prefill_case(torch, dtype, starts):
    c = PREFILL
    gen = torch.Generator(device="cuda").manual_seed(2)
    B, S, H, hd, bs = c["B"], c["S"], c["H"], c["hd"], c["bs"]
    NB = c["max_len"] // bs
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    pos = (st[:, None] + torch.arange(S, device="cuda", dtype=torch.int32))
    tables = make_tables(torch, gen, B, NB,
                         [-(-(s + S) // bs) for s in starts])
    k, v = make_pool(torch, gen, dtype, c["num_blocks"], bs, H, hd)
    q = torch.randn(B, S, H, hd, generator=gen, device="cuda").to(dtype)
    return dict(q=q, k=k, v=v, tables=tables, pos=pos.contiguous(),
                starts=starts)


def decode_bound(x, dtype_name, esize, kv_row=None):
    """kv_row: bytes of one (token, head) row of K or V, hd * esize
    unquantized, hd + 4 (1-byte data and an f32 scale) quantized; ops at
    the peak rate of ``dtype_name``, the pool's type."""
    B, H, hd = x["q"].shape
    tokens = sum(x["lengths"])
    kv_row = kv_row or hd * esize
    nbytes = (tokens * H * kv_row * 2 + 2 * B * H * hd * esize
              + x["tables"].numel() * 4 + B * 4)
    ops = 4 * hd * H * tokens
    return bound(nbytes, ops, dtype_name) + (ops,)


def prefill_bound(x, dtype_name, esize, kv_row=None):
    B, S, H, hd = x["q"].shape
    pairs = sum((s + i + 1) for s in x["starts"] for i in range(S)) * H
    ctx = sum(s + S for s in x["starts"])
    kv_row = kv_row or hd * esize
    nbytes = (ctx * H * kv_row * 2 + 2 * B * S * H * hd * esize
              + x["tables"].numel() * 4 + B * S * 4)
    ops = 4 * hd * pairs
    return bound(nbytes, ops, dtype_name) + (ops,)


def bound(nbytes, ops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tflops(ops, ms):
    """Achieved rate: the operations the bound counts over the time."""
    return ops / (ms * 1e-3) / 1e12


def dense_sdpa_inputs(torch, q4, k, v, tables, pos):
    """q [B, S, H, hd] -> SDPA inputs over the gathered dense context,
    mask t <= pos; gathered once here, outside the timed call."""
    from ray_tpu_torch.ops.kv_cache import gather_kv

    # a quantized pool gathers dequantized (f32), then takes q's dtype
    keys, values = (t.to(q4.dtype) for t in gather_kv(k, v, tables))
    T = keys.shape[1]                                # keys [B, T, H, hd]
    mask = (torch.arange(T, device="cuda")[None, None, :]
            <= pos.long()[:, :, None])[:, None]      # [B, 1, S, T]
    return (q4.transpose(1, 2).contiguous(), keys.transpose(1, 2).contiguous(),
            values.transpose(1, 2).contiguous(), mask)


def quantize_pool(k, v, kind):
    from ray_tpu_torch.ops.quantization import QuantizedKV, quantize_kv

    return tuple(QuantizedKV(*quantize_kv(x, kind)) for x in (k, v))


def kernels_phase(torch, quick: bool, kind=None) -> dict:
    """B4/B5 against their plain versions at the serving shapes, bf16 and
    f32 q, timed (with ``kind``: their quantized variants on a pool of
    that kind quantized from the same random K/V, timed with bf16 q, the
    serving dtype); a window and G = 2 (6 kv heads) for agreement only."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.ops.kv_cache import (
        paged_attention,
        paged_prefill_attention,
    )

    timer = None if quick else Timer(torch)
    suffix = f"_{kind}" if kind else ""
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        esize = torch.empty(0, dtype=dtype).element_size()
        timed = timer is not None and (kind is None or dtype == torch.bfloat16)
        # the bound's pool row (quantized: 1-byte data and an f32 scale) and
        # the peak rate of the pool's type
        kv_row = DECODE["hd"] + 4 if kind else None
        ops_type = kind or name

        def pool(x, heads=DECODE["H"]):
            k, v = (t[:, :, :heads].contiguous() for t in (x["k"], x["v"]))
            return quantize_pool(k, v, kind) if kind else (k, v)

        kname = "paged_decode" + suffix
        x = decode_case(torch, dtype)
        args = (x["q"], *pool(x), x["tables"], x["pos"])
        got = pa.paged_attention_cuda(*args)
        torch.cuda.synchronize()
        row = {"max_abs_err": compare(kname, got, paged_attention(*args),
                                      name)}
        if timed:
            sq, sk, sv, mask = dense_sdpa_inputs(
                torch, x["q"][:, None], *args[1:3], x["tables"],
                x["pos"][:, None])
            row["ms"] = timer(lambda: pa.paged_attention_cuda(*args))
            row["plain_ms"] = timer(lambda: paged_attention(*args))
            row["library_ms"] = timer(
                lambda: F.scaled_dot_product_attention(sq, sk, sv,
                                                       attn_mask=mask))
            row["bound_ms"], row["bound_by"], ops = decode_bound(
                x, ops_type, esize, kv_row)
            row["tflops"] = tflops(ops, row["ms"])
            log(f"{kname} {name}: {json.dumps(row)}")
            del sq, sk, sv, mask
        rows[(kname, name)] = row
        args = (x["q"], *pool(x, DECODE["H"] // 2), x["tables"], x["pos"])
        compare(f"{kname} G=2", pa.paged_attention_cuda(*args),
                paged_attention(*args), name)
        del x, args

        kname = "paged_prefill" + suffix
        for label, starts in (("fresh", [0, 0, 0, 0]),
                              ("ragged", [37, 100, 256, 500])):
            x = prefill_case(torch, dtype, starts)
            args = (x["q"], *pool(x), x["tables"], x["pos"])
            got = pa.paged_prefill_attention_cuda(*args)
            torch.cuda.synchronize()
            row = {"max_abs_err": compare(
                f"{kname} {label}", got, paged_prefill_attention(*args),
                name)}
            if timed:
                sq, sk, sv, mask = dense_sdpa_inputs(
                    torch, x["q"], *args[1:3], x["tables"], x["pos"])
                row["ms"] = timer(
                    lambda: pa.paged_prefill_attention_cuda(*args))
                row["plain_ms"] = timer(lambda: paged_prefill_attention(*args))
                row["library_ms"] = timer(
                    lambda: F.scaled_dot_product_attention(
                        sq, sk, sv, attn_mask=mask))
                row["bound_ms"], row["bound_by"], ops = prefill_bound(
                    x, ops_type, esize, kv_row)
                row["tflops"] = tflops(ops, row["ms"])
                log(f"{kname} {name} {label}: {json.dumps(row)}")
                del sq, sk, sv, mask
            rows[(kname, name, label)] = row
        # on the ragged case: a window (no engine path), and G = 2
        for heads in (DECODE["H"], DECODE["H"] // 2):
            args = (x["q"], *pool(x, heads), x["tables"], x["pos"])
            g = DECODE["H"] // heads
            compare(f"{kname} G={g} window=200",
                    pa.paged_prefill_attention_cuda(*args, window=200),
                    paged_prefill_attention(*args, window=200), name)
        compare(f"{kname} G=2", pa.paged_prefill_attention_cuda(*args),
                paged_prefill_attention(*args), name)
        del x, args
    return rows


# ------------------------------------------------------- flash attention

def flash_bounds(dtype_name, esize, causal) -> dict:
    """Bound of each flash kernel at FLASH and the operations it counts:
    every input read once, every output written once; 2 * D flops per
    product per visible pair (B1 two products, B2 four, B3 three)."""
    c = FLASH
    B, H, S, D = c["B"], c["H"], c["S"], c["D"]
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    t = B * H * S * D * esize          # one [B, H, S, D] tensor
    r = B * H * S * 4                  # one [B, H, S] f32 vector
    work = {"flash_fwd": (4 * t + r, 4 * D * pairs),
            "flash_bwd_dkv": (6 * t + 2 * r, 8 * D * pairs),
            "flash_bwd_dq": (5 * t + 2 * r, 6 * D * pairs)}
    return {name: bound(nbytes, ops, dtype_name) + (ops,)
            for name, (nbytes, ops) in work.items()}


def flash_phase(torch, quick: bool) -> dict:
    """B1-B3 against their plain versions at the training shapes, causal
    (rows keyed (kernel, dtype)) and full (keyed (kernel, dtype, "full"));
    the backward kernels read the plain forward's o and lse, so each kernel
    is held alone."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as at

    c = FLASH
    timer = None if quick else Timer(torch)
    scale = c["D"] ** -0.5
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        esize = torch.empty(0, dtype=dtype).element_size()
        gen = torch.Generator(device="cuda").manual_seed(3)
        q, k, v, do = (torch.randn(c["B"], c["H"], c["S"], c["D"],
                                   generator=gen, device="cuda").to(dtype)
                       for _ in range(4))
        for causal in (True, False):
            kw = dict(causal=causal, scale=scale)
            label = "causal" if causal else "full"
            o, lse = at.flash_forward_cuda(q, k, v, **kw)
            o_ref, lse_ref = at.flash_forward_reference(q, k, v, **kw)
            delta = at.attention_delta(o_ref, do)
            bargs = (q, k, v, lse_ref, delta, do)
            dk, dv = at.flash_bwd_dkv_cuda(*bargs, **kw)
            dq = at.flash_bwd_dq_cuda(*bargs, **kw)
            torch.cuda.synchronize()
            dk_ref, dv_ref = at.flash_bwd_dkv_reference(*bargs, **kw)
            dq_ref = at.flash_bwd_dq_reference(*bargs, **kw)

            def cmp(what, got, want):
                return compare(f"{what} {label}", got, want, name)

            errs = {
                "flash_fwd": max(cmp("flash_fwd o", o, o_ref),
                                 cmp("flash_fwd lse", lse, lse_ref)),
                "flash_bwd_dkv": max(cmp("flash_bwd_dkv dk", dk, dk_ref),
                                     cmp("flash_bwd_dkv dv", dv, dv_ref)),
                "flash_bwd_dq": cmp("flash_bwd_dq dq", dq, dq_ref),
            }
            del o, lse, dk, dv, dq, dk_ref, dv_ref, dq_ref
            key = () if causal else ("full",)  # full: ViT's path
            for kname, err in errs.items():
                rows[(kname, name) + key] = {"max_abs_err": err}
            if timer is None:
                continue
            fns = {
                "flash_fwd": (
                    lambda: at.flash_forward_cuda(q, k, v, **kw),
                    lambda: at.flash_forward_reference(q, k, v, **kw)),
                "flash_bwd_dkv": (
                    lambda: at.flash_bwd_dkv_cuda(*bargs, **kw),
                    lambda: at.flash_bwd_dkv_reference(*bargs, **kw)),
                "flash_bwd_dq": (
                    lambda: at.flash_bwd_dq_cuda(*bargs, **kw),
                    lambda: at.flash_bwd_dq_reference(*bargs, **kw)),
            }
            # library yardstick: SDPA forward, and SDPA's backward through
            # autograd, which computes B2's and B3's work together
            lq, lk, lv = (t.detach().clone().requires_grad_()
                          for t in (q, k, v))
            lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)
            library = {
                "flash_fwd": timer(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal)),
                "flash_bwd_dkv": timer(lambda: torch.autograd.grad(
                    lo, (lq, lk, lv), do, retain_graph=True)),
            }
            library["flash_bwd_dq"] = library["flash_bwd_dkv"]
            del lo, lq, lk, lv
            bounds = flash_bounds(name, esize, causal)
            for kname, (kern, plain) in fns.items():
                row = rows[(kname, name) + key]
                row["ms"] = timer(kern)
                row["plain_ms"] = timer(plain)
                row["library_ms"] = library[kname]
                row["bound_ms"], row["bound_by"], ops = bounds[kname]
                row["tflops"] = tflops(ops, row["ms"])
                log(f"{kname} {name} {label}: {json.dumps(row)}")
    return rows


def flash_bwd_registers() -> None:
    """Registers and local (spill) bytes per thread of every B2/B3
    instantiation, as the built library reports them."""
    import ctypes

    from ray_tpu_torch import _build

    fn = _build.bind("flash_bwd", "flash_bwd_attributes", "iiip")
    out = (ctypes.c_int * 2)()
    parts = []
    for kname, dkv in (("flash_bwd_dkv", 1), ("flash_bwd_dq", 0)):
        for dtype_name, code in (("bfloat16", 1), ("float32", 0)):
            for D in (32, 64, 128):
                _build.raise_on("flash_bwd", kname, fn(dkv, D, code, out))
                parts.append(f"{kname} {dtype_name} D={D} {out[0]}/{out[1]}")
    log("flash backward registers / local bytes per thread: "
        + "; ".join(parts))


# ---------------------------------------------------------------- training

def train_phase(torch) -> dict:
    """GPT-2 125M train steps through the port's entry point; checks the
    losses and that each flash kernel ran once per layer and step."""
    import math

    from ray_tpu_torch.benchmarks.gpt_mfu import run_gpt_bench
    from ray_tpu_torch.models.gpt import GPTConfig
    from ray_tpu_torch.ops import attention as at

    n_layer = GPTConfig.gpt2_small().n_layer
    at.reset_launches()
    out = run_gpt_bench(config="gpt2_small", **TRAIN)
    launches = dict(at.LAUNCHES)
    want = {name: n_layer * (TRAIN["warmup"] + TRAIN["steps"])
            for name in launches}
    losses = out["losses"]
    log(f"train: GPT-2 {out['n_params']} params, batch {out['batch_size']} "
        f"x {out['seq_len']}, {out['steps']} timed steps: step "
        f"{out['step_ms']:.2f} ms, {out['tokens_per_s']:.1f} tokens/s, "
        f"MFU {out['mfu']} (peak {out['peak_tflops']} TFLOP/s); losses "
        f"{[round(x, 4) for x in losses]}; launches {launches} "
        f"(expected {want})")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall on one batch: {losses}")
    if launches != want or min(launches.values()) == 0:
        raise AssertionError(f"launch counts {launches} != {want}")
    out["launches"] = launches
    return out


def loss_phase(torch, timer) -> float:
    """Time of the fused lm-head + loss (forward with its closed-form
    gradients) on one step's tokens: the lm-head/loss share of a step."""
    from ray_tpu_torch.models.gpt import GPTConfig
    from ray_tpu_torch.ops.loss import fused_lm_head_loss

    cfg = GPTConfig.gpt2_small()
    gen = torch.Generator(device="cuda").manual_seed(4)
    n = TRAIN["batch_size"] * TRAIN["seq_len"]
    x = torch.randn(n, cfg.d_model, generator=gen, device="cuda").to(cfg.dtype)
    w = 0.02 * torch.randn(cfg.vocab_size, cfg.d_model, generator=gen,
                           device="cuda")
    t = torch.randint(0, cfg.vocab_size, (n,), generator=gen, device="cuda")
    ms = timer(lambda: fused_lm_head_loss(x, w, t), iters=5)
    log(f"fused lm-head loss, {n} tokens x vocab {cfg.vocab_size}: {ms:.3f} ms")
    return ms


def train_backends_phase(torch) -> dict:
    """Loss and every gradient of one step through the CUDA kernels against
    the plain backend, same weights, a [2, 1025] batch."""
    from ray_tpu_torch.benchmarks.gpt_mfu import bench_batch
    from ray_tpu_torch.models.gpt import GPT, GPTConfig, gpt_init

    cfg = dataclasses.replace(GPTConfig.gpt2_small(), attention_backend="cuda")
    models = {"cuda": gpt_init(cfg, seed=0, device="cuda", train=True)}
    models["torch"] = GPT(dataclasses.replace(cfg, attention_backend="torch"),
                          "cuda", train=True)
    models["torch"].load_state_dict(models["cuda"].state_dict())
    batch = bench_batch(cfg, 2, 1024, 5, "cuda")
    loss, grads = {}, {}
    for name, m in models.items():
        value = m.loss(batch)
        value.backward()
        loss[name] = value.item()
        grads[name] = {n: p.grad for n, p in m.named_parameters()}
    dloss = abs(loss["cuda"] - loss["torch"])
    rel = {}
    for n, want in grads["torch"].items():
        diff = (grads["cuda"][n] - want).float().norm()
        rel[n] = (diff / want.float().norm().clamp(min=1e-30)).item()
    worst = max(rel, key=rel.get)
    log(f"train cuda vs torch backend: loss {loss['cuda']:.6f} vs "
        f"{loss['torch']:.6f} (|diff| {dloss:.3e}, tol {LOSS_TOL}); worst "
        f"gradient rel L2 {rel[worst]:.3e} ({worst}; tol {GRAD_REL_TOL}; "
        f"median {statistics.median(rel.values()):.3e})")
    if not dloss <= LOSS_TOL:
        raise AssertionError(f"losses disagree: {loss}")
    if not rel[worst] <= GRAD_REL_TOL:
        raise AssertionError(f"gradient {worst} disagrees: {rel[worst]}")
    return {"loss_diff": dloss, "grad_rel": rel[worst]}


def device_rows(prof):
    """Device-side entries (kernels, copies, memsets) of a profile, by
    total time: the host ops that launched them report the same time."""
    from torch.autograd import DeviceType

    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return sorted(rows, reverse=True)


def profile_train(torch) -> None:
    """Two warm GPT-2 train steps under torch.profiler: device time by
    kernel and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.benchmarks.gpt_mfu import (
        bench_batch,
        make_optimizer,
        train_step,
    )
    from ray_tpu_torch.models.gpt import GPTConfig, gpt_init

    cfg = GPTConfig.gpt2_small()
    model = gpt_init(cfg, seed=0, device="cuda", train=True)
    opt = make_optimizer(model)
    batch = bench_batch(cfg, TRAIN["batch_size"], TRAIN["seq_len"], 1, "cuda")
    for _ in range(2):
        train_step(model, opt, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            train_step(model, opt, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = device_rows(prof)
    busy_ms = sum(r[0] for r in rows) / 1e3
    log(f"profile train (2 steps): wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms (idle share {1 - busy_ms / wall_ms:.3f})")
    for us, count, key in rows[:25]:
        log(f"  {us / 1e3:9.3f} ms {100 * us / 1e3 / busy_ms:5.1f}% "
            f"x{count:<6d} {key[:110]}")


# ---------------------------------------------------------------- engine

def serve(torch, engine, prompts, params) -> dict:
    """Submit every request, step the engine until idle; per-step host
    times by kind (each step ends in its token sync, so the device work
    of the step is done when it returns)."""
    steps = {"prefill": [], "decode": []}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = [engine.submit(p, s) for p, s in zip(prompts, params)]
    while True:
        ts = time.perf_counter()
        if not engine.step():
            break
        steps[engine.last_step_kind].append(time.perf_counter() - ts)
    torch.cuda.synchronize()
    return {"outs": [list(s) for s in streams],
            "seconds": time.perf_counter() - t0, "steps": steps}


def weight_bytes(model) -> int:
    """Device bytes of a model's weights (quantized: data and scales)."""
    from ray_tpu_torch.ops.quantization import QuantizedTensor

    return sum(w.nbytes() if isinstance(w, QuantizedTensor)
               else w.numel() * w.element_size()
               for w in model.weights().values())


def engine_phase(torch, quant=None) -> dict:
    """The engine workload (``quant``: None for bf16, or a quantization
    kind); each path's kernels must launch 12 layers x its calls, every
    other paged kernel never."""
    import numpy as np

    from ray_tpu_torch.models.gpt import GPTConfig
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine, SamplingParams

    cfg = GPTConfig.gpt2_small()
    engine = LLMEngine(
        EngineConfig(model_config=cfg, block_size=16, num_blocks=1024,
                     max_batch_size=8, prefill_chunk_tokens=256, seed=0,
                     quantization=quant),
        auto_step=False,
    )
    assert engine.device.type == "cuda", engine.device
    assert engine.executor.quantization == quant
    tag = f"engine[{quant or 'bf16'}]"
    suffix = f"_{quant}" if quant else ""
    rng = np.random.default_rng(0)
    lengths = [30, 64, 120, 200, 333, 512, 700, 900]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    params = [SamplingParams(max_new_tokens=32) for _ in prompts]
    params[3] = SamplingParams(max_new_tokens=32, temperature=0.8, top_p=0.9,
                               seed=7)
    # warm-up pass over the same requests (cuBLAS handles, lazily loaded
    # modules, allocator); its launches are not counted
    warm = serve(torch, engine, prompts, params)
    pf0, dec0 = engine.num_prefill_calls, engine.num_decode_steps
    pa.reset_launches()
    run = serve(torch, engine, prompts, params)
    launches = dict(pa.LAUNCHES)
    prefill_calls = engine.num_prefill_calls - pf0
    decode_steps = engine.num_decode_steps - dec0
    outs = run["outs"]
    for o in outs:
        if len(o) != 32 or not all(0 <= t < cfg.vocab_size for t in o):
            raise AssertionError(f"bad stream {o}")
    if outs != warm["outs"]:
        raise AssertionError("a second pass over the same requests differs")
    c = engine.cache
    if c.free_blocks != c.cfg.usable_blocks or c.reserved_blocks != 0:
        raise AssertionError(
            f"pool not whole: {c.free_blocks} free of {c.cfg.usable_blocks}, "
            f"{c.reserved_blocks} reserved")
    want = dict.fromkeys(launches, 0)
    want["paged_decode" + suffix] = cfg.n_layer * decode_steps
    want["paged_prefill" + suffix] = cfg.n_layer * prefill_calls
    ntok = sum(map(len, outs))
    steps = run["steps"]
    nbytes = {"weights": weight_bytes(engine.executor.model),
              "pool": c.nbytes()}
    log(f"{tag}: {len(outs)} requests, {ntok} tokens in "
        f"{run['seconds']:.3f} s = {ntok / run['seconds']:.1f} tokens/s "
        f"(first pass {warm['seconds']:.3f} s); {prefill_calls} prefill "
        f"calls, mean {1e3 * statistics.mean(steps['prefill']):.2f} ms; "
        f"{decode_steps} decode steps, mean "
        f"{1e3 * statistics.mean(steps['decode']):.2f} ms; device bytes "
        f"{nbytes}; launches {launches} (expected {want})")
    if launches != want or min(prefill_calls, decode_steps) == 0:
        raise AssertionError(f"launch counts {launches} != {want}")
    log(f"{tag} first tokens: {[o[:4] for o in outs]}")
    return {"engine": engine, "launches": launches, "prompts": prompts,
            "params": params, "bytes": nbytes,
            "tokens_per_s": ntok / run["seconds"]}


def profile_phase(torch, eng) -> None:
    """One more warm pass over the same requests under torch.profiler:
    device time by kernel, the device's busy share of the wall time, the
    step times by kind, device launches per step and host ops by CPU
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run = serve(torch, eng["engine"], eng["prompts"], eng["params"])
    rows = device_rows(prof)
    busy_ms = sum(r[0] for r in rows) / 1e3
    wall_ms = run["seconds"] * 1e3
    quant = eng["engine"].executor.quantization
    log(f"profile [{quant or 'bf16'}]: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms "
        f"(idle share {1 - busy_ms / wall_ms:.3f}); steps "
        + ", ".join(f"{k} n={len(v)} mean {1e3 * statistics.mean(v):.2f} ms"
                    for k, v in run["steps"].items()))
    for us, count, key in rows[:20]:
        log(f"  {us / 1e3:9.3f} ms {100 * us / 1e3 / busy_ms:5.1f}% "
            f"x{count:<6d} {key[:110]}")
    # the host side: device launches per step, and host ops by self CPU
    # time (profiler overhead included, so read the shares, not the ms)
    nsteps = sum(len(v) for v in run["steps"].values())
    host = sorted(((e.self_cpu_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU
                   and e.self_cpu_time_total > 0), reverse=True)
    host_ms = sum(h[0] for h in host) / 1e3
    log(f"profile host: {sum(r[1] for r in rows) / nsteps:.1f} device "
        f"launches per step; host ops {host_ms:.1f} ms self CPU time")
    for us, count, key in host[:15]:
        log(f"  {us / 1e3:9.3f} ms {100 * us / 1e3 / host_ms:5.1f}% "
            f"x{count:<6d} {key[:110]}")


def backends_phase(torch, engine) -> float:
    """Same weights and inputs through the CUDA kernels and through the
    plain backend: one fresh prefill, then decode steps."""
    import numpy as np

    from ray_tpu_torch.models.gpt import GPT
    from ray_tpu_torch.serve.llm.kv_cache import KVCacheConfig, PagedKVCache

    base = engine.executor.model
    models = {}
    for backend in ("cuda", "torch"):
        m = GPT(dataclasses.replace(base.cfg, attention_backend=backend),
                base.device)
        m.load_weights(base.weights())
        models[backend] = m
    cfg = base.cfg
    B, S, bs, steps = 2, 320, 16, 4
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                             dtype=torch.int32, device="cuda")
    lengths = torch.tensor([S, 250], dtype=torch.int32, device="cuda")
    nb = (S + steps + bs - 1) // bs + 1
    tables = torch.arange(1, B * nb + 1, dtype=torch.int32,
                          device="cuda").reshape(B, nb)
    logits = {}
    for backend, m in models.items():
        cache = PagedKVCache(KVCacheConfig(
            n_layer=cfg.n_layer, n_kv_head=cfg.n_head, head_dim=cfg.head_dim,
            num_blocks=B * nb + 1, block_size=bs, dtype=cfg.dtype,
            device="cuda", quantization=cfg.quantization))
        out, _, _ = m.prefill(cache.k, cache.v, tokens, lengths, tables)
        seq = [out]
        nxt = out.argmax(-1).to(torch.int32)
        pos = lengths.clone()
        for _ in range(steps):
            out, _, _ = m.decode_step(cache.k, cache.v, nxt, pos, tables)
            seq.append(out)
            nxt = out.argmax(-1).to(torch.int32)
            pos = pos + 1
        logits[backend] = torch.stack(seq)
    if not torch.isfinite(logits["cuda"]).all():
        raise AssertionError("non-finite logits from the CUDA path")
    diff = (logits["cuda"] - logits["torch"]).abs().max().item()
    scale = logits["torch"].abs().max().item()
    log(f"logits cuda vs torch backend [{cfg.quantization or 'bf16'}]: "
        f"max_abs_diff {diff:.3e} (tol {LOGIT_TOL}; max |logit| "
        f"{scale:.3f})")
    if not diff <= LOGIT_TOL:
        raise AssertionError(f"backends disagree: {diff}")
    return diff


# ------------------------------------------------------------------ main

def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--quick", action="store_true",
                        help="build and compare each kernel once, then stop")
    parser.add_argument("--profile", action="store_true",
                        help="also profile a warm engine pass")
    args = parser.parse_args()
    if not os.path.isdir(os.path.join(HERE, "ray_tpu_torch", "csrc")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs a card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from ray_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    log(f"card: {card}; capability {cap}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if cap < (9, 0):
        raise AssertionError(f"needs compute capability >= 9.0, got {cap}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(_build.sources())})")

    flash_bwd_registers()
    rows = kernels_phase(torch, args.quick)
    for kind in QUANT_KINDS:
        rows.update(kernels_phase(torch, args.quick, kind))
    frows = flash_phase(torch, args.quick)
    if args.quick:
        log(card)
        return 0
    train = train_phase(torch)
    loss_phase(torch, Timer(torch))
    train_backends_phase(torch)
    # the paged kernels' launches, each from the engine whose path runs it
    eng = engine_phase(torch)
    launches = {n: eng["launches"][n] for n in ("paged_decode", "paged_prefill")}
    base_bytes = eng["bytes"]
    backends_phase(torch, eng["engine"])
    if args.profile:
        profile_train(torch)
        profile_phase(torch, eng)
    for kind in QUANT_KINDS:
        del eng  # one engine's weights and pool at a time
        torch.cuda.empty_cache()
        eng = engine_phase(torch, kind)
        for base in ("paged_decode", "paged_prefill"):
            launches[f"{base}_{kind}"] = eng["launches"][f"{base}_{kind}"]
        ratio = {n: eng["bytes"][n] / base_bytes[n] for n in base_bytes}
        log(f"engine[{kind}] device bytes / bf16 engine's: "
            f"{ {n: round(r, 4) for n, r in ratio.items()} } "
            f"(max {BYTES_RATIO_MAX})")
        if max(ratio.values()) > BYTES_RATIO_MAX:
            raise AssertionError(f"{kind} engine bytes not halved: {ratio}")
        backends_phase(torch, eng["engine"])
        if args.profile and kind == "int8":
            profile_phase(torch, eng)

    kernels = []
    paged = [(base + suffix, base) for base in ("paged_decode", "paged_prefill")
             for suffix in ("", "_int8", "_fp8")]
    for name, base in paged:
        # prefill: the fresh case, the ragged one beside it
        case = ("fresh",) if base == "paged_prefill" else ()
        r = rows[(name, "bfloat16") + case]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"ray_tpu_torch/csrc/{base}.cu",
            "replaces": "ray_tpu/ops/paged_attention.py:"
                        + ("104" if base == "paged_decode" else "322"),
            "launches": launches[name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "tflops": r["tflops"],
            "f32": rows[(name, "float32") + case],
        })
        if case:
            kernels[-1]["ragged"] = rows[(name, "bfloat16", "ragged")]
    for name, replaces, source in (
        ("flash_fwd", "ray_tpu/ops/attention.py:129", "flash_fwd.cu"),
        ("flash_bwd_dkv", "ray_tpu/ops/attention.py:288", "flash_bwd.cu"),
        ("flash_bwd_dq", "ray_tpu/ops/attention.py:374", "flash_bwd.cu"),
    ):
        r = frows[(name, "bfloat16")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"ray_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": train["launches"][name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "tflops": r["tflops"],
            "f32": frows[(name, "float32")],
            "full": frows[(name, "bfloat16", "full")],
            "full_f32": frows[(name, "float32", "full")],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
