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
   B4 and its int8 variant also on one 4096-token sequence (bf16 q), with
   the number of split-K ranges the wrapper launched printed for each case;
   for agreement only, B4/B5 (and their quantized variants) at head dims
   100 and 72 (pools padded to 16-byte rows) and, at small B and G 3,
   288 and 512 (the column-chunked walk), B1-B3 at head dims 160
   (padded to 256), 256, 264 and 512 (column chunks of 256), and B4/B5
   and their quantized variants at the prefix path's shapes (a one-token
   chunk at 575, a suffix chunk at 512, decode over shared blocks);
4. trains GPT-2 125M at full width and depth (bf16 activations, f32
   masters, seeded random weights, one fixed [16, 1025] batch) through the
   port's ``run_gpt_bench``: the loss must stay finite and fall, and each
   flash kernel must launch 12 layers x steps times;
5. serves 8 requests on GPT-2 125M at full width (bf16, seeded random
   weights) through ``LLMEngine`` (prefix caching off: each pass repeats
   the same prompts), whose decode loop runs at lag 1 from
   one captured CUDA graph per decode signature, and checks every stream
   (the same in a second pass), the pool, and that every decode step of
   the second pass replayed a graph (the wrappers launching B5 eagerly,
   B4 never); then in a third pass, traced by ``torch.profiler`` with
   the counts reset just before it, that both kernels launched on the
   device 12 layers x the engine's calls (12 B4 launches from the graph
   per decode step), read from the trace by kernel symbol; prints the
   graphs captured and the capture seconds, tokens/s, the mean
   decode step, the device idle share of a profiled pass, and for a
   window of decode steps alone the host launch API calls per step beside
   the device kernels per step (``benchmarks/engine_profile.py``); then
   holds a graph replay against the eager step on the same inputs (same
   ids, greedy and sampled; the logits within LOGIT_TOL);
6. on the same weights runs one prefill plus decode steps with the CUDA
   kernels and with the plain backend and compares the logits;
7. repeats 5 and 6 with ``quantization="int8"`` and ``"fp8"``: quantized
   weights and pool, the quantized kernels launching 12 layers x calls and
   the unquantized ones never, and the weights' and pool's device bytes
   about half of the bf16 engine's;
8. repeats 4 to 7 for Llama-125M (``Family.full``: 12 layers,
   d_model 768, 12 query heads on 4 kv heads, SwiGLU 2048, vocab 32000,
   seq 1024; ``EngineConfig(model="llama")``, ``run_gpt_bench(
   model="llama")``): B1-B3 with the kv heads repeated, B4/B5 and their
   quantized variants at a query-group size of 3 over a pool of 4 kv
   heads; then times Llama-125M bf16 engines with the prefix cache off
   and on over prompts drawn anew for each pass (nothing hits): what the
   default costs on unshared traffic;
9. serves shared-prefix traffic on Llama-125M, bf16 and then int8
   (``engine_profile.prefix_workload``; prefix caching and the host KV
   tier on, 256 blocks of 16): wave A (8 prompts of one 512-token prefix
   and their own suffixes), wave B (the same: device hits, the 576-token
   prompts resident whole through copy-on-write), a flood of 12
   unrelated 700-token prompts (every wave block demoted to the host)
   and wave C (every hit promoted back); per wave tokens/s, prefill
   calls, prompt tokens computed and served from the cache, copies,
   demotes, promotes and demote syncs; wave C's streams must equal wave
   B's, the first-token logits of the engine's own wave B and wave C
   prefills those of a ``prefix_caching=False`` engine serving the same
   prompts (LOGIT_TOL), every copy and promotion its bytes (a counted
   run, B4/B5 launches from its trace), the prefix counters those of the
   plain attention backend wave by wave, and the pool whole after
   ``release_all``; the block moves' ms a call;
10. prints the kernels' JSON line (a kernel's ``launches``: the sum over
   the paths, each counted alone, ``launches_by_path``: the two
   families' engine and training paths and the prefix path; a paged
   kernel's on the device in its engine's counted pass, from the trace;
   ``eager_launches``: its wrapper's count in that pass) and the card's
   line;
11. for each family, on its training phase's first weights and batch
   ([16, 1025]), holds the loss and every gradient through the CUDA
   kernels against the plain backend's (LOSS_TOL, GRAD_REL_TOL); then
   ``{"ok": true, "device": ...}`` last.

Any failure raises, so the exit code is not 0. Without a CUDA card, or
outside a checkout, it exits 2 and prints no result. ``--quick`` stops
after one comparison per kernel (a first check of a new kernel);
``--profile`` adds B4's device time by split count and L2 state beside
SDPA's, a profiled train step of each family, profiled warm
passes of the bf16 and the int8 engines' requests (device time by kernel,
step times, B4's device time per call, host ops by CPU time), and for
the prefix phase each wave's host time by step kind and by block move.
"""
from __future__ import annotations

import argparse
import contextlib
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
LONG_DECODE = dict(B=1, H=12, hd=64, bs=16, length=4096)  # one long sequence
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


def decode_case(torch, dtype, lengths=None):
    c = DECODE
    gen = torch.Generator(device="cuda").manual_seed(1)
    B, H, hd, bs = c["B"], c["H"], c["hd"], c["bs"]
    NB = c["max_len"] // bs
    # mixed lengths up to the model's 1024
    lengths = lengths or [1024, 900, 700, 512, 333, 200, 64, 30]
    pos = torch.tensor([n - 1 for n in lengths], dtype=torch.int32,
                       device="cuda")
    tables = make_tables(torch, gen, B, NB, [-(-n // bs) for n in lengths])
    k, v = make_pool(torch, gen, dtype, c["num_blocks"], bs, H, hd)
    q = torch.randn(B, H, hd, generator=gen, device="cuda").to(dtype)
    return dict(q=q, k=k, v=v, tables=tables, pos=pos, lengths=lengths)


def long_decode_case(torch, dtype):
    c = LONG_DECODE
    gen = torch.Generator(device="cuda").manual_seed(5)
    B, H, hd, bs, n = c["B"], c["H"], c["hd"], c["bs"], c["length"]
    NB = n // bs
    pos = torch.full((B,), n - 1, dtype=torch.int32, device="cuda")
    tables = make_tables(torch, gen, B, NB, [NB] * B)
    k, v = make_pool(torch, gen, dtype, B * NB + 1, bs, H, hd)
    q = torch.randn(B, H, hd, generator=gen, device="cuda").to(dtype)
    return dict(q=q, k=k, v=v, tables=tables, pos=pos, lengths=[n] * B)


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
        # the serving shapes; one long sequence (bf16 q, bf16 or int8 pool)
        cases = [((), decode_case)]
        if dtype == torch.bfloat16 and kind in (None, "int8"):
            cases.append((("long",), long_decode_case))
        for case, make in cases:
            x = make(torch, dtype)
            args = (x["q"], *pool(x), x["tables"], x["pos"])
            B, NB = x["tables"].shape
            label = " ".join((kname,) + case)
            got = pa.paged_attention_cuda(*args)
            torch.cuda.synchronize()
            nsplit = pa.SPLITS[kname]  # the count this launch ran with
            log(f"{label} {name}: B {B}, lengths {x['lengths']}, table "
                f"{NB} entries -> nsplit {nsplit}")
            row = {"max_abs_err": compare(label, got,
                                          paged_attention(*args), name),
                   "nsplit": nsplit}
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
                log(f"{label} {name}: {json.dumps(row)}")
                del sq, sk, sv, mask
            rows[(kname, name) + case] = row
            if not case:
                args = (x["q"], *pool(x, DECODE["H"] // 2), x["tables"],
                        x["pos"])
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
        unaligned_heads_phase(torch, dtype, kind)
        above_256_phase(torch, dtype, kind)
    return rows


def unaligned_heads_phase(torch, dtype, kind) -> None:
    """Agreement only: B4 and B5 (their ``kind`` variants) at head dims
    100 and 72, q in ``dtype``, the pool zero-padded to ``pool_head_dim``
    as the engine's cache allocates it, against the plain versions."""
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.ops.kv_cache import (
        pad_head,
        paged_attention,
        paged_prefill_attention,
        pool_head_dim,
    )

    name = str(dtype).split(".")[1]
    suffix = f"_{kind}" if kind else ""
    for hd in (100, 72):
        width = pool_head_dim(hd, kind is not None)

        def pool(x):
            k, v = (pad_head(t.float(), width) for t in (x["k"], x["v"]))
            if kind:
                return quantize_pool(k, v, kind)
            return k.to(dtype), v.to(dtype)

        gen = torch.Generator(device="cuda").manual_seed(hd)
        x = decode_case(torch, dtype)
        x["k"], x["v"] = make_pool(torch, gen, torch.float32, 1024, 16,
                                   DECODE["H"], hd)
        q = torch.randn(DECODE["B"], DECODE["H"], hd, generator=gen,
                        device="cuda").to(dtype)
        args = (q, *pool(x), x["tables"], x["pos"])
        compare(f"paged_decode{suffix} hd={hd} (pool {width})",
                pa.paged_attention_cuda(*args), paged_attention(*args), name)
        x = prefill_case(torch, dtype, [37, 100, 256, 500])
        x["k"], x["v"] = make_pool(torch, gen, torch.float32, 1024, 16,
                                   DECODE["H"], hd)
        q = torch.randn(*x["q"].shape[:3], hd, generator=gen,
                        device="cuda").to(dtype)
        args = (q, *pool(x), x["tables"], x["pos"])
        compare(f"paged_prefill{suffix} hd={hd} (pool {width})",
                pa.paged_prefill_attention_cuda(*args),
                paged_prefill_attention(*args), name)
        del x, args


def above_256_phase(torch, dtype, kind) -> None:
    """Agreement only, at small B: B4 and B5 (their ``kind`` variants) at
    head dims 288 and 512 (the column-chunked walk), q in ``dtype``, G 3
    (12 query heads on 4 kv heads, as Llama-125M), pools at
    ``pool_head_dim``, against the plain versions; B5 fresh and ragged,
    with and without a window."""
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.ops.kv_cache import (
        paged_attention,
        paged_prefill_attention,
    )

    name = str(dtype).split(".")[1]
    suffix = f"_{kind}" if kind else ""
    H, Hkv, bs, NB = 12, 4, 16, 48
    for hd in (288, 512):
        gen = torch.Generator(device="cuda").manual_seed(hd)
        lengths = [700, 33]
        k, v = make_pool(torch, gen, torch.float32, 1 + 2 * NB, bs, Hkv, hd)
        k, v = (quantize_pool(k, v, kind) if kind
                else (k.to(dtype), v.to(dtype)))
        tables = make_tables(torch, gen, 2, NB, [-(-n // bs) for n in lengths])
        q = torch.randn(2, H, hd, generator=gen, device="cuda").to(dtype)
        pos = torch.tensor([n - 1 for n in lengths], dtype=torch.int32,
                           device="cuda")
        args = (q, k, v, tables, pos)
        compare(f"paged_decode{suffix} hd={hd} G=3", pa.paged_attention_cuda(
            *args), paged_attention(*args), name)
        for starts in ([0, 0], [300, 17]):
            S = 64
            tables = make_tables(torch, gen, 2, NB,
                                 [-(-(s + S) // bs) for s in starts])
            qp = torch.randn(2, S, H, hd, generator=gen,
                             device="cuda").to(dtype)
            pp = (torch.tensor(starts, dtype=torch.int32, device="cuda")[:, None]
                  + torch.arange(S, dtype=torch.int32, device="cuda"))
            args = (qp, k, v, tables, pp.contiguous())
            for window in (None, 40):
                compare(f"paged_prefill{suffix} hd={hd} G=3 starts={starts} "
                        f"window={window}",
                        pa.paged_prefill_attention_cuda(*args, window=window),
                        paged_prefill_attention(*args, window=window), name)


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
        wide_heads_phase(torch, dtype)
    return rows


def wide_heads_phase(torch, dtype) -> None:
    """Agreement only: B1-B3 at head dims 160 (zero-padded to 256 by the
    wrappers, at the true scale), 256 (the CUDA-core tiles of 32 rows),
    264 and 512 (those tiles in column chunks of 256), causal and full,
    against the plain versions at the true D."""
    from ray_tpu_torch.ops import attention as at

    name = str(dtype).split(".")[1]
    for D in (160, 256, 264, 512):
        gen = torch.Generator(device="cuda").manual_seed(D)
        q, k, v, do = (torch.randn(2, 4, 512, D, generator=gen,
                                   device="cuda").to(dtype) for _ in range(4))
        for causal in (True, False):
            kw = dict(causal=causal, scale=D ** -0.5)
            label = f"D={D} {'causal' if causal else 'full'}"
            o, lse = at.flash_forward_cuda(q, k, v, **kw)
            o_ref, lse_ref = at.flash_forward_reference(q, k, v, **kw)
            grads = at.flash_backward_cuda(q, k, v, o_ref, lse_ref, do, **kw)
            refs = at.flash_backward_reference(q, k, v, o_ref, lse_ref, do,
                                               **kw)
            torch.cuda.synchronize()
            compare(f"flash_fwd o {label}", o, o_ref, name)
            compare(f"flash_fwd lse {label}", lse, lse_ref, name)
            for what, got, want in zip(("dq", "dk", "dv"), grads, refs):
                compare(f"flash_bwd {what} {label}", got, want, name)


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
            for D in (32, 64, 128, 256):
                _build.raise_on("flash_bwd", kname, fn(dkv, D, code, out))
                parts.append(f"{kname} {dtype_name} D={D} {out[0]}/{out[1]}")
    log("flash backward registers / local bytes per thread: "
        + "; ".join(parts))


# ---------------------------------------------------------------- training

# the model families whose paths the script drives, in order, each at its
# full width (``models/families.py`` ``Family.full``): GPT-2 125M, and
# Llama-125M, the repo's own Llama benchmark shape
# (docs/MICROBENCHMARKS.md:191-196: 12 query heads on 4 kv heads, SwiGLU
# d_mlp 2048, vocab 32000, seq 1024; 12 layers of d_model 768), a
# ``dataclasses.replace`` of ``LlamaConfig``
FAMILIES = ("gpt", "llama")
NAMES = {"gpt": "GPT-2 125M", "llama": "Llama-125M"}


def train_phase(torch, model="gpt", card="") -> dict:
    """Train steps of a family at full width (``Family.full``) through
    the port's entry point; checks the losses and that each flash kernel
    ran once per layer and step."""
    import math

    from ray_tpu_torch.benchmarks.gpt_mfu import run_gpt_bench
    from ray_tpu_torch.models.families import family
    from ray_tpu_torch.ops import attention as at

    cfg = family(model).full()
    n_layer = cfg.n_layer
    at.reset_launches()
    out = run_gpt_bench(model=model, config=cfg, **TRAIN)
    launches = dict(at.LAUNCHES)
    want = {name: n_layer * (TRAIN["warmup"] + TRAIN["steps"])
            for name in launches}
    losses = out["losses"]
    log(f"train: {NAMES[model]} {out['n_params']} params, batch "
        f"{out['batch_size']} x {out['seq_len']}, {out['steps']} timed "
        f"steps: step {out['step_ms']:.2f} ms, {out['tokens_per_s']:.1f} "
        f"tokens/s, MFU {out['mfu']} (peak {out['peak_tflops']} TFLOP/s) on "
        f"{card}; losses {[round(x, 4) for x in losses]}; launches "
        f"{launches} (expected {want})")
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


def train_backends_phase(torch, model="gpt") -> dict:
    """Loss and every gradient of one step through the CUDA kernels against
    the plain backend, on the training phase's first step: its weights
    (seed 0) and its batch (``TRAIN``'s size, tokens from seed 1)."""
    from ray_tpu_torch.benchmarks.gpt_mfu import bench_batch
    from ray_tpu_torch.models.families import family

    fam = family(model)
    cfg = dataclasses.replace(fam.full(), attention_backend="cuda")
    models = {"cuda": fam.init(cfg, seed=0, device="cuda", train=True)}
    models["torch"] = fam.model(
        dataclasses.replace(cfg, attention_backend="torch"), "cuda",
        train=True)
    models["torch"].load_state_dict(models["cuda"].state_dict())
    batch = bench_batch(cfg, TRAIN["batch_size"], TRAIN["seq_len"], 1,
                        "cuda")
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
    log(f"train [{model}] cuda vs torch backend: loss {loss['cuda']:.6f} vs "
        f"{loss['torch']:.6f} (|diff| {dloss:.3e}, tol {LOSS_TOL}); worst "
        f"gradient rel L2 {rel[worst]:.3e} ({worst}; tol {GRAD_REL_TOL}; "
        f"median {statistics.median(rel.values()):.3e})")
    if not dloss <= LOSS_TOL:
        raise AssertionError(f"losses disagree: {loss}")
    if not rel[worst] <= GRAD_REL_TOL:
        raise AssertionError(f"gradient {worst} disagrees: {rel[worst]}")
    return {"loss_diff": dloss, "grad_rel": rel[worst]}


def profile_train(torch, model="gpt") -> None:
    """Two warm train steps of a family at full width under
    torch.profiler: device time by kernel and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.benchmarks.engine_profile import device_rows
    from ray_tpu_torch.benchmarks.gpt_mfu import (
        bench_batch,
        make_optimizer,
        train_step,
    )
    from ray_tpu_torch.models.families import family

    fam = family(model)
    cfg = fam.full()
    net = fam.init(cfg, seed=0, device="cuda", train=True)
    opt = make_optimizer(net)
    batch = bench_batch(cfg, TRAIN["batch_size"], TRAIN["seq_len"], 1, "cuda")
    for _ in range(2):
        train_step(net, opt, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            train_step(net, opt, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = device_rows(prof)
    busy_ms = sum(r[0] for r in rows) / 1e3
    log(f"profile train [{model}] (2 steps): wall {wall_ms:.1f} ms, device "
        f"busy {busy_ms:.1f} ms (idle share {1 - busy_ms / wall_ms:.3f})")
    for us, count, key in rows[:25]:
        log(f"  {us / 1e3:9.3f} ms {100 * us / 1e3 / busy_ms:5.1f}% "
            f"x{count:<6d} {key[:110]}")
    del net, opt


def device_us(torch, fn, before, skip, iters=20) -> dict:
    """Mean device time per call (µs, CUPTI) of each kernel ``fn``
    launches, with ``before`` run ahead of every call; kernels named in
    ``skip`` (those of ``before``) are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            before()
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / iters
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0 and e.key not in skip}


def decode_sweep(torch) -> None:
    """B4's device time by split count and L2 state, bf16, beside SDPA's
    kernels on the same inputs. Cases: the serving decode case; its 8
    sequences all at length 1 (the fixed cost of a call) or all at 128
    (one 128-token range a block); one 4096-token sequence. L2 states
    before each call: ``dirty`` (a 256 MB write, as the Timer's flush),
    ``clean`` (a 256 MB read), ``warm`` (nothing)."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import paged_attention as pa

    buf = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    caches = {"dirty": buf.zero_, "clean": buf.sum, "warm": lambda: None}
    skip = set()
    for before in caches.values():
        skip |= set(device_us(torch, before, lambda: None, set()))
    cases = {"serving": decode_case(torch, torch.bfloat16),
             "len1": decode_case(torch, torch.bfloat16, [1] * 8),
             "len128": decode_case(torch, torch.bfloat16, [128] * 8),
             "long": long_decode_case(torch, torch.bfloat16)}
    for name, x in cases.items():
        args = (x["q"], x["k"], x["v"], x["tables"], x["pos"])
        for n in (None, 1, 2, 4, 8):
            for cache, before in caches.items():
                if n and cache != "dirty":
                    continue
                us = device_us(torch, lambda: pa.paged_attention_cuda(
                    *args, nsplit=n), before, skip)
                log("decode sweep: " + json.dumps({
                    "case": name, "kernel": "B4", "cache": cache,
                    "nsplit": pa.SPLITS["paged_decode"], "auto": n is None,
                    "us": sum(us.values())}))
        if name in ("serving", "long"):
            sq, sk, sv, mask = dense_sdpa_inputs(
                torch, x["q"][:, None], *args[1:3], x["tables"],
                x["pos"][:, None])
            for cache, before in caches.items():
                us = device_us(torch, lambda: F.scaled_dot_product_attention(
                    sq, sk, sv, attn_mask=mask), before, skip)
                log("decode sweep: " + json.dumps({
                    "case": name, "kernel": "SDPA", "cache": cache,
                    "us": sum(us.values()),
                    "kernels": {k[:60]: round(t, 3) for k, t in us.items()}}))
    del buf, cases


# ---------------------------------------------------------------- engine

def weight_bytes(model) -> int:
    """Device bytes of a model's weights (quantized: data and scales)."""
    from ray_tpu_torch.ops.quantization import QuantizedTensor

    return sum(w.nbytes() if isinstance(w, QuantizedTensor)
               else w.numel() * w.element_size()
               for w in model.weights().values())


def engine_phase(torch, quant=None, model="gpt") -> dict:
    """The engine workload (``quant``: None for bf16, or a quantization
    kind) on the lag-1 pipeline and its decode graphs. A first pass
    captures the graphs; a second, timed, must repeat its streams and
    replay a graph at every decode step, its wrappers launching B5 (and
    no B4) eagerly; a third, the counted pass, runs under the profiler
    with the launch counts reset just before it: its trace must show the
    path's kernels launched 12 layers x its calls on the device (B4 from
    the graph replays), every other paged kernel never."""
    from ray_tpu_torch.benchmarks import engine_profile as ep
    from ray_tpu_torch.ops import paged_attention as pa

    engine = ep.make_engine(quant, model)
    cfg = engine.model_cfg
    assert engine.device.type == "cuda", engine.device
    assert engine.executor.quantization == quant
    assert engine.executor.family == model
    tag = f"engine[{model} {quant or 'bf16'}]"
    suffix = f"_{quant}" if quant else ""
    decode, prefill = "paged_decode" + suffix, "paged_prefill" + suffix
    prompts, params = ep.workload(cfg.vocab_size)
    fns = engine.fns
    # first pass over the requests: the decode graphs are captured at
    # first use (with cuBLAS handles, lazily loaded modules, allocator)
    warm = ep.serve(torch, engine, prompts, params)
    graphs, capture_s = fns.graphs_captured, fns.capture_seconds
    log(f"{tag}: {graphs} decode graphs captured in {capture_s:.3f} s "
        f"(first pass {warm['seconds']:.3f} s, {len(warm['steps']['decode'])}"
        f" decode steps); signatures {sorted(fns.signatures)}")

    def calls(run):
        """The pass's (prefill calls, decode dispatches, graph replays)."""
        was = (engine.num_prefill_calls, engine.num_decode_steps, fns.replays)
        out = run()
        return out, (engine.num_prefill_calls - was[0],
                     engine.num_decode_steps - was[1], fns.replays - was[2])

    pa.reset_launches()
    run, (prefill_calls, decode_steps, replays) = calls(
        lambda: ep.serve(torch, engine, prompts, params))
    eager = dict(pa.LAUNCHES)
    outs = run["outs"]
    for o in outs:
        if len(o) != ep.NEW_TOKENS or not all(0 <= t < cfg.vocab_size
                                              for t in o):
            raise AssertionError(f"bad stream {o}")
    if outs != warm["outs"]:
        raise AssertionError("a second pass over the same requests differs")
    if fns.graphs_captured != graphs or replays != decode_steps:
        raise AssertionError(
            f"second pass: {replays} graph replays for {decode_steps} decode "
            f"steps, {fns.graphs_captured - graphs} new captures")
    want_eager = dict.fromkeys(eager, 0)
    want_eager[prefill] = cfg.n_layer * prefill_calls
    if eager != want_eager or min(prefill_calls, decode_steps) == 0:
        raise AssertionError(f"eager launches {eager} != {want_eager}")
    lags = [r["sync_lag"] for r in engine.debug_dump()["steps"]
            if r["kind"] == "decode"]
    if 1 not in lags or engine.stats()["decode_inflight"] != 0:
        raise AssertionError(f"the decode loop never ran at lag 1: {lags}")
    c = engine.cache
    snap = c.debug_snapshot()
    if (c.free_blocks != c.cfg.usable_blocks or c.reserved_blocks != 0
            or snap["freed_total"] != snap["allocated_total"]):
        raise AssertionError(f"pool not whole: {snap}")
    ntok = sum(map(len, outs))
    steps = run["steps"]
    nbytes = {"weights": weight_bytes(engine.executor.model),
              "pool": c.nbytes()}
    log(f"{tag}: {len(outs)} requests, {ntok} tokens in "
        f"{run['seconds']:.3f} s = {ntok / run['seconds']:.1f} tokens/s; "
        f"{prefill_calls} prefill calls, mean "
        f"{1e3 * statistics.mean(steps['prefill']):.2f} ms; {decode_steps} "
        f"decode steps, mean {1e3 * statistics.mean(steps['decode']):.2f} "
        f"ms, {replays} from graphs; device bytes {nbytes}; eager wrapper "
        f"launches {eager} (expected {want_eager})")
    log(f"{tag} first tokens: {[o[:4] for o in outs]}")

    # the counted pass: the launches on the device, from its trace
    pa.reset_launches()
    prof, (prefill_calls, decode_steps, replays) = calls(
        lambda: ep.profiled_pass(torch, engine, prompts, params))
    eager = dict(pa.LAUNCHES)
    launches = dict.fromkeys(pa.LAUNCHES, 0)
    launches.update(prof["paged_launches"])
    want = dict.fromkeys(launches, 0)
    want[decode] = cfg.n_layer * decode_steps
    want[prefill] = cfg.n_layer * prefill_calls
    log(f"{tag}: counted pass: {prefill_calls} prefill calls, "
        f"{decode_steps} decode steps ({replays} from graphs); launches on "
        f"the device (trace) {launches} (expected {want}); eager wrapper "
        f"launches {eager}")
    if (launches != want or replays != decode_steps
            or min(prefill_calls, decode_steps) == 0):
        raise AssertionError(f"launch counts {launches} != {want}")
    per_step = launches[decode] / decode_steps
    log(f"{tag}: {per_step:g} {decode} launches per decode step "
        f"(expected {cfg.n_layer}, one per layer)")
    if per_step != cfg.n_layer:
        raise AssertionError(f"{per_step} B4 launches per decode step")
    window = ep.decode_window(torch, engine, prompts)
    log(f"{tag}: profiled pass wall {prof['wall_ms']:.1f} ms, device busy "
        f"{prof['device_busy_ms']:.1f} ms, idle share "
        f"{prof['idle_share']:.3f}; decode window of {window['steps']} "
        f"steps: {window['step_ms']:.3f} ms a step, "
        f"{window['launch_api_calls_per_step']:g} host launch API calls "
        f"per step ({', '.join(f'{k} {v:g}' for k, v in window['runtime_calls_per_step'].items())}), "
        f"{window['device_ops_per_step']:g} device kernels and copies per "
        f"step, {window['device_busy_ms_per_step']:.3f} ms device busy a step")
    graph_phase(torch, engine)
    return {"engine": engine, "launches": launches, "eager": eager,
            "prompts": prompts, "params": params, "bytes": nbytes,
            "tokens_per_s": ntok / run["seconds"]}


def graph_phase(torch, engine) -> None:
    """A decode step replayed from its captured graph against the eager
    step on the same staged inputs, greedy and sampled, at the engine's
    full width: 8 sequences of 100-900 tokens prefilled into free blocks
    of the (idle) pool. Same ids; the logits of the step (eager, and from
    a graph of the logits step) within LOGIT_TOL."""
    import numpy as np

    ex = engine.executor
    cfg, cache = engine.model_cfg, engine.cache
    if cache.used_blocks:
        raise AssertionError("graph_phase needs an idle pool")
    rng = np.random.default_rng(6)
    B, nb = 8, 64
    lengths = np.array([100, 250, 400, 512, 640, 700, 800, 900], np.int32)
    tables = np.arange(1, 1 + B * nb, dtype=np.int32).reshape(B, nb)
    tokens = rng.integers(0, cfg.vocab_size, (B, 1024)).astype(np.int32)
    first = ex.sync_tokens(ex.prefill(tokens, lengths, tables))
    tag = f"graph vs eager [{ex.family} {cfg.quantization or 'bf16'}]"
    for sampled in (False, True):
        sample = {"seeds": np.arange(B, dtype=np.int64),
                  "temperature": np.full(B, 0.9 if sampled else 0.0,
                                         np.float32),
                  "top_k": np.zeros(B, np.int32),
                  "top_p": np.full(B, 0.95, np.float32)}
        g = ex.stage_decode(first, lengths, tables, sample)
        assert g.sampled == sampled
        eager = ex.fns.step(g.inputs, sampled).clone()
        graphed = g.run().clone()
        torch.cuda.synchronize()
        if not torch.equal(graphed, eager):
            raise AssertionError(f"{tag}: ids differ {graphed} {eager}")
        # the host's cost of one replay (cudaGraphLaunch of every node),
        # the device idle before each
        launch_us = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g.graph.replay()
            launch_us.append(1e6 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        log(f"{tag}: sampled={sampled}: same ids {graphed.tolist()}; one "
            f"replay costs the host {statistics.median(launch_us):.1f} us "
            f"(median of 10)")
    model = ex.model
    args = (g.inputs["tokens"], g.inputs["positions"], g.inputs["tables"])
    want, _, _ = model.decode_step(cache.k, cache.v, *args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        model.decode_step(cache.k, cache.v, *args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=ex.fns.pool):
        out, _, _ = model.decode_step(cache.k, cache.v, *args)
    graph.replay()
    torch.cuda.synchronize()
    diff = (out - want).abs().max().item()
    log(f"{tag}: logits max_abs_diff {diff:.3e} (tol {LOGIT_TOL})")
    if not diff <= LOGIT_TOL:
        raise AssertionError(f"{tag}: logits differ by {diff}")
    del graph, out, want


def unshared_cost_phase(torch, card) -> None:
    """What the default ``prefix_caching=True`` costs on traffic that never
    hits (a digest per full block, ``register_prefix`` after each chunk,
    ``prepare_write`` before each write): Llama-125M bf16, the engine
    workload's geometry, two engines (cache off, cache on) warmed alike,
    then passes alternating off, on, each pair over prompts drawn anew
    (``engine_profile.workload`` at seed 100 + i), so nothing can hit.
    Host clock; the cache-on engine must report no hit and no copy."""
    from ray_tpu_torch.benchmarks import engine_profile as ep

    engines = {on: ep.make_engine(None, "llama", prefix_caching=on)
               for on in (False, True)}
    engines[True].executor.model.load_weights(
        engines[False].executor.model.weights())
    vocab = engines[False].model_cfg.vocab_size
    for eng in engines.values():
        ep.serve(torch, eng, *ep.workload(vocab))  # captures the graphs
    passes = {False: [], True: []}
    for i in range(4):
        work = ep.workload(vocab, seed=100 + i)
        for on, eng in engines.items():
            run = ep.serve(torch, eng, *work)
            passes[on].append({
                "tokens_per_s": sum(map(len, run["outs"])) / run["seconds"],
                "seconds": run["seconds"],
                "prefill_ms": 1e3 * statistics.mean(run["steps"]["prefill"]),
                "decode_ms": 1e3 * statistics.mean(run["steps"]["decode"]),
                "outs": run["outs"]})
    st = engines[True].stats()
    if st["prefix_hit_tokens"] or st["cow_blocks"]:
        raise AssertionError(f"unshared traffic hit the cache: {st}")
    same = sum(a["outs"] == b["outs"]
               for a, b in zip(passes[False], passes[True]))
    for on, runs in passes.items():
        log(f"unshared[llama bf16, prefix_caching={on}]: "
            + "; ".join(f"{r['tokens_per_s']:.1f} tokens/s ({r['seconds']:.4f}"
                        f" s), prefill {r['prefill_ms']:.2f} ms, decode "
                        f"{r['decode_ms']:.3f} ms" for r in runs)
            + f"; {card}")
    med = {on: statistics.median(r["seconds"] for r in runs)
           for on, runs in passes.items()}
    log(f"unshared: median pass {med[False]:.4f} s (cache off) / "
        f"{med[True]:.4f} s (on) = {med[True] / med[False]:.4f}; streams "
        f"equal in {same} of {len(passes[True])} pass pairs; "
        f"cache-on engine's prefix_cached_blocks {st['prefix_cached_blocks']}"
        f", evicted {st['prefix_evicted_blocks']}")
    del engines
    torch.cuda.empty_cache()


# ------------------------------------------------------------ prefix phase

PREFIX_KINDS = (None, "int8")
WAVES = ("A", "B", "flood", "C")
PREFIX_COUNTERS = ("prefix_hit_tokens", "prefix_hit_blocks",
                   "prefix_cached_blocks", "prefix_evicted_blocks",
                   "host_cache_blocks", "kv_demoted_blocks",
                   "kv_promoted_blocks", "cow_blocks", "prefill_tokens_total")


def side_bytes(side) -> bytes:
    """A host payload's bytes, a quantized one's scale plane after its data
    (``ops.kv_cache.block_planes``)."""
    from ray_tpu_torch.ops.kv_cache import block_planes

    return b"".join(p.tobytes() for p in block_planes(side))


def prefix_engine(kind, **overrides):
    """Llama-125M on the prefix workload's engine (``engine_profile.
    PREFIX_ENGINE``), its host tier sized to hold every full prompt block
    of the traffic, in RTKV record bytes."""
    from ray_tpu_torch.benchmarks import engine_profile as ep
    from ray_tpu_torch.models.families import family, kv_heads
    from ray_tpu_torch.serve.llm.kv_transfer import KVLayout

    cfg = family("llama").full()
    work = ep.prefix_workload(cfg.vocab_size)
    layout = KVLayout(
        n_layer=cfg.n_layer, block_size=ep.PREFIX_ENGINE["block_size"],
        n_kv_head=kv_heads(cfg), head_dim=cfg.head_dim,
        dtype={None: "bfloat16", "int8": "int8"}[kind], quantization=kind)
    blocks = ep.distinct_blocks(work["wave"][0] + work["flood"][0],
                                layout.block_size)
    engine = ep.make_prefix_engine(
        kind, host_cache_bytes=blocks * layout.record_bytes, **overrides)
    if engine.cache.layout != layout:
        raise AssertionError(f"{engine.cache.layout} != {layout}")
    return engine, work, {"blocks": blocks, "record_bytes": layout.record_bytes,
                          "host_cache_bytes": blocks * layout.record_bytes}


def prefix_waves(torch, engine, work, after_wave=None, wave_context=None,
                 timed_moves=True) -> dict:
    """Wave A, wave B, the flood and wave C through ``engine_profile.
    serve``; per wave its streams, its time and the engine's counters'
    moves (prefill calls, decode steps, prompt tokens computed and served
    from the cache, copies, demotes and promotes, demote syncs), with
    ``timed_moves`` on a card each block move's calls (those that move a
    block) and ms a call (CUDA events recorded around the call), and the
    prefix counters of ``stats()`` at its end, less their values at the
    start of the run. Each wave runs inside ``wave_context()`` when it is
    given; ``after_wave`` is called after each wave."""
    import contextlib

    from ray_tpu_torch.benchmarks import engine_profile as ep
    from ray_tpu_torch.ops.kv_cache import planes_nbytes

    ex = engine.executor
    moves = ("copy_blocks", "land_blocks", "export_blocks")
    saved = {n: getattr(ex, n) for n in moves}
    events = {n: [] for n in moves}

    def evented(name, fn):
        def run(*args, **kw):
            if not len(args[0]):  # an empty list of blocks moves nothing
                return fn(*args, **kw)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            events[name].append((start, end))
            return out
        return run

    if timed_moves and engine.device.type == "cuda":
        for n in moves:
            setattr(ex, n, evented(n, saved[n]))
    syncs = {"n": 0, "bytes": 0}
    demote = engine.cache.demote_fn

    def counted(ids):  # each demote capture is one device-to-host sync
        k, v = demote(ids)
        syncs["n"] += 1
        syncs["bytes"] += planes_nbytes(k, v)
        return k, v

    engine.cache.demote_fn = counted
    vocab = engine.model_cfg.vocab_size
    base = engine.stats()
    out = {}
    for name in WAVES:
        prompts, params = work["flood" if name == "flood" else "wave"]
        st0, s0 = engine.stats(), dict(syncs)
        calls0 = (engine.num_prefill_calls, engine.num_decode_steps)
        with (wave_context or contextlib.nullcontext)():
            run = ep.serve(torch, engine, prompts, params)
        st = engine.stats()
        for o, sp in zip(run["outs"], params):
            if len(o) != sp.max_new_tokens or not all(0 <= t < vocab
                                                      for t in o):
                raise AssertionError(f"wave {name}: bad stream {o}")
        ntok = sum(map(len, run["outs"]))
        moved = {k: st[k] - st0[k] for k in (
            "prefill_tokens_total", "prefix_hit_tokens", "cow_blocks",
            "kv_demoted_blocks", "kv_promoted_blocks",
            "prefix_evicted_blocks")}
        out[name] = {
            "outs": run["outs"], "seconds": run["seconds"],
            "tokens_per_s": ntok / run["seconds"],
            "prefill_calls": engine.num_prefill_calls - calls0[0],
            "decode_steps": engine.num_decode_steps - calls0[1],
            "computed": moved["prefill_tokens_total"],
            "cached": moved["prefix_hit_tokens"],
            "cow": moved["cow_blocks"], "demoted": moved["kv_demoted_blocks"],
            "promoted": moved["kv_promoted_blocks"],
            "evicted": moved["prefix_evicted_blocks"],
            "demote_syncs": syncs["n"] - s0["n"],
            "demote_sync_bytes": syncs["bytes"] - s0["bytes"],
            "counters": {k: st[k] - base[k] for k in PREFIX_COUNTERS},
            # serve() ended in a synchronize: every event has completed
            "move_ms": {n: (len(ev), statistics.mean(
                s.elapsed_time(e) for s, e in ev) if ev else 0.0)
                for n, ev in events.items()},
        }
        for ev in events.values():
            ev.clear()
        if after_wave is not None:
            after_wave()
    engine.cache.demote_fn = demote
    for n in moves:
        setattr(ex, n, saved[n])
    return out


class FirstLogits:
    """Capture, while active, the first-token logits of ``prompts`` as the
    engine's own prefill computes them: the model's ``prefill`` is wrapped
    to keep the logits of each row whose chunk ends its prompt (the row
    is told by its tokens and its start, so every admission, hit and
    copy-on-write decision stays the engine's). ``got[i]`` holds the
    logits of prompt i's last prefill ([V] f32, on the host)."""

    def __init__(self, engine, prompts):
        self.model, self.prompts, self.got = engine.executor.model, prompts, {}

    def __enter__(self):
        model, prefill, logits_fn = (self.model, self.model.prefill,
                                     self.model._logits)

        def hooked(cache_k, cache_v, tokens, lengths, tables, start=None,
                   sample=None):
            seen = []

            def keep(h):
                seen.append(logits_fn(h))
                return seen[-1]

            model._logits = keep
            try:
                out = prefill(cache_k, cache_v, tokens, lengths, tables,
                              start=start, sample=sample)
            finally:
                del model._logits
            rows = tokens.cpu().numpy()
            lens = lengths.cpu().numpy()
            starts = (start.cpu().numpy() if start is not None
                      else [0] * len(lens))
            for r, (n, s0) in enumerate(zip(lens, starts)):
                for i, p in enumerate(self.prompts):
                    if (len(p) == s0 + n
                            and list(rows[r, :n]) == list(p[s0:])):
                        self.got[i] = seen[0][r].float().cpu()
            return out

        model.prefill = hooked
        return self

    def __exit__(self, *exc):
        del self.model.prefill


def prefix_checked_moves(engine, checks: dict):
    """Wrap the engine's block moves with byte checks: a copy-on-write
    copies its source's bytes, and the source still holds them at the end
    of the wave (``checks["sources"]`` of those still content-addressed
    then; the returned function checks them), and a landing leaves each
    promoted block holding its record's payload, scale planes included."""
    ex, cache = engine.executor, engine.cache
    copy, land = ex.copy_blocks, ex.land_blocks
    pending = []

    def copy_checked(pairs):
        src = [s for s, _ in pairs]
        before = ex.export_blocks(src)
        copy(pairs)
        after = ex.export_blocks([d for _, d in pairs])
        for x, y in zip(before, after):
            if side_bytes(x) != side_bytes(y):
                raise AssertionError("a copy-on-write did not copy its source")
        checks["copies"] += len(pairs)
        pending.append((src, [cache._block_hash.get(b) for b in src],
                        [side_bytes(x) for x in before]))

    def land_checked(ids, k_new, v_new):
        land(ids, k_new, v_new)
        k, v = ex.export_blocks(ids)
        for got, want in ((k, k_new), (v, v_new)):
            if side_bytes(got) != side_bytes(want):
                raise AssertionError("a promoted block differs from its "
                                     "record's payload")
        checks["landed"] += len(ids)

    def sources_unchanged():
        for src, digests, before in pending:
            if [cache._block_hash.get(b) for b in src] != digests:
                continue  # evicted within the wave: its bytes moved on
            if [side_bytes(x) for x in ex.export_blocks(src)] != before:
                raise AssertionError("a copy-on-write changed its source")
            checks["sources"] += len(src)
        pending.clear()

    ex.copy_blocks, ex.land_blocks = copy_checked, land_checked
    return sources_unchanged


def prefix_kernels_phase(torch) -> None:
    """B5/B5q and B4/B4q at the prefix path's shapes against their plain
    versions, bf16 q on a bf16, int8 and fp8 pool of Llama-125M's heads
    (4 kv heads of 64, groups of 3), 16-token blocks: prefill of a
    one-token chunk at 575 (a 576-token prompt resident whole) beside a
    200-token suffix at 512, and decode of 8 rows (542-712 tokens) whose
    tables share the prefix's 32 blocks."""
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.ops.kv_cache import (
        paged_attention,
        paged_prefill_attention,
    )

    gen = torch.Generator(device="cuda").manual_seed(11)
    Hkv, G, hd, bs, shared = 4, 3, 64, 16, 32
    k, v = make_pool(torch, gen, torch.float32, 512, bs, Hkv, hd)
    nxt = [1 + shared]

    def table(length, nb):
        """The shared prefix's blocks, then private ones."""
        own = -(-length // bs) - shared
        row = list(range(1, 1 + shared)) + list(range(nxt[0], nxt[0] + own))
        nxt[0] += own
        return row + [0] * (nb - len(row))

    starts, lens, S = [575, 512], [1, 200], 200
    tables = torch.tensor([table(s + n, 45) for s, n in zip(starts, lens)],
                          dtype=torch.int32, device="cuda")
    ar = torch.arange(S, device="cuda")
    valid = ar[None, :] < torch.tensor(lens, device="cuda")[:, None]
    pos = torch.where(valid, torch.tensor(starts, device="cuda")[:, None]
                      + ar[None, :], 0).to(torch.int32)
    q = torch.randn(2, S, Hkv * G, hd, generator=gen, device="cuda").to(
        torch.bfloat16)
    lengths = [542, 576, 632, 712] * 2
    dtables = torch.tensor([table(n, 45) for n in lengths], dtype=torch.int32,
                           device="cuda")
    dpos = torch.tensor([n - 1 for n in lengths], dtype=torch.int32,
                        device="cuda")
    dq = torch.randn(8, Hkv * G, hd, generator=gen, device="cuda").to(
        torch.bfloat16)
    for kind in (None, *QUANT_KINDS):
        kk, vv = ((k.to(torch.bfloat16), v.to(torch.bfloat16)) if kind is None
                  else quantize_pool(k, v, kind))
        tag = f"prefix path [{kind or 'bf16'} pool]"
        got = pa.paged_prefill_attention_cuda(q, kk, vv, tables, pos)
        want = paged_prefill_attention(q, kk, vv, tables, pos)
        torch.cuda.synchronize()
        compare(f"{tag} B5: 1 token at 575, 200 at 512", got[valid],
                want[valid], "bfloat16")
        got = pa.paged_attention_cuda(dq, kk, vv, dtables, dpos)
        want = paged_attention(dq, kk, vv, dtables, dpos)
        torch.cuda.synchronize()
        compare(f"{tag} B4: 8 rows sharing 32 blocks", got, want, "bfloat16")


def prefix_breakdown(torch, engine, work, tag) -> None:
    """One more run of the waves with the host time of each step kind and
    of each block move measured around its call (host clock; a demote's
    export and a landing include their waits on the device): where a
    wave's time goes beside its model steps."""
    import collections

    from ray_tpu_torch.benchmarks import engine_profile as ep

    ex, tier = engine.executor, engine.cache.host_tier
    spent = collections.Counter()

    def timed(name, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[name] += time.perf_counter() - t0
        return run

    saved = (ex.export_blocks, ex.land_blocks, ex.copy_blocks, tier.put,
             tier.get)
    ex.export_blocks = timed("export (device to host)", ex.export_blocks)
    ex.land_blocks = timed("land (host to device)", ex.land_blocks)
    ex.copy_blocks = timed("copy-on-write", ex.copy_blocks)
    tier.put = timed("record pack (demote)", tier.put)
    tier.get = timed("record verify (promote)", tier.get)
    for name in WAVES:
        spent.clear()
        prompts, params = work["flood" if name == "flood" else "wave"]
        run = ep.serve(torch, engine, prompts, params)
        steps = {k: sum(v) for k, v in run["steps"].items()}
        log(f"{tag} wave {name} breakdown: {run['seconds']:.3f} s; steps "
            + ", ".join(f"{k} {v:.3f} s" for k, v in steps.items())
            + "; within them " + ", ".join(
                f"{k} {v:.4f} s" for k, v in sorted(spent.items())))
    (ex.export_blocks, ex.land_blocks, ex.copy_blocks, tier.put,
     tier.get) = saved


def prefix_phase(torch, kind, card, profile_host=False) -> dict:
    """Shared-prefix traffic (``engine_profile.prefix_workload``) on
    Llama-125M at full width and depth, with the host tier: wave A, wave
    B (the prefix and the 576-token prompts resident whole: hits and
    copy-on-write), a flood of unrelated prompts (every wave block
    demoted), wave C (every hit promoted). On one engine: a warm-up run
    (the decode graphs captured), ``release_all``, the timed run; wave
    C's streams against wave B's, each wave prompt's first-token logits
    against a ``prefix_caching=False`` engine's, the pool whole after
    ``release_all``, the block moves' times; then the counted run (launch
    counts reset just before it, B4/B5 launches on the device read from
    a ``torch.profiler`` trace of each wave, each copy and promotion
    checked byte for byte), whose streams and counters must equal the timed run's. Last,
    a run on the plain attention backend, whose prefix counters must
    equal the CUDA run's wave by wave."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.benchmarks import engine_profile as ep
    from ray_tpu_torch.ops import paged_attention as pa

    tag = f"prefix[llama {kind or 'bf16'}]"
    suffix = f"_{kind}" if kind else ""
    decode, prefill = "paged_decode" + suffix, "paged_prefill" + suffix
    engine, work, tier = prefix_engine(kind)
    cfg, cache, fns = engine.model_cfg, engine.cache, engine.fns

    def whole():
        cache.release_all()
        if (cache.free_blocks != cache.cfg.usable_blocks
                or cache.reserved_blocks or cache.cached_blocks
                or cache.host_tier.blocks):
            raise AssertionError(f"{tag}: pool not whole after release_all: "
                                 f"{cache.debug_snapshot()}")

    log(f"{tag}: host tier {tier['host_cache_bytes']} B = {tier['blocks']} "
        f"blocks x {tier['record_bytes']} B a record; {card}")
    t0 = time.perf_counter()
    prefix_waves(torch, engine, work)
    whole()
    log(f"{tag}: warm-up run {time.perf_counter() - t0:.3f} s, "
        f"{fns.graphs_captured} decode graphs captured")
    waves = prefix_waves(torch, engine, work)
    for name in WAVES:
        w = waves[name]
        log(f"{tag} wave {name}: {w['tokens_per_s']:.1f} tokens/s "
            f"({w['seconds']:.3f} s); {w['prefill_calls']} prefill calls, "
            f"{w['decode_steps']} decode steps; prompt tokens computed "
            f"{w['computed']}, served from the cache {w['cached']}; "
            f"copy-on-write {w['cow']}, demoted {w['demoted']}, promoted "
            f"{w['promoted']}, evicted {w['evicted']}; demote syncs "
            f"{w['demote_syncs']} ({w['demote_sync_bytes']} B); block moves "
            + ", ".join(f"{n} {c} calls, {ms:.4f} ms a call"
                        for n, (c, ms) in w["move_ms"].items())
            + f"; {card}")
    a, b, fl, c = (waves[n] for n in WAVES)
    if c["outs"] != b["outs"]:
        raise AssertionError(f"{tag}: wave C's streams differ from wave B's")
    # waves B and C compute only the tokens past each prompt's last full
    # block (one token for a prompt resident whole); C promotes every
    # wave block once, after the flood demoted them all
    bs = cache.cfg.block_size
    tails = sum(len(p) % bs or 1 for p in work["wave"][0])
    wave_blocks = ep.distinct_blocks(work["wave"][0], bs)
    if (b["computed"], c["computed"]) != (tails, tails) or (
            b["promoted"], c["promoted"]) != (0, wave_blocks) or (
            c["cached"] != b["cached"] or fl["demoted"] < wave_blocks
            or b["cow"] == 0):
        counts = {n: {k: x for k, x in w.items() if k != "outs"}
                  for n, w in waves.items()}
        raise AssertionError(
            f"{tag}: hits, copies, demotes or promotes not as the traffic "
            f"makes them (tails {tails}, wave blocks {wave_blocks}): "
            f"{counts}")

    # first-token logits: the engine's wave B and wave C prefills (device
    # hits and host promotions, the counted run's, hooked below) against
    # a prefix_caching=False engine serving the same prompts
    wave_prompts = work["wave"][0]
    cold = ep.make_prefix_engine(kind, prefix_caching=False)
    cold.executor.model.load_weights(engine.executor.model.weights())
    with FirstLogits(cold, wave_prompts) as cold_logits:
        cold_run = ep.serve(torch, cold, *work["wave"])
    del cold
    torch.cuda.empty_cache()

    # the block moves, timed on the idle pool (they write garbage into
    # free blocks, which the next run writes again before reading)
    whole()
    ex, timer = engine.executor, Timer(torch)
    ids = list(range(1, 33))
    k, v = ex.export_blocks(ids)
    ms = {"copy_blocks[1 pair]": timer(lambda: ex.copy_blocks([(1, 2)])),
          "land_blocks[32 blocks]": timer(lambda: ex.land_blocks(ids, k, v)),
          "export_blocks[1 block]": timer(lambda: ex.export_blocks([1])),
          "export_blocks[32 blocks]": timer(lambda: ex.export_blocks(ids))}
    del k, v
    log(f"{tag}: block moves, ms a call (CUDA events, median of 20): "
        + ", ".join(f"{n} {t:.4f}" for n, t in ms.items()) + f"; {card}")

    # the counted run: launches from the trace, every move checked
    checks = {"copies": 0, "sources": 0, "landed": 0}
    copy, land = ex.copy_blocks, ex.land_blocks
    sources_unchanged = prefix_checked_moves(engine, checks)
    graphs = fns.graphs_captured
    profs = []

    hooks = {n: FirstLogits(engine, wave_prompts) for n in WAVES}
    order = iter(WAVES)

    @contextlib.contextmanager
    def wave_context():  # one trace a wave keeps each trace small
        with hooks[next(order)], profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            yield
        profs.append(prof)

    pa.reset_launches()
    counted = prefix_waves(torch, engine, work, sources_unchanged,
                           wave_context, timed_moves=False)
    eager = dict(pa.LAUNCHES)
    launches = dict.fromkeys(pa.LAUNCHES, 0)
    for prof in profs:
        for name, n in ep.paged_launches(prof).items():
            launches[name] += n
    calls = [sum(w[k] for w in counted.values())
             for k in ("prefill_calls", "decode_steps")]
    want = dict.fromkeys(launches, 0)
    want[prefill], want[decode] = (cfg.n_layer * n for n in calls)
    log(f"{tag}: counted run: {calls[0]} prefill calls, {calls[1]} decode "
        f"steps, {fns.graphs_captured - graphs} new graphs; launches on "
        f"the device (trace) {launches} (expected {want}); eager wrapper "
        f"launches {eager}; checked byte for byte: {checks['copies']} "
        f"copies, {checks['sources']} of their sources at the wave's end, "
        f"{checks['landed']} promoted blocks")
    if launches != want or min(calls) == 0 or fns.graphs_captured != graphs:
        raise AssertionError(f"{tag}: launch counts {launches} != {want}")
    if not min(checks.values()):
        raise AssertionError(f"{tag}: a kind of move went unchecked: "
                             f"{checks}")
    for name in WAVES:
        if (counted[name]["outs"], counted[name]["counters"]) != (
                waves[name]["outs"], waves[name]["counters"]):
            raise AssertionError(f"{tag}: wave {name}'s streams or counters "
                                 "differ between two runs")
    diffs = {}
    for name in ("B", "C"):
        got = hooks[name].got
        if sorted(got) != list(range(len(wave_prompts))) or sorted(
                cold_logits.got) != sorted(got):
            raise AssertionError(f"{tag}: first-token logits of wave {name} "
                                 f"captured for {sorted(got)}, of the cold "
                                 f"engine for {sorted(cold_logits.got)}")
        diffs[name] = [(got[i] - cold_logits.got[i]).abs().max().item()
                       for i in sorted(got)]
    same = {n: sum(a == b for a, b in zip(counted[n]["outs"],
                                          cold_run["outs"]))
            for n in ("B", "C")}
    log(f"{tag}: first-token logits of the engine's prefills against a "
        f"prefix_caching=False engine's, max_abs_diff by request: "
        + "; ".join(f"wave {n} {[f'{d:.3e}' for d in ds]}"
                    for n, ds in diffs.items())
        + f" (tol {LOGIT_TOL}); streams equal to the cold engine's: "
        f"{same} of {len(wave_prompts)}")
    if not max(max(ds) for ds in diffs.values()) <= LOGIT_TOL:
        raise AssertionError(f"{tag}: first-token logits differ: {diffs}")
    whole()
    if profile_host:
        ex.copy_blocks, ex.land_blocks = copy, land
        prefix_breakdown(torch, engine, work, tag)
        whole()
    del engine, ex, cache, fns
    torch.cuda.empty_cache()

    # the plain attention backend: the same counters wave by wave
    engine, work, _ = prefix_engine(kind, attention_backend="torch")
    plain = prefix_waves(torch, engine, work)
    for name in WAVES:
        if plain[name]["counters"] != waves[name]["counters"]:
            raise AssertionError(
                f"{tag}: wave {name} counters {waves[name]['counters']} != "
                f"the plain backend's {plain[name]['counters']}")
    log(f"{tag}: prefix counters equal the plain backend's in every wave: "
        f"{ {n: waves[n]['counters'] for n in WAVES} }")
    del engine
    torch.cuda.empty_cache()
    return {"launches": launches, "eager": eager, "waves": waves,
            "block_ms": ms, "logit_diffs": diffs}


def profile_phase(torch, eng) -> None:
    """One more warm pass over the same requests under torch.profiler:
    device time by kernel, the device's busy share of the wall time, the
    step times by kind, device launches per step and host ops by CPU
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.benchmarks.engine_profile import device_rows, serve

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run = serve(torch, eng["engine"], eng["prompts"], eng["params"])
    rows = device_rows(prof)
    busy_ms = sum(r[0] for r in rows) / 1e3
    wall_ms = run["seconds"] * 1e3
    ex = eng["engine"].executor
    quant = f"{ex.family} {ex.quantization or 'bf16'}"
    log(f"profile [{quant}]: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms "
        f"(idle share {1 - busy_ms / wall_ms:.3f}); steps "
        + ", ".join(f"{k} n={len(v)} mean {1e3 * statistics.mean(v):.2f} ms"
                    for k, v in run["steps"].items()))
    for us, count, key in rows[:20]:
        log(f"  {us / 1e3:9.3f} ms {100 * us / 1e3 / busy_ms:5.1f}% "
            f"x{count:<6d} {key[:110]}")
    b4 = [(us, count) for us, count, key in rows if "paged_decode" in key]
    b4_ms, b4_calls = sum(r[0] for r in b4) / 1e3, sum(r[1] for r in b4)
    log(f"profile [{quant}]: B4 in the engine {b4_ms:.3f} ms over "
        f"{b4_calls} calls = {b4_ms / max(b4_calls, 1):.4f} ms a call "
        f"({100 * b4_ms / busy_ms:.1f}% of device busy)")
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
    plain backend: one fresh prefill, then decode steps, each fed the
    plain backend's greedy token, so both take the same inputs even where
    a near tie makes the two argmaxes differ (counted and printed)."""
    import numpy as np

    from ray_tpu_torch.models.families import kv_heads
    from ray_tpu_torch.serve.llm.kv_cache import KVCacheConfig, PagedKVCache

    base = engine.executor.model
    models = {}
    for backend in ("cuda", "torch"):
        m = type(base)(dataclasses.replace(base.cfg, attention_backend=backend),
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
    logits, fed = {}, []
    for backend in ("torch", "cuda"):  # the plain backend picks the tokens
        m = models[backend]
        cache = PagedKVCache(KVCacheConfig(
            n_layer=cfg.n_layer,
            n_kv_head=kv_heads(cfg),
            head_dim=cfg.head_dim,
            num_blocks=B * nb + 1, block_size=bs, dtype=cfg.dtype,
            device="cuda", quantization=cfg.quantization))
        out, _, _ = m.prefill(cache.k, cache.v, tokens, lengths, tables)
        seq = [out]
        pos = lengths.clone()
        for i in range(steps):
            if backend == "torch":
                fed.append(out.argmax(-1).to(torch.int32))
            out, _, _ = m.decode_step(cache.k, cache.v, fed[i], pos, tables)
            seq.append(out)
            pos = pos + 1
        logits[backend] = torch.stack(seq)
    if not torch.isfinite(logits["cuda"]).all():
        raise AssertionError("non-finite logits from the CUDA path")
    diff = (logits["cuda"] - logits["torch"]).abs().max().item()
    scale = logits["torch"].abs().max().item()
    ties = int((logits["cuda"].argmax(-1) != logits["torch"].argmax(-1))
               .sum().item())
    log(f"logits cuda vs torch backend [{engine.executor.family} "
        f"{cfg.quantization or 'bf16'}]: "
        f"max_abs_diff {diff:.3e} (tol {LOGIT_TOL}; max |logit| "
        f"{scale:.3f}); argmax differs at {ties} of "
        f"{B * (steps + 1)} (row, step)")
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
    prefix_kernels_phase(torch)
    frows = flash_phase(torch, args.quick)
    if args.quick:
        log(card)
        return 0
    # each family's path: its training phase, then its engine phases; the
    # launch counts of each path are reset just before it and read just
    # after it
    train = {}
    for model in FAMILIES:
        train[model] = train_phase(torch, model, card)
        if model == "gpt":
            loss_phase(torch, Timer(torch))
        if args.profile:
            profile_train(torch, model)
    launches = {model: {} for model in FAMILIES}
    eager = {model: {} for model in FAMILIES}
    for model in FAMILIES:
        base_bytes = None
        for kind in (None, *QUANT_KINDS):
            torch.cuda.empty_cache()  # one engine's weights and pool at a time
            eng = engine_phase(torch, kind, model)
            suffix = f"_{kind}" if kind else ""
            for base in ("paged_decode", "paged_prefill"):
                launches[model][base + suffix] = eng["launches"][base + suffix]
                eager[model][base + suffix] = eng["eager"][base + suffix]
            if kind is None:
                base_bytes = eng["bytes"]
            else:
                ratio = {n: eng["bytes"][n] / base_bytes[n]
                         for n in base_bytes}
                log(f"engine[{model} {kind}] device bytes / bf16 engine's: "
                    f"{ {n: round(r, 4) for n, r in ratio.items()} } "
                    f"(max {BYTES_RATIO_MAX})")
                if max(ratio.values()) > BYTES_RATIO_MAX:
                    raise AssertionError(
                        f"{model} {kind} engine bytes not halved: {ratio}")
            backends_phase(torch, eng["engine"])
            if args.profile and kind in (None, "int8"):
                if model == "gpt" and kind is None:
                    decode_sweep(torch)
                profile_phase(torch, eng)
            del eng
    unshared_cost_phase(torch, card)
    # the prefix path: Llama-125M on shared-prefix traffic, its counts
    # reset just before each of its counted runs and read just after
    paths = (*FAMILIES, "llama_prefix")
    launches["llama_prefix"], eager["llama_prefix"] = {}, {}
    for kind in PREFIX_KINDS:
        torch.cuda.empty_cache()
        pre = prefix_phase(torch, kind, card, args.profile)
        suffix = f"_{kind}" if kind else ""
        for base in ("paged_decode", "paged_prefill"):
            launches["llama_prefix"][base + suffix] = pre["launches"][
                base + suffix]
            eager["llama_prefix"][base + suffix] = pre["eager"][base + suffix]

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
            "launches": sum(launches[m].get(name, 0) for m in paths),
            "launches_by_path": {m: launches[m].get(name, 0) for m in paths},
            "eager_launches": {m: eager[m].get(name, 0) for m in paths},
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "tflops": r["tflops"],
            "f32": rows[(name, "float32") + case],
        })
        if case:
            kernels[-1]["ragged"] = rows[(name, "bfloat16", "ragged")]
        else:  # B4: its split-K ranges, and the long sequence where timed
            kernels[-1]["nsplit"] = r["nsplit"]
            if (name, "bfloat16", "long") in rows:
                kernels[-1]["long"] = rows[(name, "bfloat16", "long")]
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
            "launches": sum(train[m]["launches"][name] for m in FAMILIES),
            "launches_by_path": {m: train[m]["launches"][name]
                                 for m in FAMILIES},
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
    # last, so that a disagreement leaves every other phase's reading
    for model in FAMILIES:
        train_backends_phase(torch, model)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
