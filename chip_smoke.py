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
   chunk at 575, a suffix chunk at 512, decode over shared blocks), and
   B5 at a 2048-token context, where the plain version streams;
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
10. runs speculative decoding on Llama-125M (``speculative_k`` 4, the
   n-gram drafter, ``engine_profile.spec_workload``: 8 prompts of a
   seeded motif repeated to 200-800 tokens, 64 new tokens, one sampled;
   the engine phases' geometry), bf16 then int8: a spec-off and a spec-on
   engine, each a warm-up pass and two counted passes (tokens/s; verify
   and decode steps; drafted, accepted and committed tokens; verify and
   decode step ms on the host clock; graphs by kind and capture seconds;
   every verify step one graph replay and one lag-0 sync, the streams
   equal pass to pass, the pool whole) and a traced pass (B5 launches 12
   x (prefill calls + verify steps), B4 12 x decode steps), the spec-on
   host time by part, each divergence of spec-on from spec-off with its
   row, position and spec-off top-2 logit gap, and the verify window's
   logits against the plain backend (LOGIT_TOL); then the same at f32,
   where spec-on must equal spec-off for 8 of 8; then the structured
   wave (bf16, spec off and on: JSON mode greedy and sampled, a schema,
   a stop sequence from the row's own unconstrained tokens, four
   unconstrained rows): grammar-valid constrained streams, the stop row
   cut after its stop sequence, the unconstrained rows byte for byte
   those of the batch with no constraint;
11. serves priority traffic on Llama-125M (``engine_profile.
   priority_workload``: 4 batch-class streams of 700 prompt and 160 new
   tokens on 256 blocks of 16, then two bursts of 4 interactive turns;
   prefix caching and a host tier that holds the traffic), preemption
   off and on, bf16: interactive TTFT p50/p99, the unloaded baseline
   (each turn alone), batch completion and tokens/s, parks, demotes,
   promotes, demote syncs, graphs by kind, each park's and resume's host
   ms; the counts must equal a CPU rehearsal's at tiny widths, every
   stream reach its budget, every parked stream resume, the pool be
   whole; a traced pass counts B4/B5 on the device; bf16 divergences
   of a greedy stream between off and on are printed with their top-2
   gap (at 0.05 or more a fault), and at f32 every greedy stream of the
   preemption-on engine must equal the preemption-off engine's; every
   token of the sampled stream (parked and resumed) of either engine
   must be its keyed draw's on logits recomputed alone, to 1e-4 of
   probability mass at f32 and 0.05 in bf16;
12. checks the observability surface on Llama-125M bf16 (``obs_phase``,
   the engine phases' geometry and workload): the metric families'
   counters against ``stats()`` and the streams, the TTFT and TPOT
   sample counts, the host-sync count against the flight ring, the
   paged launches of the trace against 12 x the ring's steps (every
   counted pass prints the two side by side and, where the trace is
   short, whether its missing launches lie at the pass's start, its end
   or in its middle: ``shortfall_where``), 4 host launch API
   calls a decode step, goodput and serving MFU, the instrumentation's
   host ms a step; then a chaos raise and a wedge (a 2 s delay, watchdog
   0.5 s) at the 10th decode step: every stream fails (the wedge within
   0.75 s), one dump each, the pool whole; then a fresh engine repeats
   the streams;
13. drives the port's distributed core (``core_phase``):
   ``ray_tpu_torch.init`` (the object store and the scheduler core built
   with g++ at first use) must autodetect ``GPU: 1``; a ``num_gpus=1``
   task must see ``CUDA_VISIBLE_DEVICES`` "0", one device and this card;
   Llama-125M's bf16 weights (the engine phases' seed) go through the
   object store as CPU tensors; a ``num_gpus=1`` actor builds
   ``LLMEngine`` on its ``cuda:0`` from them and serves the engine
   workload three times, its streams equal to this process's engine's on
   the same weights, its counted pass (profiled in the actor) launching
   B4 12 times a decode step and B5 12 times a prefill call by its trace
   and its flight ring; after ``kill`` its worker is gone, after
   ``shutdown`` the store, its workers and its ``rtt_store_<pid>_``
   segments; prints no-op task and actor-call round trips (p50, p99 of
   200), put/get GB/s of the weights, the actor's start seconds and
   tokens/s through the actor against in-process, beside the card line;
14. serves through the port's Serve (``serve_phase``): Llama-125M bf16
   in a ``num_gpus=1`` replica of ``build_llm_app`` behind the
   controller, router and standard-library HTTP proxy; ``serve.run`` to
   HEALTHY and the replica's start by part; the engine workload at once
   through the handle, over HTTP (server-sent events) and traced in the
   replica (tokens/s, TTFT p50/p99 beside in-process; streams against
   the in-process engine's by the top-2 gap rule; each request alone
   equal through the handle and over HTTP; B4/B5 launches 12 x the
   replica's flight ring, read through ``/debug/llm``, and by its trace);
   the controller killed while 8 streams run (every stream completes;
   the replica adopted); an f32 app refusing an overload burst with 503
   and each class's Retry-After (``serve_requests_shed`` = the 503s),
   then its replica killed mid-stream (the streams resumed on the
   replica the controller restarts: greedy equal to the uninterrupted
   in-process streams, sampled tokens their keyed draws'), after the
   driver dropped its own ref of the weights (``serve.run`` holds it);
   nothing left after shutdown;
15. trains through the port's Train (``trainer_phase``): Llama-125M at
   full width and depth, 16 x 1024, through ``TorchTrainer`` in a
   ``num_gpus=1`` gang reserved by a placement group, 8 steps, each on
   its own batch; checkpoints at steps 4 and 8 kept 2 by lowest loss;
   the worker kills its process after step 5 and the gang resumes from
   the step-4 checkpoint (``max_failures=1``). Every reported loss
   against the same loop run in this process (to the bit where two such
   runs agree to the bit), B1-B3 12 a step in the worker, the kept and
   best checkpoints, the best read back, and after ``fit`` the
   resources whole (the state API), the workers dead and the groups
   removed; prints step ms through the gang and in process, each
   checkpoint's bytes and save seconds, and the seconds from the death
   to the resumed attempt's first step;
16. trains from the port's Data (``data_phase``): 8 ``.npy`` files of 64
   x 1025 int32 token ids from a seed, ``read_numpy`` -> ``map_batches``
   (int64, ``tokens``; a task stage) -> ``random_shuffle`` (seeded), each
   stage materialized and timed; then Llama-125M at full width and depth
   through ``TorchTrainer(datasets={"train": ds})`` in a ``num_gpus=1``
   gang, the dataset ``streaming_split`` into it and read by
   ``iter_torch_batches`` (pinned staging, 2 batches ahead) onto the
   card: 32 steps of 16 x 1024. Every sequence of the files once across
   the gang's batches, each batch's digest that of the driver's
   ``iter_batches`` of the same dataset, every loss against the same
   batches trained in this process (TRAINER_LOSS_TOL; equal to the bit
   reported), B1-B3 384 launches each, the batches on ``cuda:0``; prints
   the stages' seconds, blocks and bytes, step ms through the gang and
   in process, the wait in ``next()`` and the phase's seconds against
   its 60 s target;
17. prints the kernels' JSON line (a kernel's ``launches``: the sum over
   the paths, each counted alone, ``launches_by_path``: the two
   families' engine and training paths, the prefix path, the
   speculative path ``llama_spec``, the preemption path
   ``llama_preempt``, the observability path ``llama_obs``, the MoE
   path ``llama_moe``, the core path ``llama_core`` (the actor's
   flight ring), the Serve path ``llama_serve`` (the replica's), the
   Train path ``llama_trainer`` (B1-B3, the gang worker's counts) and
   the Data path ``llama_data`` (B1-B3, its gang worker's counts);
   a paged
   kernel's on the device in its engine's counted pass, from the trace;
   ``eager_launches``: its wrapper's count in that pass) and the card's
   line;
18. for each model (GPT-2 125M, Llama-125M, Llama-125M-MoE), on its
   training phase's first weights and batch ([16, 1025]), holds the loss
   through the CUDA kernels against the plain backend's (LOSS_TOL) and
   every gradient against the model in f32, no further from it than the
   plain bf16 path's up to the margin derived from control runs
   (``grad_agreement.gate``; the CUDA-vs-plain reading printed beside);
   prints the whole run's seconds, then ``{"ok": true, "device": ...}``
   last.

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
import gc
import json
import math
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
# few rounding units of the loss (the gradients: grad_agreement.gate)
LOSS_TOL = 1e-2        # absolute, on a loss of about 10.8

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
MOE = "llama_moe"  # Llama-125M-MoE (families.MODELS)
NAMES = {"gpt": "GPT-2 125M", "llama": "Llama-125M",
         MOE: "Llama-125M-MoE"}
# a route of the CUDA path may differ from the plain path's only at a
# near-tie: the plain run's gap between the two competing router
# probabilities (renormalised over its top k) below this, or as a cascade
# of such a flip (``route_flips``)
ROUTE_TIE = 0.02


def train_phase(torch, model="gpt", card="") -> dict:
    """Train steps of a model at full width (``families.MODELS``: a
    family's ``full()``, or Llama-125M-MoE) through the port's entry
    point; checks the losses and that each flash kernel ran once per
    layer and step."""
    import math

    from ray_tpu_torch.benchmarks.gpt_mfu import run_gpt_bench
    from ray_tpu_torch.models.families import full_config
    from ray_tpu_torch.ops import attention as at

    fam, cfg = full_config(model)
    n_layer = cfg.n_layer
    at.reset_launches()
    out = run_gpt_bench(model=fam, config=cfg, **TRAIN)
    launches = dict(at.LAUNCHES)
    want = {name: n_layer * (TRAIN["warmup"] + TRAIN["steps"])
            for name in launches}
    losses = out["losses"]
    log(f"train: {NAMES[model]} {out['n_params']} params "
        f"({out['n_active_params']} active a token), batch "
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
    the plain backend and against the plain backend at f32, on the
    training phase's first step: its weights (seed 0) and its batch
    (``TRAIN``'s size, tokens from seed 1). The gate
    (``grad_agreement.gate``, derived from the control runs): for every
    parameter the CUDA path's gradient no further from f32 than the plain
    bf16 path's, up to ``GATE_RATIO`` x + ``GATE_ABS`` x the median of
    the plain path's distances; the CUDA-vs-plain reading is printed
    beside it. For an MoE model the routes of the two
    bf16 forwards are compared first (``route_flips``), and the share of
    (token, choice) pairs dropped is printed."""
    from ray_tpu_torch.benchmarks import grad_agreement as ga
    from ray_tpu_torch.benchmarks.gpt_mfu import bench_batch
    from ray_tpu_torch.models.families import family, full_config

    fam, base = full_config(model)
    configs = ga.backend_configs(base)
    batch = bench_batch(base, TRAIN["batch_size"], TRAIN["seq_len"], 1,
                        "cuda")
    loss, grads, routes = {}, {}, {}
    for name, cfg in configs.items():
        m = family(fam).init(cfg, seed=0, device="cuda", train=True)
        moe = getattr(m, "moe", None) is not None and name != "f32"
        if moe:
            m.route_log = []
        value = m.loss(batch)
        value.backward()
        loss[name] = value.item()
        grads[name] = {n: p.grad.float() for n, p in m.named_parameters()}
        if moe:
            routes[name] = m.route_log
        del m, value
        torch.cuda.empty_cache()
    dloss = abs(loss["cuda"] - loss["torch"])
    cuda_f32 = ga.rel_l2(grads["cuda"], grads["f32"])
    plain_f32 = ga.rel_l2(grads["torch"], grads["f32"])
    cuda_plain = ga.rel_l2(grads["cuda"], grads["torch"])
    gate = ga.gate(cuda_f32, plain_f32)
    worst = max(cuda_plain, key=cuda_plain.get)
    tag = f"train [{model}]"
    if routes:
        S = TRAIN["seq_len"]
        flips = route_flips(routes["cuda"], routes["torch"], S)
        log_flips(tag, flips)
        dropped = [1 - r.keep.float().mean().item() for r in routes["cuda"]]
        log(f"{tag}: (token, choice) pairs dropped at step 0 (capacity "
            f"{routes['cuda'][0].capacity} a expert): "
            f"{statistics.mean(dropped):.4f} of all, by layer "
            f"{[round(d, 4) for d in dropped]}")
    log(f"{tag} cuda vs torch backend: loss {loss['cuda']:.6f} vs "
        f"{loss['torch']:.6f} (f32 {loss['f32']:.6f}; |diff| {dloss:.3e}, "
        f"tol {LOSS_TOL}); gate: worst {gate['param']} cuda_f32 "
        f"{gate['cuda_f32']:.3e} <= {ga.GATE_RATIO} x plain_f32 "
        f"{gate['plain_f32']:.3e} + {gate['absolute']:.3e} ({ga.GATE_ABS} x "
        f"the median) = {gate['bar']:.3e} "
        f"(slack {gate['slack']:.3f}; max ratio {gate['max_ratio']:.4f} at "
        f"{gate['max_ratio_param']}); beside it cuda vs plain worst "
        f"{cuda_plain[worst]:.3e} ({worst}; median "
        f"{statistics.median(cuda_plain.values()):.3e})")
    if not dloss <= LOSS_TOL:
        raise AssertionError(f"losses disagree: {loss}")
    if not gate["ok"]:
        raise AssertionError(f"{tag}: gradient {gate['param']} further from "
                             f"f32 than the plain path's: {gate}")
    return {"loss_diff": dloss, "gate": gate,
            "cuda_plain": cuda_plain[worst]}


def profile_train(torch, model="gpt") -> None:
    """Two warm train steps of a model at full width (``families.MODELS``)
    under torch.profiler: device time by kernel and the device's idle
    share."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.benchmarks.engine_profile import device_rows
    from ray_tpu_torch.benchmarks.gpt_mfu import (
        bench_batch,
        make_optimizer,
        train_step,
    )
    from ray_tpu_torch.models.families import family, full_config

    fam, cfg = full_config(model)
    net = family(fam).init(cfg, seed=0, device="cuda", train=True)
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

def weight_bytes(model, names=None) -> int:
    """Device bytes of a model's weights (quantized: data and scales), of
    those in ``names`` if given."""
    from ray_tpu_torch.ops.quantization import QuantizedTensor

    return sum(w.nbytes() if isinstance(w, QuantizedTensor)
               else w.numel() * w.element_size()
               for n, w in model.weights().items()
               if names is None or n in names)


def moe_weight_bytes(model) -> dict:
    """An MoE model's weight bytes by kind: ``experts`` (never quantized),
    ``quantizable`` (the leaves a quantized engine quantizes, its
    ``llama_quant_axes`` >= 0) and ``rest`` (norm scales and routers)."""
    from ray_tpu_torch.models.llama import llama_quant_axes

    axes = llama_quant_axes(model.cfg)
    experts = {n for n in axes if "moe_w_" in n}
    quantizable = {n for n, a in axes.items() if a >= 0}
    return {"experts": weight_bytes(model, experts),
            "quantizable": weight_bytes(model, quantizable),
            "rest": weight_bytes(model, set(axes) - experts - quantizable)}


def engine_phase(torch, quant=None, model="gpt") -> dict:
    """The engine workload (``quant``: None for bf16, or a quantization
    kind; ``model`` a name of ``families.MODELS``) on the lag-1 pipeline
    and its decode graphs. A first pass
    captures the graphs; a second, timed, must repeat its streams and
    replay a graph at every decode step, its wrappers launching B5 (and
    no B4) eagerly; a third, the counted pass, runs under the profiler
    with the launch counts reset just before it: its trace must show the
    path's kernels launched 12 layers x its calls on the device (B4 from
    the graph replays), every other paged kernel never."""
    from ray_tpu_torch.benchmarks import engine_profile as ep
    from ray_tpu_torch.models.families import full_config
    from ray_tpu_torch.ops import paged_attention as pa

    engine = ep.make_engine(quant, model)
    cfg = engine.model_cfg
    assert engine.device.type == "cuda", engine.device
    assert engine.executor.quantization == quant
    assert engine.executor.family == full_config(model)[0]
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
            if r["kind"] == "decode" and "sync_lag" in r]
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
    mark = ring_mark(engine)
    prof, (prefill_calls, decode_steps, replays) = calls(
        lambda: ep.profiled_pass(torch, engine, prompts, params))
    eager = dict(pa.LAUNCHES)
    launches = dict.fromkeys(pa.LAUNCHES, 0)
    launches.update(prof["paged_launches"])
    recs = ring_records(engine.debug_dump(), mark)
    ring = ring_counts(recs, cfg.n_layer, suffix)
    log_launch_counts(tag, launches, ring, prof["paged_walls"], recs,
                      cfg.n_layer)
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
            "tokens_per_s": ntok / run["seconds"], "window": window,
            "decode_ms": 1e3 * statistics.mean(steps["decode"]),
            "prefill_ms": 1e3 * statistics.mean(steps["prefill"]),
            "ring": ring, "outs": outs}


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
    moe = getattr(model, "moe", None) is not None
    args = (g.inputs["tokens"], g.inputs["positions"], g.inputs["tables"])

    def step():
        if moe:  # the routes of every layer, as graph outputs under capture
            model.route_log = []
        return model.decode_step(cache.k, cache.v, *args)[0]

    want = step()
    eager_routes = model.route_log if moe else None
    # an MoE step captures with host syncs raising (no nonzero, no .item(),
    # no shape from the data)
    no_sync = (torch.cuda.set_sync_debug_mode if moe
               else lambda mode: None)
    no_sync("error")
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=ex.fns.pool):
            out = step()
    finally:
        no_sync("default")
    graph.replay()
    torch.cuda.synchronize()
    diff = (out - want).abs().max().item()
    routes = ""
    if moe:
        graph_routes, model.route_log = model.route_log, None
        same = all(torch.equal(getattr(a, f), getattr(b, f))
                   for a, b in zip(graph_routes, eager_routes)
                   for f in ("experts", "slots", "keep"))
        routes = (f"; routes of {len(graph_routes)} layers "
                  f"{'equal' if same else 'DIFFER'} (captured with sync "
                  f"debug mode 'error')")
        if not same or len(graph_routes) != cfg.n_layer:
            raise AssertionError(f"{tag}: the replay's routes differ from "
                                 f"the eager step's")
    log(f"{tag}: logits max_abs_diff {diff:.3e} (tol {LOGIT_TOL}){routes}")
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


def long_prefill_phase(torch) -> None:
    """B5 against its plain version at a 2048-token context (bf16 q and
    pool, Llama-125M's heads): there the plain version takes its
    streaming branch (``ops/kv_cache.PREFILL_STREAM_MIN_T``, the JAX
    package's online softmax over one block slab at a time)."""
    from ray_tpu_torch.ops import kv_cache as kv_ops
    from ray_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(12)
    B, S, Hkv, G, hd, bs, NB = 2, 64, 4, 3, 64, 16, 128
    if NB * bs < kv_ops.PREFILL_STREAM_MIN_T:
        raise AssertionError("the case must reach the streaming branch")
    k, v = make_pool(torch, gen, torch.bfloat16, 1 + B * NB, bs, Hkv, hd)
    tables = (torch.randperm(B * NB, generator=gen, device="cuda") + 1).to(
        torch.int32).view(B, NB)
    pos = (NB * bs - S + torch.arange(S, device="cuda", dtype=torch.int32))[
        None].repeat(B, 1).contiguous()
    q = torch.randn(B, S, Hkv * G, hd, generator=gen, device="cuda").to(
        torch.bfloat16)
    got = pa.paged_prefill_attention_cuda(q, k, v, tables, pos)
    want = kv_ops.paged_prefill_attention(q, k, v, tables, pos)
    torch.cuda.synchronize()
    compare(f"B5 at T {NB * bs} vs the streaming plain version", got, want,
            "bfloat16")


def ring_mark(engine) -> int:
    """The engine's flight-ring step count now (``ring_records`` takes
    the records after it)."""
    return engine.debug_dump()["steps_total"]


def ring_records(dump: dict, since: int) -> list:
    """The flight ring's records after step ``since`` of a
    ``debug_dump()``; raises if the ring dropped any of them."""
    recs = [r for r in dump["steps"] if r["step"] > since]
    if dump["steps_total"] - since != len(recs):
        raise AssertionError(
            f"the flight ring ({dump['capacity']}) lost records of the pass")
    return recs


def _launching(name: str, r: dict) -> bool:
    """Whether ring record ``r`` launched paged kernel ``name``: B4 in a
    decode step that dispatched, B5 in a prefill call or verify step."""
    if name.startswith("paged_decode"):
        return r["kind"] == "decode" and r["batch"] > 0
    return r["kind"] in ("prefill", "prefill_chunk", "verify")


def ring_counts(recs: list, n_layer: int, suffix: str = "") -> dict:
    """A second count of a pass's paged launches, not from the profiler:
    the flight ring's records of the pass (``ring_records``) give its
    decode steps that dispatched (B4: n_layer each) and its prefill calls
    and verify steps (B5: n_layer each)."""
    return {name + suffix: n_layer * sum(_launching(name, r) for r in recs)
            for name in ("paged_decode", "paged_prefill")}


def shortfall_where(name: str, walls: list, recs: list, n_layer: int) -> str:
    """Where the launches of ``name`` that a trace lacks lie in the pass
    (ROADMAP Queue C 4): ring steps that launch it and whose next step
    ended before the trace's first launch of it (under the lag-1 pipeline
    a step's kernels run at most a step late, so these ran before the
    first traced launch: lost at the start), steps that began after its
    last launch (lost at the end), and the rest (lost in the middle, or
    one step at an edge). ``walls``: the trace's launch start times (wall
    seconds, ``engine_profile.paged_walls``); ``recs``: the ring's records
    of the pass (wall ``ts``, host ``dur_ms``)."""
    steps = [r for r in recs if _launching(name, r)]
    if not walls:
        return f"{name}: no launch in the trace, {len(steps)} ring steps"
    first, last = walls[0], walls[-1]
    ends = [r["ts"] + r.get("dur_ms", 0.0) / 1e3 for r in recs]
    before = sum(_launching(name, r) and i + 1 < len(recs)
                 and ends[i + 1] < first for i, r in enumerate(recs))
    after = sum(r["ts"] > last for r in steps)
    missing = len(steps) - len(walls) // n_layer
    return (f"{name}: the trace holds {len(walls)} launches "
            f"({len(walls) / n_layer:g} steps of {n_layer}) against "
            f"{len(steps)} ring steps; missing at the start {before} "
            f"steps, at the end {after}, the rest {missing - before - after}"
            f" (in the middle, or one step at an edge)")


def log_launch_counts(tag, traced: dict, ring: dict, walls: dict,
                      recs: list, n_layer: int) -> None:
    """The trace's paged launches beside the ring's, and where they
    differ, which of the two is short; where the trace is short, where in
    the pass its shortfall lies (``shortfall_where``, from the trace's
    launch times ``walls`` and the ring's records ``recs``)."""
    parts = []
    for name, n in ring.items():
        t = traced.get(name, 0)
        verdict = ("equal" if t == n else f"the trace is short by {n - t}"
                   if t < n else f"the ring is short by {t - n}")
        parts.append(f"{name} trace {t} / ring {n} ({verdict})")
        if t < n:
            parts[-1] += "; " + shortfall_where(name, walls.get(name, []),
                                                recs, n_layer)
    log(f"{tag}: paged launches, the trace beside the engine's flight ring "
        f"x n_layer: " + "; ".join(parts))


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
            ep.anchor(prof)
            yield
        profs.append(prof)

    pa.reset_launches()
    mark = ring_mark(engine)
    counted = prefix_waves(torch, engine, work, sources_unchanged,
                           wave_context, timed_moves=False)
    eager = dict(pa.LAUNCHES)
    launches = dict.fromkeys(pa.LAUNCHES, 0)
    walls: dict = {}
    for prof in profs:
        for name, n in ep.paged_launches(prof).items():
            launches[name] += n
        for name, w in ep.paged_walls(prof).items():
            walls[name] = sorted(walls.get(name, []) + w)
    recs = ring_records(engine.debug_dump(), mark)
    log_launch_counts(tag, launches, ring_counts(
        recs, cfg.n_layer, f"_{kind}" if kind else ""), walls, recs,
        cfg.n_layer)
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


# -------------------------------------------------------------- spec phase

SPEC_K = 4
SPEC_KINDS = (None, "int8")
SPEC_PASSES = 2
# a JSON-Schema of the structured-output tests' corpus
# (tests/test_torch_structured.py SCHEMAS[1])
SPEC_SCHEMA = {"type": "object", "properties": {
    "n": {"type": "integer"}, "tag": {"enum": ["x", "y"]}}}
STRUCTURED_LENGTHS = (30, 64, 120, 200, 45, 90, 150, 180)
STRUCTURED_NEW_TOKENS = 64


def spec_engine(kind=None, spec=False, dtype=None):
    """The engine phases' Llama-125M engine (1024 blocks of 16, batch 8,
    chunks of 256, prefix caching off), with ``speculative_k`` = SPEC_K
    and the n-gram drafter when ``spec``."""
    from ray_tpu_torch.benchmarks import engine_profile as ep

    extra = dict(speculative_k=SPEC_K, drafter="ngram") if spec else {}
    return ep.make_engine(kind, "llama", dtype=dtype, **extra)


def counting_verify_syncs(engine) -> list:
    """Count the executor's ``sync_verify`` calls (the verify step's D2H)
    and the real rows of each verify step; returns [syncs, rows]."""
    ex, n = engine.executor, [0, 0]
    sync, record = ex.sync_verify, engine._sync_verify_locked

    def counted(ids):
        n[0] += 1
        return sync(ids)

    def rows(packed_dev, batch):
        n[1] += batch
        return record(packed_dev, batch)

    ex.sync_verify = counted
    engine._sync_verify_locked = rows
    return n


def pool_whole(engine, tag) -> None:
    c = engine.cache
    snap = c.debug_snapshot()
    if (c.free_blocks != c.cfg.usable_blocks or c.reserved_blocks != 0
            or snap["freed_total"] != snap["allocated_total"]):
        raise AssertionError(f"{tag}: pool not whole: {snap}")


def next_logits(torch, engine, tokens):
    """The next-token logits after ``tokens`` on the engine's model ([V]
    f32): a prefill into a scratch pool of its own."""
    from ray_tpu_torch.models.families import kv_heads
    from ray_tpu_torch.serve.llm.kv_cache import KVCacheConfig, PagedKVCache

    cfg = engine.model_cfg
    bs = 16
    nb = -(-len(tokens) // bs)
    cache = PagedKVCache(KVCacheConfig(
        n_layer=cfg.n_layer, n_kv_head=kv_heads(cfg), head_dim=cfg.head_dim,
        num_blocks=nb + 1, block_size=bs, dtype=cfg.dtype, device="cuda",
        quantization=cfg.quantization))
    t = torch.tensor([tokens], dtype=torch.int32, device="cuda")
    n = torch.tensor([len(tokens)], dtype=torch.int32, device="cuda")
    tables = torch.arange(1, nb + 1, dtype=torch.int32,
                          device="cuda")[None, :]
    logits, _, _ = engine.executor.model.prefill(cache.k, cache.v, t, n,
                                                 tables)
    return logits[0].float()


def top2_gap(torch, engine, tokens) -> float:
    """The gap between the two largest next-token logits after ``tokens``
    on the engine's model."""
    top = torch.topk(next_logits(torch, engine, tokens), 2).values
    return float(top[0] - top[1])


def draw_slip(torch, engine, tokens, sp, token) -> float:
    """For a row sampled under ``sp`` (temperature, top-k, top-p, seed)
    that drew ``token`` after ``tokens``: how far, in probability mass,
    its keyed draw for position ``len(tokens)`` lies outside ``token``'s
    interval of the CDF (``ops/sampling._sampled_rows``'s) on the
    next-token logits after ``tokens``; 0 where the draw picks
    ``token``. Two numerically different paths may draw different tokens
    only where the draw lies near an edge, so a draw of the wrong key or
    position shows as a slip far above the logits' noise."""
    from ray_tpu_torch.ops.sampling import keyed_uniform

    scaled = next_logits(torch, engine, tokens).cpu() / max(sp.temperature,
                                                             1e-6)
    srt, idx = torch.sort(scaled, descending=True, stable=True)
    if sp.top_k > 0:
        srt[sp.top_k:] = float("-inf")
    probs = torch.softmax(srt, -1)
    if 0.0 < sp.top_p < 1.0:
        srt[(torch.cumsum(probs, -1) - probs) >= sp.top_p] = float("-inf")
        probs = torch.softmax(srt, -1)
    cdf = torch.cumsum(probs, -1)
    u = float(keyed_uniform([sp.seed & 0xFFFFFFFF], [len(tokens)])[0])
    rank = int((idx == token).nonzero()[0, 0])
    lo = float(cdf[rank - 1]) if rank else 0.0
    return max(lo - u, u - float(cdf[rank]), 0.0)


def spec_passes(torch, engine, prompts, params, tag, card) -> dict:
    """One warm-up pass (the graphs captured), then SPEC_PASSES counted
    passes timed on the host clock: each must repeat the first's streams,
    replay a graph for every decode and verify step (no new capture) and
    sync once a verify step at lag 0; the pool whole after each."""
    from ray_tpu_torch.benchmarks import engine_profile as ep

    fns = engine.fns
    warm = ep.spec_serve(torch, engine, prompts, params)
    graphs, capture_s = fns.graphs_by_kind(), fns.capture_seconds
    syncs = counting_verify_syncs(engine)
    runs = []
    for _ in range(SPEC_PASSES):
        was = (engine.num_decode_steps, engine.num_verify_steps,
               dict(fns.kind_replays), syncs[0], syncs[1])
        st0 = engine.stats()
        run = ep.spec_serve(torch, engine, prompts, params)
        st = engine.stats()
        run["decode_steps"] = engine.num_decode_steps - was[0]
        run["verify_steps"] = engine.num_verify_steps - was[1]
        run["verify_rows"] = syncs[1] - was[4]
        run["spec"] = {k: st[k] - st0[k] for k in (
            "spec_drafted_tokens", "spec_accepted_tokens",
            "spec_committed_tokens")}
        replays = {k: fns.kind_replays[k] - was[2][k] for k in was[2]}
        if (fns.graphs_by_kind() != graphs
                or replays != {"decode": run["decode_steps"],
                               "verify": run["verify_steps"]}
                or syncs[0] - was[3] != run["verify_steps"]):
            raise AssertionError(
                f"{tag}: {replays} graph replays, {syncs[0] - was[3]} verify "
                f"syncs for {run['decode_steps']} decode and "
                f"{run['verify_steps']} verify steps; graphs "
                f"{fns.graphs_by_kind()} (captured {graphs})")
        pool_whole(engine, tag)
        runs.append(run)
    lags = {r["sync_lag"] for r in engine.debug_dump()["steps"]
            if r["kind"] == "verify"}
    if runs[-1]["verify_steps"] and lags != {0}:
        raise AssertionError(f"{tag}: verify syncs at lags {lags}")
    if any(r["outs"] != runs[0]["outs"] for r in runs):
        raise AssertionError(f"{tag}: a second pass differs from the first")
    for o in runs[0]["outs"]:
        if len(o) != ep.SPEC_NEW_TOKENS:
            raise AssertionError(f"{tag}: bad stream length {len(o)}")
    ntok = sum(map(len, runs[0]["outs"]))
    tps = [ntok / r["seconds"] for r in runs]
    ms = {k: 1e3 * statistics.mean(x for r in runs for x in r["steps"][k])
          for k in ("prefill", "decode", "verify")
          if any(r["steps"][k] for r in runs)}
    sp = runs[0]["spec"]
    vsteps, vrows = runs[0]["verify_steps"], runs[0]["verify_rows"]
    log(f"{tag}: {ntok} tokens a pass; tokens/s "
        f"{', '.join(f'{t:.1f}' for t in tps)}; "
        f"{vsteps} verify and {runs[0]['decode_steps']} decode steps, "
        f"{len(runs[0]['steps']['prefill'])} prefill calls a pass; drafted "
        f"{sp['spec_drafted_tokens']}, accepted {sp['spec_accepted_tokens']}"
        f", committed {sp['spec_committed_tokens']} (accept rate "
        f"{sp['spec_accepted_tokens'] / max(1, sp['spec_drafted_tokens']):.4f}"
        f", committed per verify step "
        f"{sp['spec_committed_tokens'] / max(1, vsteps):.4f} over the batch, "
        f"{sp['spec_committed_tokens'] / max(1, vrows):.4f} a row of "
        f"{vrows} row-steps); step ms "
        f"(host clock, mean of {SPEC_PASSES} passes) "
        f"{ {k: round(v, 4) for k, v in ms.items()} }; graphs captured "
        f"{graphs} in {capture_s:.3f} s (warm-up pass "
        f"{warm['seconds']:.3f} s); {card}")
    return {"outs": runs[0]["outs"], "tokens_per_s": tps, "step_ms": ms,
            "verify_steps": vsteps, "spec": sp}


def spec_counted_pass(torch, engine, prompts, params, kind, tag) -> dict:
    """One more pass under the profiler, the launch counts reset just
    before it: B5 (B5q) 12 layers x (prefill calls + verify steps), B4
    (B4q) 12 x decode steps on the device, from the trace; every other
    paged kernel never."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.benchmarks import engine_profile as ep
    from ray_tpu_torch.ops import paged_attention as pa

    suffix = f"_{kind}" if kind else ""
    n_layer = engine.model_cfg.n_layer
    pa.reset_launches()
    was = (engine.num_prefill_calls, engine.num_decode_steps,
           engine.num_verify_steps)
    mark = ring_mark(engine)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ep.anchor(prof)
        run = ep.spec_serve(torch, engine, prompts, params)
    eager = dict(pa.LAUNCHES)
    calls = (engine.num_prefill_calls - was[0],
             engine.num_decode_steps - was[1],
             engine.num_verify_steps - was[2])
    launches = dict.fromkeys(pa.LAUNCHES, 0)
    launches.update(ep.paged_launches(prof))
    recs = ring_records(engine.debug_dump(), mark)
    log_launch_counts(tag, launches, ring_counts(recs, n_layer, suffix),
                      ep.paged_walls(prof), recs, n_layer)
    want = dict.fromkeys(launches, 0)
    want["paged_decode" + suffix] = n_layer * calls[1]
    want["paged_prefill" + suffix] = n_layer * (calls[0] + calls[2])
    rows = ep.device_rows(prof)
    busy_ms = sum(r[0] for r in rows) / 1e3
    wall_ms = run["seconds"] * 1e3
    log(f"{tag}: counted pass: {calls[0]} prefill calls, {calls[1]} decode "
        f"steps, {calls[2]} verify steps; launches on the device (trace) "
        f"{launches} (expected {want}); eager wrapper launches {eager}; "
        f"wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f}")
    if launches != want:
        raise AssertionError(f"{tag}: launch counts {launches} != {want}")
    return {"launches": launches, "eager": eager, "calls": calls}


def spec_host_breakdown(torch, engine, prompts, params, tag) -> None:
    """One more pass of a spec-on engine with its host work timed by part
    (perf_counter around the engine's and executor's methods): drafting
    (every step drafts, a decode step too), staging a verify step, its
    replay and the ids' copy queued, the wait for its verdicts, emitting,
    and the rest of the verify step; per verify step, beside the step's
    host time."""
    from ray_tpu_torch.benchmarks import engine_profile as ep

    ex = engine.executor
    spent = {}

    def timed(owner, name, part):
        fn = getattr(owner, name)

        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[part] = spent.get(part, 0.0) + time.perf_counter() - t0

        setattr(owner, name, wrapper)

    for owner, name, part in (
            (engine, "_propose_drafts_locked", "draft"),
            (engine, "_verify_locked", "verify step"),
            (engine, "_emit_token_locked", "emit"),
            (ex, "stage_verify", "stage"),
            (ex, "verify_step", "stage + replay"),
            (ex, "sync_verify", "sync wait")):
        timed(owner, name, part)
    was = engine.num_verify_steps
    run = ep.spec_serve(torch, engine, prompts, params)
    for name in ("_propose_drafts_locked", "_verify_locked",
                 "_emit_token_locked"):
        delattr(engine, name)
    for name in ("stage_verify", "verify_step", "sync_verify"):
        delattr(ex, name)
    n = engine.num_verify_steps - was
    spent["replay"] = spent.pop("stage + replay") - spent["stage"]
    log(f"{tag}: host ms a verify step, by part (one pass, {n} verify "
        f"steps, {len(run['steps']['decode'])} decode steps): "
        + ", ".join(f"{k} {1e3 * v / max(n, 1):.3f}"
                    for k, v in spent.items())
        + " (draft and emit also count decode steps' calls; emit inside "
        "the verify step)")


def verify_logits_check(torch, engine, tag) -> float:
    """The verify step's window logits (``sample=None``) through the CUDA
    kernels against the plain backend on the same weights, pool and window:
    8 sequences of 37-900 tokens prefilled into free blocks of the idle
    pool, windows of 5 starting mid-block, draft lengths 0-4 (LOGIT_TOL
    on the valid columns)."""
    import numpy as np

    from ray_tpu_torch.models.families import family

    ex = engine.executor
    cfg, cache = engine.model_cfg, engine.cache
    if cache.used_blocks:
        raise AssertionError("verify_logits_check needs an idle pool")
    rng = np.random.default_rng(8)
    B, nb, W = 8, 64, SPEC_K + 1
    lengths = np.array([37, 250, 401, 512, 640, 700, 813, 900], np.int32)
    tables = np.arange(1, 1 + B * nb, dtype=np.int32).reshape(B, nb)
    tokens = rng.integers(0, cfg.vocab_size, (B, 1024)).astype(np.int32)
    first = ex.sync_tokens(ex.prefill(tokens, lengths, tables))
    window = rng.integers(0, cfg.vocab_size, (B, W)).astype(np.int32)
    window[:, 0] = first
    dlen = np.array([4, 3, 0, 2, 4, 1, 4, 4], np.int32)
    g = ex.stage_verify(window, lengths, dlen, tables)
    got = ex.fns.verify(g.inputs, False, False, logits=True)
    base = ex.model
    plain = type(base)(dataclasses.replace(base.cfg, attention_backend="torch"),
                       base.device)
    plain.load_weights(base.weights())
    want, _, _ = family("llama").verify_step(
        plain, cache.k, cache.v, g.inputs["tokens"], g.inputs["starts"],
        g.inputs["draft_len"], g.inputs["tables"])
    valid = (torch.arange(W, device="cuda")[None, :]
             <= g.inputs["draft_len"][:, None])
    if not torch.isfinite(got).all():
        raise AssertionError(f"{tag}: non-finite verify logits")
    diff = (got - want).abs()[valid].max().item()
    log(f"{tag}: verify window logits cuda vs plain backend: max_abs_diff "
        f"{diff:.3e} over {int(valid.sum())} columns (tol {LOGIT_TOL})")
    if not diff <= LOGIT_TOL:
        raise AssertionError(f"{tag}: verify logits differ by {diff}")
    del plain
    return diff


def spec_phase(torch, kind, card) -> dict:
    """Llama-125M (``kind``: None for bf16, or "int8") on
    ``engine_profile.spec_workload``: a spec-off and a spec-on engine
    (``speculative_k`` = SPEC_K, n-gram drafter), each through
    ``spec_passes`` and a counted pass (the spec-on engine's launches are
    the path "llama_spec"); the spec-on streams against the spec-off ones
    (each divergence printed with its row, position and the spec-off
    top-2 logit gap there: bf16 identity across B4 and B5, and across
    [B, 1] and [B, 5] matmuls, is not a property of the card), then the
    verify window's logits against the plain backend's."""
    from ray_tpu_torch.benchmarks import engine_profile as ep

    name = f"llama {kind or 'bf16'}"
    result = {}
    engines = {}
    for spec in (False, True):
        torch.cuda.empty_cache()
        eng = spec_engine(kind, spec)
        if eng.executor.quantization != kind:
            raise AssertionError(f"engine quantization {kind}")
        tag = f"spec[{name} {'on' if spec else 'off'}]"
        prompts, params = ep.spec_workload(eng.model_cfg.vocab_size)
        result[spec] = spec_passes(torch, eng, prompts, params, tag, card)
        result[spec].update(spec_counted_pass(torch, eng, prompts, params,
                                              kind, tag))
        if spec and not (result[spec]["verify_steps"]
                         and result[spec]["calls"][2]):
            raise AssertionError(f"{tag}: no verify step ran")
        if spec:
            spec_host_breakdown(torch, eng, prompts, params, tag)
        engines[spec] = eng
    off, on = result[False]["outs"], result[True]["outs"]
    same = sum(a == b for a, b in zip(off, on))
    log(f"spec[{name}]: spec-on streams equal spec-off in {same} of "
        f"{len(off)}; tokens/s on / off = "
        f"{statistics.mean(result[True]['tokens_per_s']) / statistics.mean(result[False]['tokens_per_s']):.4f}; "
        f"verify step / decode step = "
        f"{result[True]['step_ms'].get('verify', float('nan')) / result[False]['step_ms']['decode']:.4f}")
    for row, (a, b) in enumerate(zip(off, on)):
        if a != b:
            pos = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            gap = top2_gap(torch, engines[False], prompts[row] + a[:pos])
            log(f"spec[{name}]: row {row} diverges at generated position "
                f"{pos} (off {a[pos]}, on {b[pos]}); spec-off top-2 logit "
                f"gap there {gap:.4e}")
    verify_logits_check(torch, engines[True], f"spec[{name}]")
    del engines
    return {"launches": result[True]["launches"],
            "eager": result[True]["eager"]}


def spec_lossless_phase(torch, card) -> None:
    """The spec phase at the model's f32 (B4 and B5 take f32 q; TF32 is
    off): spec-on streams equal spec-off streams, 8 of 8, greedy and
    sampled."""
    from ray_tpu_torch.benchmarks import engine_profile as ep

    outs = {}
    for spec in (False, True):
        torch.cuda.empty_cache()
        eng = spec_engine(None, spec, dtype=torch.float32)
        prompts, params = ep.spec_workload(eng.model_cfg.vocab_size)
        ep.spec_serve(torch, eng, prompts, params)
        run = ep.spec_serve(torch, eng, prompts, params)
        outs[spec] = run["outs"]
        st = eng.stats()
        ntok = sum(map(len, run["outs"]))
        log(f"spec[llama f32 {'on' if spec else 'off'}]: {ntok / run['seconds']:.1f}"
            f" tokens/s; verify steps {len(run['steps']['verify'])}, decode "
            f"steps {len(run['steps']['decode'])}; spec_accept_rate "
            f"{st['spec_accept_rate']:.4f}, committed per step "
            f"{st['spec_committed_per_step']:.4f}; {card}")
        pool_whole(eng, "spec[llama f32]")
        del eng
    same = sum(a == b for a, b in zip(outs[False], outs[True]))
    log(f"spec[llama f32]: spec-on streams equal spec-off in {same} of "
        f"{len(outs[True])}")
    if same != len(outs[True]):
        raise AssertionError("f32 speculation is not lossless")


def structured_requests(vocab_size, stop=None, constrained=True):
    """The structured wave: 8 prompts of STRUCTURED_LENGTHS tokens; rows
    0-1 JSON mode (greedy, sampled), row 2 the schema, row 3 greedy with
    the stop sequence ``stop``, rows 4-7 unconstrained (row 5 sampled).
    ``constrained=False`` drops every constraint and stop."""
    import numpy as np

    from ray_tpu_torch.serve.llm import SamplingParams

    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, vocab_size, n).tolist()
               for n in STRUCTURED_LENGTHS]
    nucleus = dict(temperature=0.8, top_p=0.9, seed=7)
    kws = [{}, dict(nucleus), {}, {}, {}, dict(nucleus, seed=9), {}, {}]
    if constrained:
        kws[0]["structured"] = kws[1]["structured"] = "json"
        kws[2]["structured"] = {"type": "json_schema", "schema": SPEC_SCHEMA}
        kws[3]["stop"] = (stop,)
    return prompts, [SamplingParams(max_new_tokens=STRUCTURED_NEW_TOKENS, **kw)
                     for kw in kws]


def structured_phase(torch, card) -> None:
    """The structured wave on Llama-125M bf16, spec off and on: the batch
    unconstrained, then with rows 0-3 constrained. Each constrained stream
    is a grammar-valid prefix (a host FSMCursor never rejects; a stream
    that ends early ends at must_stop), the stop row ends with its stop
    sequence (taken from the unconstrained row's own tokens) and nothing
    after, and rows 4-7 equal the unconstrained batch's byte for byte."""
    from ray_tpu_torch.benchmarks import engine_profile as ep
    from ray_tpu_torch.serve.llm import structured

    for spec in (False, True):
        torch.cuda.empty_cache()
        eng = spec_engine(None, spec)
        tag = f"structured[llama bf16 spec {'on' if spec else 'off'}]"
        vocab = eng.model_cfg.vocab_size
        base = ep.spec_serve(torch, eng, *structured_requests(
            vocab, constrained=False))["outs"]
        stop = tuple(base[3][20:22])
        end = next(i + 2 for i in range(len(base[3]) - 1)
                   if tuple(base[3][i:i + 2]) == stop)
        prompts, params = structured_requests(vocab, stop)
        ep.spec_serve(torch, eng, prompts, params)  # masked graphs captured
        t0 = time.perf_counter()
        run = ep.spec_serve(torch, eng, prompts, params)
        seconds = time.perf_counter() - t0
        outs = run["outs"]
        for row in range(3):
            sp = params[row]
            dfa = structured.compile_grammar(
                structured.parse_response_format(sp.structured), vocab,
                eng.cfg.eos_id)
            cur = structured.FSMCursor(dfa)
            for t in outs[row]:
                if not cur.advance(t):
                    raise AssertionError(f"{tag}: row {row} token {t} "
                                         f"rejected: {outs[row]}")
            if len(outs[row]) < sp.max_new_tokens and not cur.must_stop:
                raise AssertionError(f"{tag}: row {row} ended before its "
                                     f"budget off a full match")
            log(f"{tag}: row {row} ({len(outs[row])} tokens, "
                f"{'must_stop' if cur.must_stop else 'budget'}): "
                f"{bytes(t for t in outs[row] if t < 256)!r}")
        if outs[3] != base[3][:end]:
            raise AssertionError(f"{tag}: stop row {outs[3]} != "
                                 f"{base[3][:end]} (stop {stop})")
        if outs[4:] != base[4:]:
            raise AssertionError(f"{tag}: unconstrained rows changed")
        masked = sorted(s for s in eng.fns.signatures if s[-1] is True)
        st = eng.stats()
        log(f"{tag}: stop row ends at {end} tokens with {stop}; rows 4-7 "
            f"equal the unconstrained batch's; {sum(map(len, outs))} tokens "
            f"in {seconds:.3f} s; masked signatures {masked}; spec_steps "
            f"{st['spec_steps']}, grammar_cache {st['grammar_cache']}; {card}")
        pool_whole(eng, tag)
        del eng


# ---------------------------------------------------------- priority phase

PRIORITY_COUNTS = ("preemptions_total", "kv_demoted_blocks",
                   "kv_promoted_blocks", "prefix_evicted_blocks",
                   "prefix_hit_tokens", "prefill_tokens_total")
# a bf16 greedy row diverging at a larger top-2 logit gap is a fault; a
# bf16 sampled token whose draw lies further outside its CDF interval, in
# probability mass (``draw_slip``), is one too
GAP_FAULT = 0.05
# at f32 a greedy row must not diverge at all, and a sampled token's draw
# may lie only this far outside its interval: the f32 logits of one row
# move about 4e-6 with the batch around it (``batch_dependence``; B4's
# split count follows the batch's table width), which reorders near-tied
# tokens in the sort and so moves an interval by a neighbour's mass or
# two (about 3e-5 each with random weights), while a wrong key or
# position puts the draw a random distance (most of the mass) away
DRAW_NOISE = 1e-4


def rehearsal_config(torch):
    """Llama at tiny widths but the full model's vocabulary and sequence
    length (so the workload's prompts and lengths are the card's), f32:
    the scheduling does not depend on the width."""
    from ray_tpu_torch.models.families import family
    from ray_tpu_torch.models.llama import LlamaConfig

    full = family("llama").full()
    return dataclasses.replace(LlamaConfig.tiny(vocab_size=full.vocab_size),
                               max_seq_len=full.max_seq_len,
                               dtype=torch.float32)


class ParkClock:
    """Time, on the host clock, each park (``_preempt_one_locked`` that
    parked a stream) and each resume (the ``_maybe_resume_locked`` call
    that re-admitted it, plus the prefill call that recomputed its tail
    and sampled its next token) of ``engine``, and count the demote
    exports (one device-to-host sync each, ``_metered_export`` kind
    "demote"). ``parks`` holds (request id, tokens generated, decode
    steps into the pass, ms); ``resumes`` (request id, admit ms, prefill ms).
    """

    def __init__(self, engine):
        self.engine, self.parks, self.resumes = engine, [], []
        self.demote_syncs = 0
        self._admit_ms = {}
        self._d0 = engine.num_decode_steps

    def __enter__(self):
        eng = self.engine
        park, resume = eng._preempt_one_locked, eng._maybe_resume_locked
        prefill, demote = eng._prefill_chunk_locked, eng.cache.demote_fn

        def timed_park(r, now):
            t0 = time.perf_counter()
            ok = park(r, now)
            if ok:
                self.parks.append((r.id, len(r.generated),
                                   eng.num_decode_steps - self._d0,
                                   1e3 * (time.perf_counter() - t0)))
            return ok

        def timed_resume():
            parked = list(eng._preempted)
            t0 = time.perf_counter()
            resume()
            ms = 1e3 * (time.perf_counter() - t0)
            for r in parked:
                if r not in eng._preempted:
                    self._admit_ms[r.id] = ms

        def timed_prefill():
            rows = [r for r in eng._prefilling[:eng.cfg.max_prefill_batch]
                    if r.pending_resume is not None]
            t0 = time.perf_counter()
            prefill()
            ms = 1e3 * (time.perf_counter() - t0)
            for r in rows:
                if r.pending_resume is None:  # its chain is resident again
                    self.resumes.append((r.id, self._admit_ms.pop(r.id),
                                         ms))

        def counted(ids):
            self.demote_syncs += 1
            return demote(ids)

        eng._preempt_one_locked = timed_park
        eng._maybe_resume_locked = timed_resume
        eng._prefill_chunk_locked = timed_prefill
        eng.cache.demote_fn = counted
        self._demote = demote
        return self

    def __exit__(self, *exc):
        for name in ("_preempt_one_locked", "_maybe_resume_locked",
                     "_prefill_chunk_locked"):
            delattr(self.engine, name)
        self.engine.cache.demote_fn = self._demote


def priority_pass(torch, engine, work) -> dict:
    """One pass of ``engine_profile.priority_serve`` under a ParkClock:
    the run, the engine's PRIORITY_COUNTS moves, its prefill calls and
    decode steps, the parks, resumes and demote syncs, and the decode
    graphs captured during the pass by kind."""
    from ray_tpu_torch.benchmarks import engine_profile as ep

    st0, fns = engine.stats(), engine.fns
    calls0 = (engine.num_prefill_calls, engine.num_decode_steps)
    graphs0 = fns.graphs_by_kind()
    with ParkClock(engine) as clock:
        run = ep.priority_serve(torch, engine, work)
    st = engine.stats()
    run["counts"] = {k: st[k] - st0[k] for k in PRIORITY_COUNTS}
    run["counts"]["prefill_calls"] = engine.num_prefill_calls - calls0[0]
    run["counts"]["decode_steps"] = engine.num_decode_steps - calls0[1]
    # parks and resumes by the request's place in the pass
    where = {rid: i for i, rid in enumerate(run["ids"])}
    run["parks"] = [(where[rid], *rest) for rid, *rest in clock.parks]
    run["resumes"] = [(where[rid], *rest) for rid, *rest in clock.resumes]
    run["counts"]["parked"] = [i for i, *_ in run["parks"]]
    run["demote_syncs"] = clock.demote_syncs
    now = fns.graphs_by_kind()
    run["new_graphs"] = {k: now[k] - graphs0.get(k, 0) for k in now}
    run["preempted"] = st["preempted"]
    return run


def priority_checks(engine, run, work, tag) -> None:
    """Every stream at its budget, nothing parked at the end, every parked
    stream resumed, the pool whole (no block held, reserved or
    quarantined; every block free after ``release_all``, which also
    empties the host tier: the next pass starts cold)."""
    params = work["batch"][1] + [s for _, _, ss in work["bursts"]
                                 for s in ss]
    for o, sp in zip(run["outs"], params):
        if len(o) != sp.max_new_tokens:
            raise AssertionError(f"{tag}: a stream of {len(o)} tokens, "
                                 f"budget {sp.max_new_tokens}")
    resumed = sorted(rid for rid, *_ in run["resumes"])
    if run["preempted"] or sorted(run["counts"]["parked"]) != resumed:
        raise AssertionError(f"{tag}: parked {run['counts']['parked']}, "
                             f"resumed {resumed}, {run['preempted']} left")
    c = engine.cache
    snap = c.debug_snapshot()
    if (c.used_blocks or c.reserved_blocks or snap["live_sequences"]
            or snap["quarantined_blocks"]):
        raise AssertionError(f"{tag}: pool not whole: {snap}")
    c.release_all()
    if (c.free_blocks != c.cfg.usable_blocks or c.cached_blocks
            or c.host_tier.blocks):
        raise AssertionError(f"{tag}: pool not whole after release_all: "
                             f"{c.debug_snapshot()}")


def percentile(xs, q) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, math.ceil(q * len(xs)) - 1))]


def priority_rehearsal(torch) -> dict:
    """``priority_workload`` on the CPU at tiny widths (``rehearsal_
    config``), preemption off and on: each engine's counts, which the
    card's runs must equal."""
    from ray_tpu_torch.benchmarks import engine_profile as ep

    cfg = rehearsal_config(torch)
    work = ep.priority_workload(cfg.vocab_size)
    out = {}
    for pre in (False, True):
        eng = ep.make_priority_engine(preemption=pre, model_config=cfg,
                                      device="cpu")
        run = priority_pass(torch, eng, work)
        priority_checks(eng, run, work, f"priority rehearsal[{pre}]")
        out[pre] = run["counts"]
    return out


def batch_dependence(torch, engine, prompts) -> float:
    """How far the first-token logits of ``prompts[0]`` move with the
    batch around it: one prefill call of it alone against one of the
    first 4 ``prompts`` (same length) into free blocks of the idle pool,
    max abs difference."""
    model, bs = engine.executor.model, engine.cache.cfg.block_size
    n = len(prompts[0])
    S = -(-n // bs) * bs
    out = []
    for B in (1, 4):
        t = torch.zeros(B, S, dtype=torch.int32, device="cuda")
        t[:, :n] = torch.tensor(prompts[:B], dtype=torch.int32)
        lengths = torch.full((B,), n, dtype=torch.int32, device="cuda")
        tables = torch.arange(1, 1 + B * (S // bs), dtype=torch.int32,
                              device="cuda").reshape(B, S // bs)
        logits, _, _ = model.prefill(engine.cache.k, engine.cache.v, t,
                                     lengths, tables)
        out.append(logits[0].float())
    return (out[0] - out[1]).abs().max().item()


def divergences(torch, engine, prompts, params, outs, tag, max_gap,
                max_slip, names=("off", "on")) -> None:
    """Print how many streams of the second run (``outs[True]``, by
    default the preemption-on engine's) equal the first's
    (``outs[False]``, ``engine``'s) and each greedy row's divergence with
    ``engine``'s top-2 logit gap there: at ``max_gap`` or more a fault. A
    sampled row is held token by token instead, in both runs' streams:
    each token's ``draw_slip`` on ``engine``'s logits after the stream so
    far, recomputed alone, must stay under ``max_slip``."""
    off, on = names
    same = sum(a == b for a, b in zip(outs[False], outs[True]))
    log(f"{tag}: {on} streams equal {off} in {same} of {len(prompts)}")
    for row, (a, b) in enumerate(zip(outs[False], outs[True])):
        sp = params[row]
        pos = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                   None)
        if sp.temperature > 0:
            slips = {pre: [draw_slip(torch, engine, prompts[row] + o[:i],
                                     sp, o[i]) for i in range(len(o))]
                     for pre, o in ((False, a), (True, b))}
            worst = {pre: max(range(len(v)), key=v.__getitem__)
                     for pre, v in slips.items()}
            log(f"{tag}: row {row} (sampled) "
                + ("equal" if pos is None else f"diverges at generated "
                   f"position {pos} ({off} {a[pos]}, {on} {b[pos]})")
                + f"; draw slips {off}/{on}: "
                + ", ".join(f"{sum(x > 0 for x in slips[pre])} tokens off "
                            f"their draw, worst {slips[pre][worst[pre]]:.4e}"
                            f" at {worst[pre]}" for pre in (False, True)))
            if any(slips[pre][worst[pre]] >= max_slip for pre in slips):
                raise AssertionError(f"{tag}: row {row} has a token whose "
                                     f"keyed draw lies outside its CDF "
                                     f"interval by {max_slip} or more")
            continue
        if pos is None:
            continue
        gap = top2_gap(torch, engine, prompts[row] + a[:pos])
        log(f"{tag}: row {row} (greedy) diverges at generated position "
            f"{pos} ({off} {a[pos]}, {on} {b[pos]}); {off} top-2 logit gap "
            f"there {gap:.4e}")
        if gap >= max_gap:
            raise AssertionError(f"{tag}: row {row} diverges at a top-2 gap "
                                 f"of {gap}")


def priority_phase(torch, card) -> dict:
    """Priority traffic (``engine_profile.priority_workload``: 4 batch
    streams of 700 prompt and 160 new tokens on a 256-block pool, then two
    bursts of 4 interactive turns of 300 and 32 tokens) on Llama-125M at
    full width and depth, preemption off and on (``engine_profile.
    PREEMPTION``, pressure-only), bf16 then f32. For each bf16 engine a
    warm-up pass, ``release_all``, a timed pass: interactive TTFT p50/p99
    (host clock, submit to first token), batch completion and tokens/s,
    parks, demotes, promotes, demote syncs, graphs by kind, each park's
    and resume's host ms; its counts must equal the CPU rehearsal's
    (``priority_rehearsal``), every stream its budget, every parked
    stream resumed, the pool whole. The preemption-on engine's counted
    pass (launch counts reset just before it, a ``torch.profiler`` trace)
    is the path "llama_preempt": B5 12 x prefill calls, B4 12 x decode
    steps. The unloaded baseline: each interactive prompt alone on the
    idle engine. bf16 divergences of greedy streams between off and on
    are printed with the off engine's top-2 logit gap (at or above
    GAP_FAULT a fault); at f32 (B4 and B5 on f32 q, TF32 off) every
    greedy stream of the on engine must equal the off engine's. The
    sampled stream, parked and resumed, is held in both dtypes token by
    token to its keyed draw (``draw_slip`` under GAP_FAULT in bf16,
    DRAW_NOISE at f32)."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.benchmarks import engine_profile as ep
    from ray_tpu_torch.ops import paged_attention as pa

    t0 = time.perf_counter()
    rehearsal = priority_rehearsal(torch)
    log(f"priority rehearsal (CPU, tiny widths, {time.perf_counter() - t0:.2f}"
        f" s): off {rehearsal[False]}; on {rehearsal[True]}")
    on = rehearsal[True]
    if (len(set(on["parked"])) < 2 or on["kv_promoted_blocks"] < 1
            or rehearsal[False]["preemptions_total"]):
        raise AssertionError(f"priority rehearsal: the workload parks "
                             f"{on['parked']}, promotes "
                             f"{on['kv_promoted_blocks']} blocks")
    result, engines, outs = {}, {}, {}
    for pre in (False, True):
        torch.cuda.empty_cache()
        tag = f"priority[llama bf16 preemption {'on' if pre else 'off'}]"
        eng = ep.make_priority_engine(preemption=pre)
        work = ep.priority_workload(eng.model_cfg.vocab_size)
        t0 = time.perf_counter()
        warm = priority_pass(torch, eng, work)
        priority_checks(eng, warm, work, tag)
        capture = {"seconds": time.perf_counter() - t0,
                   "graphs": eng.fns.graphs_by_kind(),
                   "capture_s": eng.fns.capture_seconds}
        run = priority_pass(torch, eng, work)
        priority_checks(eng, run, work, tag)
        if run["counts"] != rehearsal[pre]:
            raise AssertionError(f"{tag}: counts {run['counts']} != the "
                                 f"CPU rehearsal's {rehearsal[pre]}")
        nb = run["batch"]
        inter = run["ttft"][nb:]
        batch_s = max(run["done_s"][:nb])
        batch_tok = sum(map(len, run["outs"][:nb]))
        log(f"{tag}: interactive TTFT p50 {1e3 * percentile(inter, 0.5):.2f}"
            f" ms, p99 {1e3 * percentile(inter, 0.99):.2f} ms (host clock, "
            f"{len(inter)} requests, each {[round(1e3 * x, 2) for x in inter]})"
            f"; batch streams done in {batch_s:.3f} s, "
            f"{batch_tok / batch_s:.1f} tokens/s; pass {run['seconds']:.3f} "
            f"s; counts {run['counts']} (= the CPU rehearsal's); demote "
            f"syncs {run['demote_syncs']}; parks (request, generated, "
            f"decode step, host ms) {[(a, b, c, round(d, 3)) for a, b, c, d in run['parks']]}"
            f"; resumes (request, admit ms, prefill ms) "
            f"{[(a, round(b, 3), round(c, 3)) for a, b, c in run['resumes']]}"
            f"; graphs by kind after the warm-up pass {capture['graphs']} "
            f"(captured in {capture['capture_s']:.3f} s), new in the timed "
            f"pass {run['new_graphs']}; {card}")
        result[pre] = run
        engines[pre] = eng
        outs[pre] = run["outs"]

    # the counted pass: launches on the device from the trace
    eng = engines[True]
    tag = "priority[llama bf16 preemption on]"
    pa.reset_launches()
    mark = ring_mark(eng)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ep.anchor(prof)
        counted = priority_pass(torch, eng, work)
    eager = dict(pa.LAUNCHES)
    priority_checks(eng, counted, work, tag)
    launches = dict.fromkeys(pa.LAUNCHES, 0)
    launches.update(ep.paged_launches(prof))
    n_layer = eng.model_cfg.n_layer
    recs = ring_records(eng.debug_dump(), mark)
    log_launch_counts(tag, launches, ring_counts(recs, n_layer),
                      ep.paged_walls(prof), recs, n_layer)
    want = dict.fromkeys(launches, 0)
    want["paged_decode"] = n_layer * counted["counts"]["decode_steps"]
    want["paged_prefill"] = n_layer * counted["counts"]["prefill_calls"]
    log(f"{tag}: counted pass: {counted['counts']}; launches on the device "
        f"(trace) {launches} (expected {want}); eager wrapper launches "
        f"{eager}; new graphs {counted['new_graphs']}")
    if launches != want or counted["counts"] != rehearsal[True]:
        raise AssertionError(f"{tag}: launch counts {launches} != {want}, "
                             f"or counts {counted['counts']}")

    # the unloaded baseline: each interactive prompt alone, idle engine
    alone = []
    for _, ps, ss in work["bursts"]:
        for p, sp in zip(ps, ss):
            one = ep.priority_serve(torch, engines[False],
                                    {"batch": ([p], [sp]), "bursts": []})
            alone.append(one["ttft"][0])
            engines[False].cache.release_all()
    log(f"priority[llama bf16]: unloaded interactive TTFT p50 "
        f"{1e3 * percentile(alone, 0.5):.2f} ms, p99 "
        f"{1e3 * percentile(alone, 0.99):.2f} ms (each alone on the idle "
        f"engine, {[round(1e3 * x, 2) for x in alone]}); p99 with "
        f"preemption / unloaded "
        f"{percentile(result[True]['ttft'][nb:], 0.99) / percentile(alone, 0.99):.3f}"
        f", without {percentile(result[False]['ttft'][nb:], 0.99) / percentile(alone, 0.99):.3f}"
        f"; {card}")

    # bf16: preemption on against off, each greedy divergence with the off
    # engine's top-2 gap; the sampled row token by token to its draw
    prompts = work["batch"][0] + [p for _, ps, _ in work["bursts"]
                                  for p in ps]
    params = work["batch"][1] + [s for _, _, ss in work["bursts"]
                                 for s in ss]
    divergences(torch, engines[False], prompts, params, outs,
                "priority[llama bf16]", GAP_FAULT, GAP_FAULT)
    del engines, eng
    torch.cuda.empty_cache()

    # f32: every greedy stream of the on engine equals the off engine's,
    # every sampled token lies within DRAW_NOISE of its draw
    f32, engines = {}, {}
    for pre in (False, True):
        eng = engines[pre] = ep.make_priority_engine(preemption=pre,
                                                     dtype=torch.float32)
        run = priority_pass(torch, eng, work)
        priority_checks(eng, run, work, f"priority[llama f32 {pre}]")
        if run["counts"] != rehearsal[pre]:
            raise AssertionError(f"priority[llama f32]: counts "
                                 f"{run['counts']} != {rehearsal[pre]}")
        f32[pre] = run["outs"]
    divergences(torch, engines[False], prompts, params, f32,
                "priority[llama f32]", 0.0, DRAW_NOISE)
    log(f"priority[llama f32]: the first-token logits of a burst's turn "
        f"alone against in a batch of 4 differ by "
        f"{batch_dependence(torch, engines[False], work['bursts'][1][1]):.4e}"
        f" (max abs); {card}")
    del engines, eng
    torch.cuda.empty_cache()
    return {"launches": launches, "eager": eager}


OBS_STEP_TIMEOUT_S = 0.5  # the watchdog's ceiling in the obs phase
OBS_WEDGE_S = 2.0         # the chaos delay that wedges a decode step
OBS_FANOUT_SLACK_S = 0.25  # every stream fails within the ceiling + this
OBS_FAULT_AFTER = 10      # both faults fire at this decode step
# a Llama-125M bf16 decode step before the instrumentation (PERF.md §5):
# 4 host launch API calls (one graph replay; checked) and 683 device
# kernels and copies (printed beside: a trace may lose a record, ROADMAP
# Queue C 4); the instrumentation adds no device work
DECODE_LAUNCH_API_CALLS = 4
LLAMA_BF16_DEVICE_OPS = 683


def obs_samples() -> dict:
    """The port's ``llm_*`` metric samples now, by (sample name, labels)."""
    from ray_tpu_torch.util import metrics

    return {(smp["name"], tuple(sorted(smp["labels"].items()))): smp["value"]
            for fam in metrics.collect_families("llm_").values()
            for smp in fam["samples"]}


def obs_moved(before: dict, after: dict, name: str, **labels) -> float:
    key = (name, tuple(sorted(labels.items())))
    return after.get(key, 0.0) - before.get(key, 0.0)


def pool_is_whole(engine) -> bool:
    c = engine.cache
    return (c.available_blocks == c.cfg.usable_blocks
            and c.reserved_blocks == 0)


def obs_counted(torch, engine, prompts, params, card) -> dict:
    """The obs phase's counted pass, traced: the metric families' counters
    against ``stats()`` and the streams, the histograms' sample counts,
    the host syncs against the flight ring, the trace's paged launches
    against the ring's (the second count), goodput and serving MFU by
    kind; then the instrumentation's host time a step, and a window of
    decode steps with the launch and kernel counts of the engine before
    the instrumentation."""
    from ray_tpu_torch.benchmarks import engine_profile as ep
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.serve.llm import obs

    tag = "obs[llama bf16]"
    st0, m0, mark = engine.stats(), obs_samples(), ring_mark(engine)
    was = (engine.num_prefill_calls, engine.num_decode_steps)
    pa.reset_launches()
    prof = ep.profiled_pass(torch, engine, prompts, params)
    eager = dict(pa.LAUNCHES)
    st, m1 = engine.stats(), obs_samples()
    outs, n = prof["outs"], len(prompts)
    ntok = sum(map(len, outs))
    recs = ring_records(engine.debug_dump(), mark)
    reasons = [engine.request_timeline(i)["finish_reason"]
               for i in prof["ids"]]
    checks = {  # (metric, the count it must equal)
        "tokens": (obs_moved(m0, m1, "llm_engine_tokens_generated_total"),
                   ntok),
        "prefill tokens": (
            obs_moved(m0, m1, "llm_prefill_tokens_total"),
            st["prefill_tokens_total"] - st0["prefill_tokens_total"]),
        "finished": (obs_moved(m0, m1, "llm_requests_finished_total"),
                     reasons.count("finished")),
        "sync bytes": (
            obs_moved(m0, m1, "llm_sync_bytes_total"),
            st["host_sync_bytes_total"] - st0["host_sync_bytes_total"]),
        "host syncs": (obs_moved(m0, m1, "llm_host_sync_seconds_count"),
                       sum("sync_ms" in r for r in recs)),
        "ttft samples": (obs_moved(m0, m1, "llm_ttft_seconds_count"), n),
        "tpot samples": (
            obs_moved(m0, m1, "llm_time_per_output_token_seconds_count"),
            ntok - n),
    }
    log(f"{tag}: counted pass, {n} requests, {ntok} tokens: metric against "
        f"its count " + ", ".join(f"{k} {int(a)} / {b}"
                                 for k, (a, b) in checks.items()))
    bad = {k: v for k, v in checks.items() if v[0] != v[1]}
    if bad or reasons != ["finished"] * n:
        raise AssertionError(f"{tag}: metrics disagree with their counts "
                             f"{bad}, finish reasons {reasons}")
    traced = dict.fromkeys(pa.LAUNCHES, 0)
    traced.update(prof["paged_launches"])
    ring = ring_counts(recs, engine.model_cfg.n_layer)
    log_launch_counts(tag, traced, ring, prof["paged_walls"], recs,
                      engine.model_cfg.n_layer)
    want = dict.fromkeys(traced, 0)
    want.update(ring)
    n_layer = engine.model_cfg.n_layer
    host = {"paged_decode": n_layer * (engine.num_decode_steps - was[1]),
            "paged_prefill": n_layer * (engine.num_prefill_calls - was[0])}
    if traced != want or ring != host:
        raise AssertionError(f"{tag}: launches: trace {traced}, ring {ring}, "
                             f"engine counters {host}")

    # a timed pass: goodput over it alone (the windows hold the warm-up's
    # graph captures and the traced pass before it), and the
    # instrumentation's host time: the per-step bookkeeping (gauges,
    # counters, the latency histogram, goodput, event stats, the flight
    # record), the sync metering and the timeline appends, on obs.clock
    spent = {}
    parts = ("_step_done_locked", "_metered_sync", "_tl")

    def timed(name):
        fn = getattr(engine, name)

        def wrapper(*args, **kw):
            t0 = obs.clock()
            try:
                return fn(*args, **kw)
            finally:
                spent[name] = spent.get(name, 0.0) + obs.clock() - t0
        setattr(engine, name, wrapper)

    for name in parts:
        timed(name)
    by_kind = {}  # step kind -> [steps, instrumentation seconds]
    step = engine.step

    def counted_step():
        before = sum(spent.values())
        ran = step()
        if ran:
            k = by_kind.setdefault(engine.last_step_kind, [0, 0.0])
            k[0] += 1
            k[1] += sum(spent.values()) - before
        return ran

    engine.step = counted_step
    was = (engine.num_prefill_calls, engine.num_decode_steps)
    engine._goodput_windows.clear()
    run = ep.serve(torch, engine, prompts, params)
    for name in (*parts, "step"):
        delattr(engine, name)
    goodput = engine.stats()["goodput"]
    log(f"{tag}: goodput and serving MFU by step kind over a timed pass "
        f"(the step's host clock, lag-1 caveat; peak "
        f"{engine.executor.peak_tflops} TFLOP/s): "
        + ", ".join(f"{k} {g['tokens_per_sec']:.1f} tokens/s MFU "
                    f"{g['mfu']:.6f}" for k, g in goodput.items())
        + f"; pass {ntok / run['seconds']:.1f} tokens/s; {card}")
    steps = (engine.num_prefill_calls - was[0]) + (engine.num_decode_steps
                                                   - was[1])
    decode_ms = 1e3 * statistics.mean(run["steps"]["decode"])
    obs_ms = 1e3 * sum(spent.values()) / steps
    n_dec, s_dec = by_kind.get("decode", [0, 0.0])
    obs_decode_ms = 1e3 * s_dec / max(1, n_dec)
    log(f"{tag}: instrumentation host ms a decode step {obs_decode_ms:.4f} "
        f"({n_dec} decode steps) beside the decode step's {decode_ms:.3f} "
        f"ms on the host clock; a work step {obs_ms:.4f} ("
        + ", ".join(f"{k} {1e3 * v / steps:.4f}" for k, v in spent.items())
        + f"; {steps} steps); {card}")
    if run["outs"] != outs:
        raise AssertionError(f"{tag}: a timed pass differs from the first")

    window = ep.decode_window(torch, engine, prompts)
    log(f"{tag}: decode window of {window['steps']} steps: "
        f"{window['launch_api_calls_per_step']:g} host launch API calls and "
        f"{window['device_ops_per_step']:g} device kernels and copies a step "
        f"(before the instrumentation {DECODE_LAUNCH_API_CALLS} and "
        f"{LLAMA_BF16_DEVICE_OPS}); {window['step_ms']:.3f} ms a step")
    if window["launch_api_calls_per_step"] != DECODE_LAUNCH_API_CALLS:
        raise AssertionError(f"{tag}: the instrumentation changed a decode "
                             f"step's launches: {window}")
    return {"launches": traced, "eager": eager, "outs": outs,
            "obs_ms_per_step": obs_ms, "obs_ms_per_decode_step": obs_decode_ms,
            "goodput": goodput}


def obs_faults(torch, make_engine, prompts, params, first_outs, root,
               card) -> dict:
    """The fail-closed paths on engines of ``make_engine(**overrides)``:
    each warmed by a pass the caller steps (its graphs captured), then
    stepping on its own thread with the workload queued under its lock
    and a chaos fault at its OBS_FAULT_AFTER-th decode step. A ``raise``:
    every stream fails with ``EngineDiedError``, one ``engine_died`` dump
    (with ``stats``) lands in its dir, the pool is whole. A ``delay`` of
    OBS_WEDGE_S with ``step_timeout_s`` OBS_STEP_TIMEOUT_S: every stream
    fails within the ceiling + OBS_FANOUT_SLACK_S of the wedged step's
    start, while the stepper still holds the lock, with one
    ``watchdog_timeout`` dump of the ring and no ``stats``; woken, the
    stepper dispatches nothing more and the pool is whole. Then a fresh
    engine serves the first pass's streams. -> fan-out seconds and dump
    bytes by fault."""
    from ray_tpu_torch._private import chaos
    from ray_tpu_torch._private.chaos import Fault, FaultPlan
    from ray_tpu_torch.benchmarks import engine_profile as ep
    from ray_tpu_torch.serve.llm import EngineDiedError, obs

    out = {}
    for name, action, arg, overrides in (
            ("engine_died", "raise", None, {}),
            ("watchdog_timeout", "delay", OBS_WEDGE_S,
             {"step_timeout_s": OBS_STEP_TIMEOUT_S})):
        tag = f"obs[{name}]"
        d = os.path.join(root, name)
        engine = make_engine(flight_recorder_dir=d, **overrides)
        ep.serve(torch, engine, prompts, params)  # captures the graphs
        died = []
        fail = engine._fail_engine

        def fail_engine(e, fail=fail, died=died):
            died.append(obs.clock())
            fail(e)

        engine._fail_engine = fail_engine
        engine._auto_step = True  # from here its own thread steps it
        chaos.install(FaultPlan(faults=(Fault(
            point="engine.decode", action=action, arg=arg,
            after=OBS_FAULT_AFTER, times=1),)))
        steps0 = engine.num_decode_steps
        try:
            with engine._lock:  # every stream queued before the first step
                streams = [engine.submit(p, sp)
                           for p, sp in zip(prompts, params)]
            failed_at = []
            for st in streams:
                try:
                    list(st)
                except EngineDiedError:
                    failed_at.append(obs.clock())
            if name == "watchdog_timeout":
                begin = engine._step_begin  # the wedged step's start
                held = not engine._lock.acquire(blocking=False)
                if not held:
                    engine._lock.release()
                start = begin
            else:
                held, start = None, (died or [None])[0]
            engine._thread.join(timeout=OBS_WEDGE_S + 30)
        finally:
            chaos.clear()
        files = sorted(os.listdir(d)) if os.path.isdir(d) else []
        dump = (json.load(open(os.path.join(d, files[0])))
                if len(files) == 1 else {})
        fanout = (max(failed_at) - start if failed_at and start is not None
                  else None)
        dispatched = engine.num_decode_steps - steps0
        nbytes = os.path.getsize(os.path.join(d, files[0])) if files else 0
        log(f"{tag}: {len(failed_at)} of {len(streams)} streams failed, the "
            f"last {fanout if fanout is None else round(fanout, 4)} s after "
            f"the {'raise' if action == 'raise' else 'wedged step began'}; "
            f"{dispatched} decode steps dispatched; dump files {files} "
            f"({nbytes} bytes, reason {dump.get('reason')}, "
            f"{len(dump.get('steps', []))} ring records, stats "
            f"{'in' if 'stats' in dump else 'not in'} it); lock held by "
            f"the wedged stepper at the fan-out: {held}; pool whole "
            f"{pool_is_whole(engine)}; {card}")
        ok = (len(failed_at) == len(streams) and fanout is not None
              and len(files) == 1 and dump.get("reason") == name
              and dump.get("steps") and dispatched == OBS_FAULT_AFTER - 1
              and pool_is_whole(engine) and not engine._thread.is_alive())
        if name == "engine_died":
            ok = ok and dump.get("stats", {}).get("failed") is True
        else:
            ok = (ok and held and "stats" not in dump
                  and fanout <= OBS_STEP_TIMEOUT_S + OBS_FANOUT_SLACK_S)
        if not ok:
            raise AssertionError(f"{tag}: the fail-closed path did not hold")
        out[name] = {"fanout_s": fanout, "dump_bytes": nbytes}
        engine.shutdown()
        del engine
    fresh = make_engine()
    again = ep.serve(torch, fresh, prompts, params)["outs"]
    fresh.shutdown()
    log(f"obs[fresh]: a fresh engine after both faults gives the first "
        f"pass's streams: {again == first_outs}")
    if again != first_outs:
        raise AssertionError("a fresh engine after the faults differs")
    return out


def obs_phase(torch, card) -> dict:
    """Llama-125M bf16 on the engine phase's geometry and workload
    (``engine_profile.workload``), with a temporary flight-recorder dir: a
    warm-up pass captures the graphs, then ``obs_counted`` (the counted,
    traced pass and its checks) and ``obs_faults`` (a raise and a wedge at
    a decode step, and a fresh engine after them)."""
    import shutil
    import tempfile

    from ray_tpu_torch.benchmarks import engine_profile as ep

    def make(**overrides):
        return ep.make_engine(None, "llama", **overrides)

    root = tempfile.mkdtemp(prefix="obs_phase_")
    try:
        engine = make(flight_recorder_dir=root)
        prompts, params = ep.workload(engine.model_cfg.vocab_size)
        first = ep.serve(torch, engine, prompts, params)
        counted = obs_counted(torch, engine, prompts, params, card)
        if counted["outs"] != first["outs"]:
            raise AssertionError("obs: the counted pass differs from the "
                                 "first")
        engine.shutdown()
        del engine
        torch.cuda.empty_cache()
        counted["faults"] = obs_faults(torch, make, prompts, params,
                                       first["outs"], root, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return counted


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


# -------------------------------------------------------------------- moe

def route_flips(got, want, S, tainted=None) -> dict:
    """The routes of one MoE call through the CUDA path (``got``, one
    ``moe_route`` a layer over the call's [B * S] tokens, row-major)
    against the plain path's (``want``). A token flips at a layer where
    its set of experts differs (a set flip) or, with the same set, the
    experts it is kept by (a keep flip: its slots moved). Every flip must
    be explained:

    - a set flip is a near-tie when the plain run's gap between the two
      competing probabilities, renormalised over its top k, is below
      ROUTE_TIE; else it must be a cascade: its row flipped at an earlier
      layer at a position at or before it (the hidden state it attends to
      changed), or in an earlier call (``tainted``, rows);
    - a keep flip must follow a flip of an earlier token at the same
      layer (the slots are an exclusive cumsum in token order).

    Raises on a flip that is neither; returns the counts, the near-ties'
    gaps and the rows that flipped (added to ``tainted``)."""
    tainted = set() if tainted is None else tainted
    first = {}  # row -> [(layer, position)] of its flips
    out = {"set": 0, "keep": 0, "near_tie": [], "cascade": 0,
           "decisions": 0}
    for layer, (rg, rw) in enumerate(zip(got, want)):
        eg, ew = rg.experts, rw.experts
        out["decisions"] += eg.shape[0]
        set_diff = (eg.sort(-1).values != ew.sort(-1).values).any(-1)
        kg = rg.experts.masked_fill(~rg.keep, -1).sort(-1).values
        kw = rw.experts.masked_fill(~rw.keep, -1).sort(-1).values
        keep_diff = (kg != kw).any(-1) & ~set_diff
        flipped = (set_diff | keep_diff).nonzero().flatten().tolist()
        if not flipped:
            continue
        sets = set_diff[flipped].tolist()
        eg_h, ew_h = eg[flipped].tolist(), ew[flipped].tolist()
        probs = rw.probs[flipped].float().cpu()
        earlier = None  # first flipped token of this layer
        for i, t in enumerate(flipped):
            row, pos = divmod(t, S)
            cascade = row in tainted or any(
                l < layer and p <= pos for l, p in first.get(row, ()))
            if sets[i]:
                out["set"] += 1
                e_p = next(e for e in ew_h[i] if e not in eg_h[i])
                e_c = next(e for e in eg_h[i] if e not in ew_h[i])
                top = sum(probs[i, e].item() for e in ew_h[i])
                gap = (probs[i, e_p] - probs[i, e_c]).item() / top
                if gap < ROUTE_TIE:
                    out["near_tie"].append((layer, row, pos, gap))
                elif cascade:
                    out["cascade"] += 1
                else:
                    raise AssertionError(
                        f"route flip at layer {layer}, row {row}, position "
                        f"{pos}: plain {ew_h[i]} vs cuda {eg_h[i]}, gap "
                        f"{gap:.4f} >= ROUTE_TIE {ROUTE_TIE}, no earlier "
                        f"flip in its row")
            else:
                out["keep"] += 1
                if earlier is None:
                    raise AssertionError(
                        f"keep flip at layer {layer}, token {t} with no "
                        f"earlier flip at that layer")
                out["cascade"] += 1
            if earlier is None:
                earlier = t
            first.setdefault(row, []).append((layer, pos))
    out["rows"] = set(first)
    tainted |= out["rows"]
    return out


def log_flips(tag, flips) -> None:
    gaps = [g for *_, g in flips["near_tie"]]
    log(f"{tag}: routes cuda vs plain over {flips['decisions']} (token, "
        f"layer) decisions: {flips['set']} set flips, {flips['keep']} keep "
        f"flips; {len(gaps)} near-ties (plain gap < ROUTE_TIE {ROUTE_TIE}; "
        f"max gap {max(gaps, default=0.0):.3e}), {flips['cascade']} "
        f"cascades; rows flipped {sorted(flips['rows'])}; near-ties "
        f"(layer, row, position, gap) "
        f"{[(l, r, p, round(g, 5)) for l, r, p, g in flips['near_tie'][:12]]}")


def moe_backends_phase(torch, engine) -> dict:
    """Llama-125M-MoE through the CUDA kernels and through the plain
    backend on the same weights and inputs: one fresh prefill of 32 rows
    of 4 tokens (no padding row or column: the two backends attend
    differently on padding columns, by the reference's design), then
    decode steps fed the plain backend's greedy tokens. The routes are
    compared first (``route_flips``); on every row whose routes agree at
    every layer of every call so far, the logits are within LOGIT_TOL.
    Short rows: about 1.5% of the (token, layer) decisions flip at a
    near-tie on an H100 (at 8 rows of 32 tokens every row flipped), so a
    row of 4 tokens agrees at all 12 layers about half the time."""
    import numpy as np

    from ray_tpu_torch.models.families import kv_heads
    from ray_tpu_torch.serve.llm.kv_cache import KVCacheConfig, PagedKVCache

    base = engine.executor.model
    cfg = base.cfg
    B, S, bs, steps = 32, 4, 16, 4
    nb = (S + steps + bs - 1) // bs + 1
    rng = np.random.default_rng(3)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                             dtype=torch.int32, device="cuda")
    lengths = torch.full((B,), S, dtype=torch.int32, device="cuda")
    tables = torch.arange(1, B * nb + 1, dtype=torch.int32,
                          device="cuda").reshape(B, nb)
    logits, routes, fed = {}, {}, []
    for backend in ("torch", "cuda"):  # the plain backend picks the tokens
        m = type(base)(dataclasses.replace(cfg, attention_backend=backend),
                       base.device)
        m.load_weights(base.weights())
        cache = PagedKVCache(KVCacheConfig(
            n_layer=cfg.n_layer, n_kv_head=kv_heads(cfg),
            head_dim=cfg.head_dim, num_blocks=B * nb + 1, block_size=bs,
            dtype=cfg.dtype, device="cuda", quantization=cfg.quantization))
        calls = []
        m.route_log = []
        out, _, _ = m.prefill(cache.k, cache.v, tokens, lengths, tables)
        seq, pos = [out], lengths.clone()
        calls.append((S, m.route_log))
        for i in range(steps):
            if backend == "torch":
                fed.append(out.argmax(-1).to(torch.int32))
            m.route_log = []
            out, _, _ = m.decode_step(cache.k, cache.v, fed[i], pos, tables)
            calls.append((1, m.route_log))
            seq.append(out)
            pos = pos + 1
        logits[backend], routes[backend] = torch.stack(seq), calls
        del m, cache
    tag = f"moe backends [{cfg.quantization or 'bf16'}]"
    if not torch.isfinite(logits["cuda"]).all():
        raise AssertionError("non-finite logits from the CUDA path")
    tainted, agree, diffs = set(), 0, []
    total = {"set": 0, "keep": 0, "near_tie": [], "cascade": 0,
             "decisions": 0}
    for call, ((width, got), (_, want)) in enumerate(
            zip(routes["cuda"], routes["torch"])):
        flips = route_flips(got, want, width, tainted)
        for k in ("set", "keep", "cascade", "decisions"):
            total[k] += flips[k]
        total["near_tie"] += [(call, *f) for f in flips["near_tie"]]
        for row in range(B):
            if row in tainted:
                continue
            agree += 1
            diffs.append((logits["cuda"][call, row]
                          - logits["torch"][call, row]).abs().max().item())
    gaps = [f[-1] for f in total["near_tie"]]
    diff = max(diffs, default=float("nan"))
    log(f"{tag}: {B} rows x ({S}-token prefill + {steps} decode steps): "
        f"{total['decisions']} (token, layer) decisions, {total['set']} set "
        f"flips, {total['keep']} keep flips, {len(gaps)} near-ties (max "
        f"plain gap {max(gaps, default=0.0):.3e}, ROUTE_TIE {ROUTE_TIE}), "
        f"{total['cascade']} cascades; near-ties (call, layer, row, "
        f"position, gap) {[(c, l, r, p, round(g, 5)) for c, l, r, p, g in total['near_tie'][:12]]}; "
        f"rows flipped {sorted(tainted)}; logits on {agree} agreeing (row, "
        f"call) pairs: max_abs_diff {diff:.3e} (tol {LOGIT_TOL})")
    if not agree:
        raise AssertionError(f"{tag}: no row agreed at every layer")
    if not diff <= LOGIT_TOL:
        raise AssertionError(f"{tag}: logits differ by {diff} on rows whose "
                             f"routes agree")
    return {"flips": total["set"] + total["keep"], "gaps": gaps,
            "agreeing": agree, "logit_diff": diff}


def moe_phase(torch, card, profile=False) -> dict:
    """Llama-125M-MoE (``families.llama_125m_moe``) on the card: (a) its
    training phase (``train_phase``: B1-B3 launching 12 layers x steps,
    the loss falling; MFU by active parameters); (b) is the gradient check
    of ``train_backends_phase`` at the end of the run; (c) the engine
    phase in bf16 and int8 (``engine_phase``: streams equal pass to pass,
    every decode step of the second pass a graph replay, B4/B5 launches
    12 x calls by trace and by flight ring, a graph replay against the
    eager step with equal routes) with 4 host launch API calls a decode
    step and the weights' bytes split into experts and quantized leaves
    (the quantized ones at most BYTES_RATIO_MAX of bf16's, the experts'
    equal); (d) the CUDA path against the plain one by the route rule
    (``moe_backends_phase``). ``profile`` adds a profiled train step and
    a profiled warm pass of the bf16 engine."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    train = train_phase(torch, MOE, card)
    if profile:
        profile_train(torch, MOE)
    launches, eager, nbytes, backends = {}, {}, {}, {}
    for kind in (None, "int8"):
        torch.cuda.empty_cache()
        eng = engine_phase(torch, kind, MOE)
        tag = f"engine[{MOE} {kind or 'bf16'}]"
        suffix = f"_{kind}" if kind else ""
        for base in ("paged_decode", "paged_prefill"):
            launches[base + suffix] = eng["launches"][base + suffix]
            eager[base + suffix] = eng["eager"][base + suffix]
        if eng["ring"] != {k: eng["launches"][k] for k in eng["ring"]}:
            raise AssertionError(f"{tag}: trace {eng['launches']} != flight "
                                 f"ring {eng['ring']}")
        calls = eng["window"]["launch_api_calls_per_step"]
        if calls != DECODE_LAUNCH_API_CALLS:
            raise AssertionError(f"{tag}: {calls} host launch API calls a "
                                 f"decode step")
        nbytes[kind] = dict(moe_weight_bytes(eng["engine"].executor.model),
                            pool=eng["bytes"]["pool"])
        log(f"{tag}: {eng['tokens_per_s']:.1f} tokens/s, decode step "
            f"{eng['decode_ms']:.3f} ms, prefill {eng['prefill_ms']:.2f} ms,"
            f" {eng['window']['device_ops_per_step']:g} device kernels and "
            f"{calls:g} host launch API calls a decode step, "
            f"{eng['window']['device_busy_ms_per_step']:.3f} ms device busy "
            f"a decode step; weight and pool bytes {nbytes[kind]} on {card}")
        backends[kind] = moe_backends_phase(torch, eng["engine"])
        if profile and kind is None:
            profile_phase(torch, eng)
        del eng
    ratio = {n: nbytes["int8"][n] / nbytes[None][n]
             for n in ("quantizable", "pool")}
    log(f"engine[{MOE} int8] bytes / bf16 engine's: quantized leaves "
        f"{ratio['quantizable']:.4f}, pool {ratio['pool']:.4f} (max "
        f"{BYTES_RATIO_MAX}); experts {nbytes['int8']['experts']} vs "
        f"{nbytes[None]['experts']}")
    if max(ratio.values()) > BYTES_RATIO_MAX:
        raise AssertionError(f"{MOE} int8 bytes not halved: {ratio}")
    if nbytes["int8"]["experts"] != nbytes[None]["experts"]:
        raise AssertionError(f"{MOE} int8 experts' bytes differ from bf16's")
    torch.cuda.empty_cache()
    log(f"moe phase: {time.perf_counter() - t0:.1f} s")
    return {"train": train, "launches": launches, "eager": eager,
            "backends": backends}


# ------------------------------------------------------------------ core

CORE_ROUND_TRIPS = 200  # no-op task and actor-call round trips timed
CORE_STORE_BYTES = 1 << 30


class CoreEngine:
    """The core phase's engine, in a ``num_gpus=1`` actor: Llama-125M bf16
    (``engine_profile.make_engine``'s geometry) on the actor's ``cuda:0``,
    built from weights the driver carried through the object store. This
    file runs as ``__main__``, so the class travels to the worker by value
    (``_private/serialization.py``). ``weights`` is ``[ObjectRef]``: nested,
    so the worker leaves it unread until ``__init__`` times the read."""

    def __init__(self, weights, submitted_at):
        start = time.time()
        self.start_s = {"spawn": start - submitted_at}
        import torch

        self.start_s["import_torch"] = time.time() - start
        import ray_tpu_torch as rt
        from ray_tpu_torch.benchmarks import engine_profile as ep

        t = time.time()
        params = rt.get(weights[0], timeout=120)
        self.start_s["get_weights"] = time.time() - t
        t = time.time()
        self.engine = ep.make_engine(None, "llama", params=params)
        torch.cuda.synchronize()
        self.start_s["engine_build"] = time.time() - t

    def device(self) -> dict:
        import os

        import torch

        return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "count": torch.cuda.device_count(),
                "name": torch.cuda.get_device_name(0),
                "engine": str(self.engine.device)}

    def warm(self, prompts, params) -> dict:
        """The first pass over the requests: it captures the decode graphs
        (their seconds are the last part of the actor's start)."""
        import torch
        from ray_tpu_torch.benchmarks import engine_profile as ep

        run = ep.serve(torch, self.engine, prompts, params)
        fns = self.engine.fns
        self.start_s["graph_capture"] = fns.capture_seconds
        return {"outs": run["outs"], "seconds": run["seconds"],
                "graphs": fns.graphs_captured, "start_s": dict(self.start_s)}

    def timed(self, prompts, params) -> dict:
        import torch
        from ray_tpu_torch.benchmarks import engine_profile as ep

        run = ep.serve(torch, self.engine, prompts, params)
        return {"outs": run["outs"], "seconds": run["seconds"]}

    def counted(self, prompts, params) -> dict:
        """A pass under the profiler of this process, the wrappers' counts
        reset just before it: the paged launches of its trace, the
        wrappers' eager launches, the engine's calls and graph replays,
        and its flight ring's count (``ring_counts``)."""
        import torch
        from ray_tpu_torch.benchmarks import engine_profile as ep
        from ray_tpu_torch.ops import paged_attention as pa

        eng = self.engine
        pa.reset_launches()
        mark = ring_mark(eng)
        was = (eng.num_prefill_calls, eng.num_decode_steps, eng.fns.replays)
        prof = ep.profiled_pass(torch, eng, prompts, params)
        recs = ring_records(eng.debug_dump(), mark)
        return {"outs": prof["outs"], "trace": prof["paged_launches"],
                "walls": prof["paged_walls"], "recs": recs,
                "eager": dict(pa.LAUNCHES),
                "ring": ring_counts(recs, eng.model_cfg.n_layer),
                "prefill_calls": eng.num_prefill_calls - was[0],
                "decode_steps": eng.num_decode_steps - was[1],
                "replays": eng.fns.replays - was[2],
                "idle_share": prof["idle_share"],
                "n_layer": eng.model_cfg.n_layer}

    def ping(self):
        return None

    def pid(self) -> int:
        import os

        return os.getpid()


def pid_alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def round_trips(rt, make_ref) -> list:
    """Milliseconds of ``CORE_ROUND_TRIPS`` submit-and-get round trips."""
    rt.get(make_ref(), timeout=60)  # a warm worker
    out = []
    for _ in range(CORE_ROUND_TRIPS):
        t = time.perf_counter()
        rt.get(make_ref(), timeout=60)
        out.append(1e3 * (time.perf_counter() - t))
    return out


def core_phase(torch, card) -> dict:
    """The distributed core on the card: ``ray_tpu_torch.init`` must
    autodetect ``GPU: 1``; a ``num_gpus=1`` task must see
    ``CUDA_VISIBLE_DEVICES`` "0", one device and this card; Llama-125M's
    bf16 weights (seed of the engine phases) go through the object store
    as CPU tensors; a ``num_gpus=1`` actor builds ``LLMEngine`` on its
    ``cuda:0`` from them and serves the engine workload, whose streams
    must equal this process's in-process engine's on the same weights,
    and whose counted pass (profiled in the actor) must launch B4 12 times
    a decode step and B5 12 times a prefill call, by its trace and by
    its flight ring. After ``kill`` the actor's worker must be gone, after
    ``shutdown`` the store and its workers, and no segment of that store
    (``rtt_store_<pid>_``) may remain. Prints round trips, put/get rates, the actor's
    start seconds and tokens/s, each beside the card line."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.benchmarks import engine_profile as ep
    from ray_tpu_torch.models.families import family

    t0 = time.perf_counter()
    torch.cuda.empty_cache()  # the actor's engine gets the card's memory
    node = rt.init(num_cpus=4, object_store_memory=CORE_STORE_BYTES)
    res = rt.cluster_resources()
    log(f"core: init {time.perf_counter() - t0:.2f} s (with the g++ build of "
        f"the store and scheduler where not built yet); node resources {res}")
    if res.get("GPU") != 1.0:
        raise AssertionError(f"autodetected GPU {res.get('GPU')}, expected 1")
    name = torch.cuda.get_device_name(0)

    @rt.remote(num_gpus=1)
    def gpu_task():
        import os

        import torch

        return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                torch.cuda.device_count(), torch.cuda.get_device_name(0))

    seen = tuple(rt.get(gpu_task.remote(), timeout=120))
    log(f"core: a num_gpus=1 task saw CUDA_VISIBLE_DEVICES, device count, "
        f"name = {seen}")
    if seen != ("0", 1, name):
        raise AssertionError(f"num_gpus=1 task saw {seen}, expected "
                             f"('0', 1, {name!r})")

    @rt.remote
    def noop():
        return None

    task_ms = round_trips(rt, noop.remote)
    log(f"core: no-op task round trip p50 {percentile(task_ms, 0.5):.3f} ms,"
        f" p99 {percentile(task_ms, 0.99):.3f} ms ({CORE_ROUND_TRIPS} "
        f"trips) on {card}")

    cfg = family("llama").full()
    model = family("llama").init(cfg, ep.ENGINE["seed"],
                                 torch.device("cuda", 0))
    weights = {k: v.detach().cpu() for k, v in model.weights().items()}
    del model
    torch.cuda.empty_cache()
    nbytes = sum(v.numel() * v.element_size() for v in weights.values())
    t = time.perf_counter()
    ref = rt.put(weights)
    put_s = time.perf_counter() - t
    t = time.perf_counter()
    back = rt.get(ref, timeout=60)
    get_s = time.perf_counter() - t
    if set(back) != set(weights) or not all(
            back[k].dtype == v.dtype and torch.equal(back[k], v)
            for k, v in weights.items()):
        raise AssertionError("the weights read back from the store differ")
    del back
    log(f"core: Llama-125M bf16 weights, {len(weights)} tensors, {nbytes} B:"
        f" put {put_s * 1e3:.1f} ms = {nbytes / put_s / 1e9:.2f} GB/s, get "
        f"(zero-copy views onto the store's mapping) {get_s * 1e3:.1f} ms = "
        f"{nbytes / get_s / 1e9:.2f} GB/s on {card}")

    prompts, params = ep.workload(cfg.vocab_size)
    t = time.time()
    actor = rt.remote(num_gpus=1)(CoreEngine).remote([ref], t)
    warm = rt.get(actor.warm.remote(prompts, params), timeout=600)
    dev = rt.get(actor.device.remote(), timeout=60)
    log(f"core: the actor's device {dev}; start "
        f"{ {k: round(v, 3) for k, v in warm['start_s'].items()} } s "
        f"(spawn = its submit to __init__; {warm['graphs']} decode graphs) "
        f"on {card}")
    if (dev["visible"], dev["count"], dev["name"], dev["engine"]) != (
            "0", 1, name, "cuda:0"):
        raise AssertionError(f"the actor's device {dev}")
    t = time.perf_counter()
    timed = rt.get(actor.timed.remote(prompts, params), timeout=600)
    timed_wall = time.perf_counter() - t
    counted = rt.get(actor.counted.remote(prompts, params), timeout=600)
    actor_ms = round_trips(rt, actor.ping.remote)
    log(f"core: actor call round trip p50 {percentile(actor_ms, 0.5):.3f} "
        f"ms, p99 {percentile(actor_ms, 0.99):.3f} ms ({CORE_ROUND_TRIPS} "
        f"trips) on {card}")

    n_layer = counted["n_layer"]
    want = {"paged_decode": n_layer * counted["decode_steps"],
            "paged_prefill": n_layer * counted["prefill_calls"]}
    trace = {k: counted["trace"].get(k, 0) for k in want}
    others = {k: n for k, n in counted["trace"].items() if k not in want}
    log_launch_counts("core[actor llama bf16]", trace, counted["ring"],
                      counted["walls"], counted["recs"], n_layer)
    log(f"core: the actor's counted pass: {counted['prefill_calls']} prefill "
        f"calls, {counted['decode_steps']} decode steps "
        f"({counted['replays']} from graphs); B4/B5 launches, trace {trace},"
        f" ring {counted['ring']} (expected {want}); eager "
        f"{counted['eager']}; idle share {counted['idle_share']:.3f}")
    if (trace != want or counted["ring"] != want or any(others.values())
            or counted["replays"] != counted["decode_steps"]
            or min(counted["prefill_calls"], counted["decode_steps"]) == 0):
        raise AssertionError(f"the actor's launches {counted['trace']} / "
                             f"ring {counted['ring']} != {want}")
    if counted["eager"].get("paged_prefill") != want["paged_prefill"] or \
            counted["eager"].get("paged_decode"):
        raise AssertionError(f"the actor's eager launches {counted['eager']}")

    # the same workload on the same weights in this process
    engine = ep.make_engine(None, "llama", params=weights)
    local_warm = ep.serve(torch, engine, prompts, params)
    local = ep.serve(torch, engine, prompts, params)
    for tag, outs in (("warm", warm["outs"]), ("timed", timed["outs"]),
                      ("counted", counted["outs"]),
                      ("in-process second pass", local["outs"])):
        if outs != local_warm["outs"]:
            raise AssertionError(f"core: the actor's {tag} streams differ "
                                 f"from the in-process engine's")
    ntok = sum(map(len, local["outs"]))
    if ntok != len(prompts) * ep.NEW_TOKENS:
        raise AssertionError(f"core: {ntok} tokens")
    log(f"core: streams equal: the actor's 3 passes and the in-process "
        f"engine's 2 ({len(prompts)} requests, {ntok} tokens a pass); "
        f"tokens/s in the actor {ntok / timed['seconds']:.1f} (through the "
        f"call {ntok / timed_wall:.1f}), in-process "
        f"{ntok / local['seconds']:.1f} on {card}")
    del engine

    pid = rt.get(actor.pid.remote(), timeout=60)
    rt.kill(actor)
    deadline = time.monotonic() + 30
    while pid_alive(pid) and time.monotonic() < deadline:
        time.sleep(0.05)
    if pid_alive(pid):
        raise AssertionError(f"the killed actor's worker {pid} is alive")
    # this run's store and workers only: another checkout's cluster on
    # the same machine is none of this run's business
    store_pid = node.store_proc.pid
    worker_pids = [w.proc.pid for w in node.raylet._all_workers.values()
                   if w.proc is not None]
    rt.shutdown()
    left = {"store": pid_alive(store_pid),
            "workers": [p for p in worker_pids if pid_alive(p)],
            "segments": [n for n in os.listdir("/dev/shm")
                         if n.startswith(f"rtt_store_{store_pid}_")]}
    log(f"core: after kill the actor's worker {pid} is gone; after "
        f"shutdown: {left}")
    if left["store"] or left["workers"] or left["segments"]:
        raise AssertionError(f"left after shutdown: {left}")
    torch.cuda.empty_cache()
    log(f"core phase: {time.perf_counter() - t0:.1f} s")
    return {"launches": counted["ring"], "eager": counted["eager"],
            "task_ms": task_ms, "actor_ms": actor_ms}


# ----------------------------------------------------------------- serve

SERVE_SLOW_S = 0.05    # the chaos delay after each chunk of a "slow" request
SERVE_KILL_AFTER = 8   # tokens of each stream before its replica is killed
SERVE_BURST = 12       # the overload burst, against max_waiting below
SERVE_MAX_WAITING = 4
SERVE_CLASSES = ("interactive", "default", "batch")


def proc_start_wall() -> float:
    """This process's start on the wall clock (``/proc``, 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")


def serve_replica_class():
    """The serve phase's deployment class: ``LLMDeployment``'s own, which
    ``build_llm_app`` binds, with what only the phase needs added: the
    replica's process start on the wall clock and where it serves, and a
    ``torch.profiler`` trace of a window taken inside the replica's
    process, started and stopped on a thread of its own while the engine
    is idle. Every method of ``LLMDeployment`` is inherited, so the
    replica's hooks are the deployment's. Defined in a function, so the
    class travels to the worker by value."""
    from ray_tpu_torch.serve.llm.api import LLMDeployment

    class ServeReplica(LLMDeployment.func_or_class):
        def __init__(self, *args, **kwargs):
            self.walls = {"init": time.time(), "proc_start": proc_start_wall()}
            super().__init__(*args, **kwargs)

        def where(self) -> dict:
            return dict(walls=self.walls, pid=os.getpid(),
                        visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
                        device=str(self.engine.device),
                        backend=self.engine.model_cfg.attention_backend)

        def _counts(self) -> dict:
            e = self.engine
            return {"prefill_calls": e.num_prefill_calls,
                    "decode_steps": e.num_decode_steps,
                    "replays": e.fns.replays, "graphs": e.fns.graphs_captured}

        def trace_start(self) -> dict:
            import threading

            from ray_tpu_torch.ops import paged_attention as pa

            started, self._stop = threading.Event(), threading.Event()
            self._trace = {}

            def run():
                from torch.profiler import ProfilerActivity, profile

                from ray_tpu_torch.benchmarks import engine_profile as ep

                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    ep.anchor(prof)
                    started.set()
                    self._stop.wait()
                self._trace = {"launches": ep.paged_launches(prof),
                               "walls": ep.paged_walls(prof)}

            pa.reset_launches()
            was = self._counts()
            self._thread = threading.Thread(target=run, daemon=True,
                                            name="serve-phase-trace")
            self._thread.start()
            if not started.wait(120):
                raise RuntimeError("the profiler did not start")
            return was

        def trace_stop(self) -> dict:
            from ray_tpu_torch.ops import paged_attention as pa

            counts, eager = self._counts(), dict(pa.LAUNCHES)
            self._stop.set()
            self._thread.join(300)
            return dict(self._trace, counts=counts, eager=eager,
                        n_layer=self.engine.model_cfg.n_layer)

    return ServeReplica


class ChunkSource:
    """A generator deployment that yields chunks shaped as
    ``LLMDeployment``'s as fast as it can, no engine behind it: the
    Serve path's own rate for streamed chunks."""

    def __call__(self, payload):
        for i in range(payload["n"]):
            yield {"request_id": payload["request_id"], "token": i,
                   "index": i, "text": ""}


def chunk_rates(serve, streams=(1, 8), n_chunks=256, repeats=3) -> dict:
    """Chunks a second that 1 and 8 concurrent streams of ``ChunkSource``
    deliver through the handle, ``n_chunks`` in all, one reading a
    repeat."""
    import threading

    handle = serve.run(serve.deployment(ChunkSource).options(
        ray_actor_options={"num_cpus": 0.5}).bind(), name="chunks",
        timeout_s=120)
    list(handle.remote({"n": 4, "request_id": "warm"}))
    rates = {n: [] for n in streams}
    for _ in range(repeats):
        for n in streams:
            t0 = time.perf_counter()
            threads = [threading.Thread(target=lambda i=i: list(
                handle.remote({"n": n_chunks // n, "request_id": str(i)})))
                for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(300)
            rates[n].append(n_chunks / (time.perf_counter() - t0))
    serve.delete("chunks")
    return rates


def serve_app(rt, cfg, weights_ref, **options):
    """``build_llm_app`` of ``cfg`` (as a dict of its fields) on the stored
    weights, one ``num_gpus=1`` replica, its class subclassed by
    ``serve_replica_class`` (same name, config and bound arguments)."""
    from ray_tpu_torch.serve import Application, Deployment
    from ray_tpu_torch.serve.llm import build_llm_app

    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    app = build_llm_app(fields, params=weights_ref, num_replicas=1,
                        ray_actor_options={"num_gpus": 1}, **options)
    dep = Deployment(serve_replica_class(), app.deployment.name,
                     app.deployment.config)
    return Application(dep, app.args, app.kwargs)


def serve_payloads(prompts, params, tag=None) -> list:
    out = []
    for p, sp in zip(prompts, params):
        out.append({"prompt": list(p), "max_new_tokens": sp.max_new_tokens,
                    "temperature": sp.temperature, "top_k": sp.top_k,
                    "top_p": sp.top_p, "seed": sp.seed})
        if tag:
            out[-1]["chaos_tag"] = tag
    return out


def handle_wave(handle, payloads, on_chunk=None) -> dict:
    """Every payload through ``stream_tokens`` at once, a thread each:
    tokens, chunk indices, TTFT, serving replicas and each chunk's
    (arrival, replica) per stream, and the wave's seconds."""
    import threading

    from ray_tpu_torch.serve.llm import stream_tokens

    out = [None] * len(payloads)
    errors = []
    t0 = time.perf_counter()

    def run(i):
        try:
            gen = stream_tokens(handle, payloads[i])
            toks, idx, arrivals = [], [], []
            for c in gen:
                arrivals.append((time.perf_counter(),
                                 gen._inner.replica_actor_id))
                toks.append(c["token"])
                idx.append(c["index"])
                if on_chunk is not None:
                    on_chunk(i, len(toks))
            out[i] = {"tokens": toks, "index": idx,
                      "ttft": arrivals[0][0] - t0, "arrivals": arrivals,
                      "replicas": {r for _, r in arrivals},
                      "end": time.perf_counter() - t0}
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append((i, e))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if errors or any(o is None for o in out):
        raise AssertionError(f"streams failed: {errors}")
    return {"streams": out, "seconds": time.perf_counter() - t0}


def http_stream(port, payload, headers=(), t0=None) -> dict:
    """One request to ``/llm`` with ``Accept: text/event-stream``, read as
    it arrives: status, headers, the chunks (or the JSON body of a
    refusal) and the TTFT from ``t0``."""
    import http.client

    t0 = time.perf_counter() if t0 is None else t0
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/llm", body=json.dumps(payload), headers={
            "Content-Type": "application/json",
            "Accept": "text/event-stream", **dict(headers)})
        resp = conn.getresponse()
        hdrs = {k.lower(): v for k, v in resp.getheaders()}
        if resp.status != 200:
            return {"status": resp.status, "headers": hdrs,
                    "body": json.loads(resp.read())}
        buf, chunks, ttft = b"", [], None
        while True:
            data = resp.read1(1 << 16)
            if not data:
                break
            buf += data
            while b"\n\n" in buf:
                event, buf = buf.split(b"\n\n", 1)
                if not event.startswith(b"data: "):
                    raise AssertionError(f"not an SSE event: {event!r}")
                if ttft is None:
                    ttft = time.perf_counter() - t0
                chunks.append(json.loads(event[6:]))
        if buf:
            raise AssertionError(f"a partial SSE event: {buf!r}")
        return {"status": 200, "headers": hdrs, "chunks": chunks,
                "ttft": ttft, "end": time.perf_counter() - t0}
    finally:
        conn.close()


def http_wave(port, payloads, headers=None) -> dict:
    import threading

    out = [None] * len(payloads)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(
        i, http_stream(port, payloads[i], (headers or {}).get(i, ()), t0)))
        for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if any(o is None for o in out):
        raise AssertionError("an HTTP stream failed")
    return {"streams": out, "seconds": time.perf_counter() - t0}


def debug_llm(port, app) -> dict:
    """``GET /debug/llm?app=``: the replica's ``debug_dump`` (flight ring,
    stats, pool), through the proxy."""
    import urllib.request

    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/debug/llm?app={app}", timeout=120) as r:
        replicas = json.loads(r.read())["replicas"]
    if len(replicas) != 1 or replicas[0] is None:
        raise AssertionError(f"/debug/llm replicas {replicas}")
    return replicas[0]


def alive_actors(rt, node, class_name) -> dict:
    """actor id -> worker pid of the live actors of ``class_name``."""
    actors = rt.worker.global_worker().gcs.call("list_actors")["actors"]
    ids = {a["actor_id"] for a in actors if a.get("class_name") == class_name
           and a.get("state") != "DEAD"}
    return {w.actor_id: w.proc.pid for w in node.raylet._all_workers.values()
            if w.actor_id in ids and w.proc is not None}


def wait_for(pred, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout_s} s waiting for {what}")


def wave_rates(wave, ntok) -> str:
    ttft = [s["ttft"] * 1e3 for s in wave["streams"]]
    return (f"{ntok / wave['seconds']:.1f} tokens/s, TTFT p50 "
            f"{percentile(ttft, 0.5):.1f} ms p99 {percentile(ttft, 0.99):.1f}"
            f" ms (of {len(ttft)} requests, so p99 ~ the max)")


def pool_whole_dump(dump, tag) -> None:
    cache = dump["cache"]
    if (cache["used_blocks"] or cache["reserved_blocks"]
            or cache["freed_total"] != cache["allocated_total"]
            or cache["free_blocks"] + cache["cached_blocks"]
            != cache["num_blocks"] - 1):
        raise AssertionError(f"{tag}: the replica's pool is not whole: "
                             f"{cache}")


def serve_phase(torch, card) -> dict:
    """Serve on the card (``ray_tpu_torch.serve``), Llama-125M at full
    width on the engine phases' geometry and workload
    (``engine_profile.workload``): an HTTP proxy on port 0; the app
    ``build_llm_app(EngineConfig(model="llama", ...), params=<ref of the
    bf16 weights in the store>, num_replicas=1,
    ray_actor_options={"num_gpus": 1})`` on route ``/llm``; ``serve.run``
    to HEALTHY and the replica's start by part. Then the 8 requests at
    once through the handle (``stream_tokens``; the first, cold wave),
    over HTTP with server-sent events, through the handle again, and
    through the handle under a ``torch.profiler`` trace in the replica:
    tokens/s and TTFT p50/p99 beside in-process; every stream equal to the in-process engine's on
    the same weights or its first divergence at a top-2 gap below
    GAP_FAULT (a sampled row held to its keyed draw); each request alone
    through the handle and over HTTP: equal; the traced wave's B4/B5
    launches 12 x the decode steps / prefill calls of the replica's
    flight ring (read through ``/debug/llm``); the pool whole. Then the
    controller's process is killed while 8 streams run: every stream
    completes, and the restarted controller recovers from its checkpoint
    and adopts the replica (same actor id, no second start). Then an f32
    app with ``max_waiting`` 4: a burst of 12 over HTTP (4 a priority
    class): every refusal a 503 with its class's Retry-After, every
    admitted stream to its budget, ``serve_requests_shed`` = the 503s;
    then its replica is killed after 8 tokens of each of 4 streams (2
    greedy, 2 sampled): ``stream_tokens`` resumes them on the replica the
    controller restarts on the freed card, every greedy stream equal to
    the uninterrupted in-process f32 stream and every sampled token its
    keyed draw's (DRAW_NOISE). Last, after ``serve.shutdown()`` and
    ``ray_tpu_torch.shutdown()`` no replica, controller or store process
    and no ``rtt_store_`` segment is left. Requests tagged "slow" wait
    SERVE_SLOW_S after each chunk in the replica (a chaos plan exported
    through ``RAY_TPU_CHAOS_PLAN``), so the kills land mid-stream."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch._private import chaos
    from ray_tpu_torch.benchmarks import engine_profile as ep
    from ray_tpu_torch.models.families import family
    from ray_tpu_torch.serve.controller import CONTROLLER_NAME
    from ray_tpu_torch.util import metrics

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    os.environ[chaos.ENV_VAR] = chaos.FaultPlan(faults=(chaos.Fault(
        point="llm.token", action="delay", when={"tag": "slow"},
        times=None, arg=SERVE_SLOW_S),)).to_json()
    node = rt.init(num_cpus=4, object_store_memory=CORE_STORE_BYTES)
    try:
        out = serve_checks(torch, card, rt, serve, node, ep, family,
                           CONTROLLER_NAME, metrics)
    finally:
        os.environ.pop(chaos.ENV_VAR, None)
        chaos.clear()
        if rt.is_initialized():
            serve.shutdown()
            rt.shutdown()
    torch.cuda.empty_cache()
    log(f"serve phase: {time.perf_counter() - t_phase:.1f} s on {card}")
    return out


def serve_checks(torch, card, rt, serve, node, ep, family, controller_name,
                 metrics) -> dict:
    from ray_tpu_torch.serve import api as serve_api
    from ray_tpu_torch.serve import proxy

    res = rt.cluster_resources()
    if res.get("GPU") != 1.0:
        raise AssertionError(f"autodetected GPU {res.get('GPU')}, expected 1")
    serve.start(http_options={"port": 0})
    port = serve_api._proxy.port
    rates = chunk_rates(serve)
    log(f"serve: the Serve path alone (a generator deployment with no "
        f"engine, 256 chunks through the handle a reading, 3 readings): "
        f"chunks/s on 1 stream {[round(r, 1) for r in rates[1]]}, on 8 "
        f"streams {[round(r, 1) for r in rates[8]]} on {card}")
    cfg = family("llama").full()
    model = family("llama").init(cfg, ep.ENGINE["seed"],
                                 torch.device("cuda", 0))
    weights = {k: v.detach().cpu() for k, v in model.weights().items()}
    del model
    torch.cuda.empty_cache()
    ref = rt.put(weights)
    ecfg = ep._config(model="llama", model_config=cfg, **ep.ENGINE)

    # -- start: serve.run to HEALTHY, the replica's start by part
    t_run, t = time.time(), time.perf_counter()
    handle = serve.run(serve_app(rt, ecfg, ref), name="llm",
                       route_prefix="/llm", timeout_s=600)
    healthy_s = time.perf_counter() - t
    prompts, params = ep.workload(cfg.vocab_size)
    payloads = serve_payloads(prompts, params)
    n, ntok = len(prompts), len(prompts) * ep.NEW_TOKENS
    w1 = handle_wave(handle, payloads)
    parts = handle.where.remote().result(timeout=120)
    dump = debug_llm(port, "llm")
    walls = parts["walls"]
    start = {"spawn": walls["proc_start"] - t_run,
             "boot": walls["init"] - walls["proc_start"], **dump["start_s"]}
    log(f"serve: serve.run to HEALTHY {healthy_s:.2f} s; the replica's "
        f"start by part (s; spawn = serve.run's call to the worker "
        f"process's start, boot = that to LLMDeployment's __init__: the "
        f"worker's start and the deployment's load, which imports torch "
        f"and the port; then LLMDeployment's own start_s from /debug/llm: "
        f"get_weights, engine_build, and graph_capture = the first wave's "
        f"{dump['executor']['graphs']['decode']} decode graphs): "
        f"{ {k: round(v, 3) for k, v in start.items()} } on {card}")
    if (parts["visible"], parts["device"], parts["backend"]) != (
            "0", "cuda:0", "cuda"):
        raise AssertionError(f"the replica's device {parts}")

    # -- bf16: the first (cold) wave above, then warm: over HTTP, through
    # the handle, and through the handle traced
    w2 = http_wave(port, payloads)
    for s in w2["streams"]:
        if s["status"] != 200 or s["headers"]["content-type"] != \
                "text/event-stream":
            raise AssertionError(f"HTTP stream {s['status']} {s['headers']}")
        if [c["index"] for c in s["chunks"]] != list(range(ep.NEW_TOKENS)):
            raise AssertionError("HTTP chunk indices not 0..31")
        s["tokens"] = [c["token"] for c in s["chunks"]]
    w3 = handle_wave(handle, payloads)
    mark = debug_llm(port, "llm")["steps_total"]
    was = handle.trace_start.remote().result(timeout=300)
    w4 = handle_wave(handle, payloads)
    traced = handle.trace_stop.remote().result(timeout=600)
    dump = debug_llm(port, "llm")
    recs = ring_records(dump, mark)
    n_layer = traced["n_layer"]
    ring = ring_counts(recs, n_layer)
    calls = {k: traced["counts"][k] - was[k] for k in was}
    trace = {k: traced["launches"].get(k, 0) for k in ring}
    eager = {k: traced["eager"].get(k, 0) for k in ring}
    log_launch_counts("serve[replica llama bf16]", trace, ring,
                      traced["walls"], recs, n_layer)
    want_trace = {"paged_decode": ring["paged_decode"]
                  + eager["paged_decode"],
                  "paged_prefill": ring["paged_prefill"]}
    log(f"serve: the replica's traced wave: {calls['prefill_calls']} "
        f"prefill calls, {calls['decode_steps']} decode steps "
        f"({calls['replays']} graph replays, {calls['graphs']} graphs "
        f"captured in it); B4/B5 launches, trace {trace}, ring x {n_layer} "
        f"{ring}, eager (the wrappers': prefill calls, and a new graph's "
        f"warm-up step) {eager}")
    others = {k: v for k, v in traced["launches"].items() if k not in ring}
    if (trace != want_trace or any(others.values())
            or ring != {"paged_decode": n_layer * calls["decode_steps"],
                        "paged_prefill": n_layer * calls["prefill_calls"]}
            or calls["replays"] != calls["decode_steps"]
            or eager["paged_prefill"] != ring["paged_prefill"]
            or eager["paged_decode"] != n_layer * calls["graphs"]
            or min(calls["prefill_calls"], calls["decode_steps"]) == 0):
        raise AssertionError(f"serve: the replica's launches {traced} "
                             f"against its ring {ring} and calls {calls}")
    pool_whole_dump(dump, "serve[bf16]")

    # each request alone, through the handle and over HTTP: equal
    from ray_tpu_torch.serve.llm import stream_tokens

    alone = [[c["token"] for c in stream_tokens(handle, p)]
             for p in payloads]
    alone_http = [[c["token"] for c in http_stream(port, p)["chunks"]]
                  for p in payloads]
    if alone != alone_http:
        raise AssertionError("serve: a request alone over HTTP streams "
                             "other tokens than through the handle")

    # the in-process engine on the same weights
    engine = ep.make_engine(None, "llama", params=weights)
    ep.serve(torch, engine, prompts, params)
    local = ep.serve(torch, engine, prompts, params)
    local_ttft = []
    for rid in local["ids"]:
        ev = {e["event"]: e["ts"]
              for e in engine.request_timeline(rid)["events"]}
        local_ttft.append(1e3 * (ev["first_token"] - ev["submitted"]))
    for tag, outs in (("first wave", [s["tokens"] for s in w1["streams"]]),
                      ("HTTP wave", [s["tokens"] for s in w2["streams"]]),
                      ("handle wave", [s["tokens"] for s in w3["streams"]]),
                      ("traced wave", [s["tokens"] for s in w4["streams"]]),
                      ("alone", alone)):
        if sum(map(len, outs)) != ntok:
            raise AssertionError(f"serve {tag}: {sum(map(len, outs))} tokens")
        divergences(torch, engine, prompts, params,
                    {False: local["outs"], True: outs}, f"serve[bf16 {tag}]",
                    GAP_FAULT, GAP_FAULT, names=("in-process", "served"))
    log(f"serve[bf16]: the first wave through the handle (cold: graph "
        f"capture, the prefill shapes' first calls) {wave_rates(w1, ntok)}; "
        f"warm: through the handle {wave_rates(w3, ntok)}; over HTTP "
        f"{wave_rates(w2, ntok)}; traced {wave_rates(w4, ntok)}; in-process "
        f"{ntok / local['seconds']:.1f} tokens/s, TTFT p50 "
        f"{percentile(local_ttft, 0.5):.1f} ms p99 "
        f"{percentile(local_ttft, 0.99):.1f} ms ({n} requests, {ntok} "
        f"tokens a wave) on {card}")

    # -- the controller's process killed while 8 streams run
    import threading

    before = alive_actors(rt, node, "ReplicaActor")
    (ctl_id, ctl_pid), = alive_actors(rt, node, "ServeController").items()
    first = [0] * n
    killed = threading.Event()
    kill_at = []

    def kill_controller(i, got):
        first[i] = got
        if min(first) >= 1 and not killed.is_set():
            killed.set()
            kill_at.append(time.perf_counter())
            os.kill(ctl_pid, 9)

    wk = handle_wave(handle, serve_payloads(prompts, params, "slow"),
                     on_chunk=kill_controller)
    if not killed.is_set():
        raise AssertionError("the controller was not killed mid-wave")
    outs = [s["tokens"] for s in wk["streams"]]
    divergences(torch, engine, prompts, params,
                {False: local["outs"], True: outs},
                "serve[bf16 controller killed]", GAP_FAULT, GAP_FAULT,
                names=("in-process", "served"))

    def recovered():
        try:
            st = serve.status()
        except Exception:  # noqa: BLE001 — the controller is restarting
            return False
        return (st["_controller"]["restarts"] == 1
                and st["llm"]["LLMDeployment"]["status"] == "HEALTHY")

    wait_for(recovered, 120, "the controller's recovery")
    back_s = time.perf_counter() - kill_at[0]
    st = serve.status()
    after = alive_actors(rt, node, "ReplicaActor")
    ctl = alive_actors(rt, node, "ServeController")
    log(f"serve: controller killed (pid {ctl_pid}) after each of {n} "
        f"streams had a token; all {n} completed ({ntok} tokens, the wave "
        f"{wk['seconds']:.2f} s); the raylet restarted it in place (pid "
        f"{ctl.get(ctl_id)}), "
        f"it recovered from its checkpoint in "
        f"{st['_controller']['recovery_seconds']:.3f} s (HEALTHY again "
        f"{back_s:.2f} s after the kill) and adopted the replica: "
        f"{after == before} on {card}")
    if list(ctl) != [ctl_id] or ctl[ctl_id] == ctl_pid or after != before:
        raise AssertionError(f"serve: after the controller's restart: "
                             f"controllers {ctl}, replicas {after} (before "
                             f"{before})")
    del engine
    torch.cuda.empty_cache()

    # -- f32: overload, then the replica killed mid-stream
    serve.delete("llm")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model = family("llama").init(cfg32, ep.ENGINE["seed"],
                                 torch.device("cuda", 0))
    weights32 = {k: v.detach().cpu() for k, v in model.weights().items()}
    del model
    torch.cuda.empty_cache()
    ref32 = rt.put(weights32)
    ecfg32 = dataclasses.replace(ecfg, model_config=cfg32,
                                 max_waiting=SERVE_MAX_WAITING)
    t = time.perf_counter()
    handle = serve.run(serve_app(rt, ecfg32, ref32,
                                 max_ongoing_requests=2 * SERVE_BURST),
                       name="llm", route_prefix="/llm", timeout_s=600)
    log(f"serve[f32]: serve.run to HEALTHY {time.perf_counter() - t:.2f} s")
    bprompts, bparams = ep.workload(cfg.vocab_size, seed=1)
    burst = serve_payloads((bprompts * 2)[:SERVE_BURST],
                           (bparams * 2)[:SERVE_BURST])
    shed0 = metrics.collect("serve_requests_shed")
    hb = http_wave(port, burst, headers={
        i: (("x-ray-tpu-priority", SERVE_CLASSES[i % 3]),)
        for i in range(SERVE_BURST)})
    shed1 = metrics.collect("serve_requests_shed")
    refused = [(i, s) for i, s in enumerate(hb["streams"])
               if s["status"] != 200]
    shed = sum(v - shed0.get(k, 0.0) for k, v in shed1.items()
               if k.startswith("serve_requests_shed_total"))
    for i, s in refused:
        if s["status"] != 503 or s["headers"].get("retry-after") \
                != proxy._RETRY_AFTER[SERVE_CLASSES[i % 3]]:
            raise AssertionError(f"serve overload: request {i} got "
                                 f"{s['status']} {s['headers']}")
    admitted = [s for s in hb["streams"] if s["status"] == 200]
    if any(len(s["chunks"]) != ep.NEW_TOKENS or "error" in s["chunks"][-1]
           for s in admitted):
        raise AssertionError("serve overload: an admitted stream stopped "
                             "short of its budget")
    log(f"serve[f32 overload]: a burst of {SERVE_BURST} against max_waiting "
        f"{SERVE_MAX_WAITING}: {len(admitted)} streamed to their "
        f"{ep.NEW_TOKENS} tokens, {len(refused)} refused (503, Retry-After "
        f"by class {[(SERVE_CLASSES[i % 3], s['headers']['retry-after']) for i, s in refused]}); "
        f"serve_requests_shed moved {shed:g}")
    if not refused or not admitted or shed != len(refused):
        raise AssertionError(f"serve overload: {len(refused)} refused, "
                             f"{len(admitted)} admitted, shed {shed}")

    fprompts, fparams = prompts[:4], list(params[:4])
    from ray_tpu_torch.serve.llm import SamplingParams

    fparams[1] = SamplingParams(max_new_tokens=ep.NEW_TOKENS,
                                temperature=0.8, top_p=0.9, seed=11)
    engine32 = ep.make_engine(None, "llama", dtype=torch.float32,
                              params=weights32)
    ref_outs = ep.serve(torch, engine32, fprompts, fparams)["outs"]
    # the driver drops its last reference to the weights before the kill:
    # the replica started in the killed one's place reads them through
    # the ref that serve.run holds while the app is deployed
    held = [r.hex() for r in serve_api._bound_refs["llm"]]
    ref32_hex = ref32.hex()
    del ref32
    gc.collect()
    log(f"serve[f32 failover]: the driver dropped its ref of the weights "
        f"({ref32_hex}); serve holds {held} for the app")
    if held != [ref32_hex]:
        raise AssertionError(f"serve holds {held}, not the weights' ref")
    (old_id, old_pid), = alive_actors(rt, node, "ReplicaActor").items()
    seen = [0] * len(fprompts)
    kill = {}

    def kill_replica(i, got):
        seen[i] = got
        if min(seen) >= SERVE_KILL_AFTER and "at" not in kill:
            kill["at"], kill["seen"] = time.perf_counter(), list(seen)
            os.kill(old_pid, 9)

    wf = handle_wave(handle, serve_payloads(fprompts, fparams, "slow"),
                     on_chunk=kill_replica)
    new = alive_actors(rt, node, "ReplicaActor")
    outs = [s["tokens"] for s in wf["streams"]]
    moved = sum(old_id in s["replicas"] and len(s["replicas"]) == 2
                for s in wf["streams"])
    resumed = [t for s in wf["streams"] for t, r in s["arrivals"]
               if r != old_id]
    resume_s = min(resumed) - kill["at"] if resumed and kill else math.nan
    log(f"serve[f32 failover]: replica killed (pid {old_pid}) after "
        f"{kill.get('seen')} tokens of its {len(fprompts)} streams; "
        f"{moved} streams resumed on the replica the controller started on "
        f"the freed card ({len(new)} live, old one gone: "
        f"{old_id not in new}); first resumed token {resume_s:.2f} s after "
        f"the kill on {card}")
    if (not kill or moved != len(fprompts) or len(new) != 1
            or old_id in new
            or any(s["index"] != list(range(ep.NEW_TOKENS))
                   for s in wf["streams"])):
        raise AssertionError(f"serve failover: kill {kill}, moved {moved}, "
                             f"replicas {new}")
    divergences(torch, engine32, fprompts, fparams,
                {False: ref_outs, True: outs}, "serve[f32 failover]", 0.0,
                DRAW_NOISE, names=("uninterrupted in-process", "resumed"))
    del engine32
    stats = handle.stats.remote().result(timeout=120)
    if stats["requests_resumed"] != len(fprompts):
        raise AssertionError(f"resumed {stats['requests_resumed']}")

    # -- teardown: nothing left
    pids = dict(alive_actors(rt, node, "ReplicaActor"))
    pids.update(alive_actors(rt, node, "ServeController"))
    store_pid = node.store_proc.pid
    workers = [w.proc.pid for w in node.raylet._all_workers.values()
               if w.proc is not None]
    serve.shutdown()
    rt.shutdown()
    deadline = time.monotonic() + 30
    while (any(pid_alive(p) for p in pids.values())
           and time.monotonic() < deadline):
        time.sleep(0.05)
    left = {"replica/controller": [p for p in pids.values() if pid_alive(p)],
            "store": pid_alive(store_pid),
            "workers": [p for p in workers if pid_alive(p)],
            "segments": [s for s in os.listdir("/dev/shm")
                         if s.startswith(f"rtt_store_{store_pid}_")],
            "proxy": serve_api._proxy is not None}
    log(f"serve: after serve.shutdown() and shutdown(): {left}")
    if any(left.values()):
        raise AssertionError(f"left after shutdown: {left}")
    return {"launches": ring, "eager": eager}


# ------------------------------------------------------------ the trainer

# Llama-125M at full width and depth through TorchTrainer in a num_gpus=1
# gang: the batch of step s is drawn from seed TRAINER_SEED + s, so a
# resumed attempt takes up the right batch
TRAINER = dict(batch_size=16, seq_len=1024, steps=8, checkpoint_at=(4, 8),
               die_after=5)
TRAINER_SEED = 100
TRAINER_LOSS_TOL = 1e-3  # absolute, gang against in-process, per step
TRAINER_BUDGET_S = 90.0  # the phase's target, printed beside its seconds


def trainer_model(torch, device):
    """Llama-125M (weights seed 0) with AdamW, as ``run_gpt_bench``
    builds them: f32 masters, bf16 activations, the fused lm-head loss."""
    from ray_tpu_torch.benchmarks.gpt_mfu import make_optimizer
    from ray_tpu_torch.models.families import family

    fam = family("llama")
    cfg = fam.full()
    cfg = dataclasses.replace(
        cfg, max_seq_len=max(TRAINER["seq_len"], cfg.max_seq_len))
    net = fam.init(cfg, seed=0, device=device, train=True)
    return cfg, net, make_optimizer(net)


def trainer_step(torch, cfg, net, opt, step, device) -> float:
    """Step ``step`` (from 1) on its own batch; -> its loss, synchronised."""
    from ray_tpu_torch.benchmarks.gpt_mfu import bench_batch, train_step

    batch = bench_batch(cfg, TRAINER["batch_size"], TRAINER["seq_len"],
                        TRAINER_SEED + step, device)
    return float(train_step(net, opt, batch))


def state_digest(torch, state) -> list:
    """Per tensor of a checkpoint's state (model and optimizer state
    dicts, in key order), its float64 sum and sum of magnitudes, on the
    tensor's device: equal states give equal digests."""
    out = []

    def visit(prefix, v):
        if isinstance(v, dict):
            for k in sorted(v, key=str):
                visit(f"{prefix}/{k}", v[k])
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                visit(f"{prefix}/{i}", x)
        elif isinstance(v, torch.Tensor):
            d = v.detach().double()
            out.append([prefix, float(d.sum()), float(d.abs().sum())])

    visit("", state)
    return out


def trainer_loop(config):
    """The phase's ``train_loop_per_worker``. Attempt 0 trains steps 1-8
    from seed-0 weights and kills its own process right after reporting
    step ``die_after`` (once the trainer has taken that report); attempt
    1 loads the newest checkpoint in its trial dir and runs the steps
    after it. Every step reports its loss, its ms and this process's
    B1/B2/B3 launches since the loop began and the wall times of this
    process's start, the loop's, its CUDA context's, the model's build
    and the checkpoint's read; a checkpoint step also its checkpoint (model and optimizer
    state dicts), its bytes, save seconds and ``state_digest``."""
    import torch
    from ray_tpu_torch.ops import attention as at
    from ray_tpu_torch.train import Checkpoint, get_context, report
    from ray_tpu_torch.train.session import get_session
    from ray_tpu_torch.train.torch import get_device

    walls = {"proc_start": proc_start_wall(), "loop": time.time()}
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = get_context()
    attempt = ctx.experiment_config["attempt"]
    device = get_device()
    if device.type == "cuda":
        torch.zeros(1, device=device)  # the process's CUDA context
        torch.cuda.synchronize(device)
    walls["cuda"] = time.time()
    cfg, net, opt = trainer_model(torch, device)
    walls["model"] = time.time()
    first, resumed = 1, None
    if attempt > 0:
        names = sorted(n for n in os.listdir(ctx.get_trial_dir())
                       if n.startswith("ckpt_"))
        resumed = os.path.join(ctx.get_trial_dir(), names[-1])
        state = Checkpoint(resumed).load_state(map_location=device)
        net.load_state_dict(state["model"])
        opt.load_state_dict(state["optimizer"])
        first = state["step"] + 1
        del state
    walls["state"] = time.time()
    at.reset_launches()
    for step in range(first, TRAINER["steps"] + 1):
        t = time.perf_counter()
        loss = trainer_step(torch, cfg, net, opt, step, device)
        metrics = {"step": step, "loss": loss, "attempt": attempt,
                   "step_ms": 1e3 * (time.perf_counter() - t),
                   "launches": dict(at.LAUNCHES), "at": time.time(),
                   "device": str(device), "resumed_from": resumed,
                   "walls": walls}
        ckpt = None
        if step in TRAINER["checkpoint_at"]:
            state = {"model": net.state_dict(),
                     "optimizer": opt.state_dict(), "step": step}
            t = time.perf_counter()
            ckpt = Checkpoint.from_state(
                os.path.join(ctx.get_trial_dir(), f"ckpt_{step:03d}"), state)
            metrics["save_s"] = time.perf_counter() - t
            metrics["bytes"] = os.path.getsize(
                os.path.join(ckpt.path, "state.pt"))
            metrics["digest"] = state_digest(torch, state)
        report(metrics, checkpoint=ckpt)
        if attempt == 0 and step == TRAINER["die_after"]:
            session = get_session()
            deadline = time.monotonic() + 60
            while session.consumed < step and time.monotonic() < deadline:
                time.sleep(0.01)
            with open(os.path.join(ctx.get_trial_dir(), "died_at"), "w") as f:
                f.write(repr(time.time()))
            os._exit(1)


def trainer_reference(torch) -> dict:
    """The loop's steps 1-8 in this process, from the same seeds: losses
    and step ms; the training state is freed before it returns."""
    device = torch.device("cuda", 0)
    cfg, net, opt = trainer_model(torch, device)
    losses, ms = [], []
    for step in range(1, TRAINER["steps"] + 1):
        t = time.perf_counter()
        losses.append(trainer_step(torch, cfg, net, opt, step, device))
        ms.append(1e3 * (time.perf_counter() - t))
    del net, opt
    torch.cuda.empty_cache()
    return {"losses": losses, "ms": ms}


def trainer_phase(torch, card) -> dict:
    """Train on the card through the port's Train: ``TorchTrainer`` of
    ``trainer_loop`` on ``ScalingConfig(num_workers=1, use_gpu=True)``,
    checkpoints kept 2 by lowest loss, ``max_failures=1``, on
    ``ray_tpu_torch.init(num_cpus=4, num_gpus=1)``. The worker dies after
    reporting step 5; the gang restarts and resumes from the step-4
    checkpoint. Checks: ``fit`` ends without error at step 8; every loss
    the gang reported (steps 1-5, then 5-8) equals this process's run of
    the same loop from the same seeds within TRAINER_LOSS_TOL, and to the
    bit when two in-process runs are equal to the bit; B1, B2 and B3
    launch 12 times a step in the worker; the kept checkpoints are the two
    of lowest loss and ``Result.checkpoint`` the best, whose
    ``load_state`` equals what the worker saved (``state_digest``); after
    ``fit`` the resources are whole, both TrainWorkers dead and both
    placement groups ``REMOVED``. Prints step ms through the gang and in
    process, each checkpoint's bytes and save seconds, and the seconds
    from the worker's death to attempt 1's first step. -> the worker's
    launches, both attempts summed."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch.train import (CheckpointConfig, FailureConfig,
                                     RunConfig, ScalingConfig)
    from ray_tpu_torch.train.torch import TorchTrainer
    from ray_tpu_torch.util import state

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    refs = [trainer_reference(torch) for _ in range(2)]
    ref = refs[0]["losses"]
    bitwise = refs[0]["losses"] == refs[1]["losses"]

    attempts = []

    class RecordingTrainer(TorchTrainer):
        """Keeps each attempt's Result (``fit`` returns the last)."""

        def _run_attempt(self, storage, manager, attempt):
            attempts.append(super()._run_attempt(storage, manager, attempt))
            return attempts[-1]

    root = tempfile.mkdtemp(prefix="trainer_phase_")
    node = rt.init(num_cpus=4, num_gpus=1)
    try:
        trainer = RecordingTrainer(
            trainer_loop,
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(
                name="llama", storage_path=root,
                checkpoint_config=CheckpointConfig(
                    num_to_keep=2, checkpoint_score_attribute="loss",
                    checkpoint_score_order="min"),
                failure_config=FailureConfig(max_failures=1)))
        t = time.perf_counter()
        result = trainer.fit()
        fit_s = time.perf_counter() - t
        out = trainer_checks(torch, card, node, state, result, attempts,
                             ref, bitwise, fit_s)
        out["in_process_ms"] = [r["ms"] for r in refs]
    finally:
        if rt.is_initialized():
            rt.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    gang = out["gang_ms"]
    log(f"trainer: step ms through the gang, by attempt "
        f"{[[round(x, 2) for x in a] for a in gang]} (median after each "
        f"attempt's first step "
        f"{statistics.median([x for a in gang for x in a[1:]]):.2f}) "
        f"against in-process {[[round(x, 2) for x in r['ms']] for r in refs]} "
        f"(median after the first "
        f"{statistics.median([x for r in refs for x in r['ms'][1:]]):.2f}) "
        f"on {card}")
    seconds = time.perf_counter() - t_phase
    log(f"trainer phase: {seconds:.1f} s (target {TRAINER_BUDGET_S:.0f} s) "
        f"on {card}")
    return out


def trainer_checks(torch, card, node, state, result, attempts, ref, bitwise,
                   fit_s) -> dict:
    from ray_tpu_torch.train import Checkpoint

    if result.error is not None or result.metrics.get("step") != \
            TRAINER["steps"]:
        raise AssertionError(f"trainer: fit ended at "
                             f"{result.metrics.get('step')}: {result.error}")
    if len(attempts) != 2 or attempts[0].error is None:
        raise AssertionError(f"trainer: {len(attempts)} attempts, the first "
                             f"ending {attempts[0].error!r}")
    hist = [a.metrics_history for a in attempts]
    steps = [[m["step"] for m in h] for h in hist]
    die, last = TRAINER["die_after"], TRAINER["steps"]
    want_steps = [list(range(1, die + 1)), list(range(die, last + 1))]
    log(f"trainer: attempt 0 ended {attempts[0].error.splitlines()[0]!r} "
        f"after steps {steps[0]}; attempt 1 resumed from "
        f"{os.path.basename(hist[1][0]['resumed_from'] or '-')} and ran "
        f"steps {steps[1]}; fit {fit_s:.2f} s")
    if steps != want_steps:
        raise AssertionError(f"trainer: steps {steps}, expected {want_steps}")
    if {m["device"] for h in hist for m in h} != {"cuda:0"}:
        raise AssertionError("trainer: a worker did not run on cuda:0")
    diffs = [abs(m["loss"] - ref[m["step"] - 1]) for h in hist for m in h]
    equal = all(d == 0.0 for d in diffs)
    log(f"trainer: losses through the gang {[[round(m['loss'], 6) for m in h] for h in hist]} "
        f"against in-process {[round(x, 6) for x in ref]}: largest "
        f"difference {max(diffs):.3e} (tolerance {TRAINER_LOSS_TOL}); two "
        f"in-process runs equal to the bit: {bitwise}; gang equal to the "
        f"bit: {equal}")
    if max(diffs) > TRAINER_LOSS_TOL or (bitwise and not equal):
        raise AssertionError(f"trainer: gang losses off the in-process run "
                             f"by {max(diffs)} (bitwise reference {bitwise})")
    n_layer = 12
    launches = {}
    for h in hist:
        for i, m in enumerate(h):
            want = {k: n_layer * (i + 1) for k in m["launches"]}
            if m["launches"] != want or len(want) != 3:
                raise AssertionError(f"trainer: step {m['step']} launches "
                                     f"{m['launches']}, expected {want}")
        for k, v in h[-1]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    log(f"trainer: launches in the worker, attempt 0 "
        f"{hist[0][-1]['launches']}, attempt 1 {hist[1][-1]['launches']} "
        f"(12 a step)")

    # checkpoints: the two of lowest loss kept, the best returned and
    # read back equal to what the worker saved
    saved = [m for h in hist for m in h if "bytes" in m]
    trial = os.path.join(result.path, "worker_0")
    on_disk = sorted(n for n in os.listdir(trial) if n.startswith("ckpt_"))
    lowest = sorted(saved, key=lambda m: m["loss"])[:2]
    want_disk = sorted(f"ckpt_{m['step']:03d}" for m in lowest)
    best = lowest[0]
    for m in saved:
        log(f"trainer: checkpoint of step {m['step']}: {m['bytes']} bytes, "
            f"saved in {m['save_s']:.3f} s "
            f"({m['bytes'] / m['save_s'] / 1e9:.2f} GB/s, written to the "
            f"page cache) on {card}")
    got_best = os.path.basename(result.checkpoint.path)
    if on_disk != want_disk or got_best != f"ckpt_{best['step']:03d}":
        raise AssertionError(f"trainer: checkpoints on disk {on_disk} "
                             f"(expected {want_disk}), best {got_best}")
    loaded = Checkpoint(result.checkpoint.path).load_state(
        map_location=torch.device("cuda", 0))
    same = state_digest(torch, loaded) == best["digest"]
    log(f"trainer: kept {on_disk}, best {got_best} (loss "
        f"{best['loss']:.6f}); its load_state equals what was saved: {same}")
    del loaded
    if not same:
        raise AssertionError("trainer: the best checkpoint reads back "
                             "other tensors than were saved")
    with open(os.path.join(trial, "died_at")) as f:
        died_at = float(f.read())
    first = hist[1][0]
    w = first["walls"]
    back_s = first["at"] - died_at
    back = {"to_process_start": w["proc_start"] - died_at,
            "boot": w["loop"] - w["proc_start"],
            "cuda_context": w["cuda"] - w["loop"],
            "model": w["model"] - w["cuda"],
            "checkpoint_read": w["state"] - w["model"],
            "first_step": first["at"] - w["state"]}

    # the cluster after fit: resources whole, workers dead, groups removed
    deadline = time.monotonic() + 10
    while (state.available_resources() != state.cluster_resources()
           and time.monotonic() < deadline):
        time.sleep(0.1)
    avail, total = state.available_resources(), state.cluster_resources()
    workers = [a["state"] for a in state.list_actors()
               if a.get("class_name") == "TrainWorker"]
    groups = [p["state"] for p in node.gcs.placement_groups.values()]
    log(f"trainer: after fit available {avail} = total {total}: "
        f"{avail == total}; TrainWorkers {workers}; placement groups "
        f"{groups}; from the worker's death to attempt 1's first step "
        f"{back_s:.2f} s, by part (s; to_process_start: the death seen, the "
        f"gang torn down, a new group and worker spawned; boot: the worker's "
        f"start to the loop's, with import torch, the actor's start and the "
        f"rendezvous): { {k: round(v, 3) for k, v in back.items()} } on "
        f"{card}")
    if avail != total or workers != ["DEAD", "DEAD"] or \
            groups != ["REMOVED", "REMOVED"]:
        raise AssertionError(f"trainer: after fit {avail} vs {total}, "
                             f"workers {workers}, groups {groups}")
    return {"launches": launches,
            "gang_ms": [[m["step_ms"] for m in h] for h in hist],
            "ckpt": [(m["step"], m["bytes"], m["save_s"]) for m in saved],
            "death_to_step_s": back_s, "death_to_step_parts": back}


# ------------------------------------------------------------------- data

# Llama-125M trained from a token dataset that the port's Data read, mapped
# and shuffled, streaming_split into a num_gpus=1 gang and fed to the card
# by iter_torch_batches: 8 files of 64 sequences of 1025 int32 ids drawn
# from DATA_SEED below the vocabulary (512 sequences, 2,099,200 B), one
# epoch of 32 steps of 16 x 1024
DATA = dict(files=8, rows=64, seq_len=1024, vocab=32000, batch_size=16,
            prefetch=2, map_batch_size=64)
DATA_SEED = 300           # the token files
DATA_SHUFFLE_SEED = 301   # random_shuffle
DATA_BUDGET_S = 60.0      # the phase's target, printed beside its seconds


def data_files(root) -> list:
    """Write the token files into ``root``; -> each sequence's row hash,
    file by file."""
    import numpy as np

    rng = np.random.default_rng(DATA_SEED)
    hashes = []
    for i in range(DATA["files"]):
        tokens = rng.integers(0, DATA["vocab"], (DATA["rows"],
                                                 DATA["seq_len"] + 1),
                              dtype=np.int64).astype(np.int32)
        np.save(os.path.join(root, f"tokens_{i:02d}.npy"), tokens)
        hashes += row_hashes(tokens.astype(np.int64))
    return hashes


def row_hashes(tokens) -> list:
    """One 8-byte BLAKE2b hex digest per sequence of an int64 [N, S + 1]
    array."""
    import hashlib

    import numpy as np

    tokens = np.ascontiguousarray(tokens, dtype=np.int64)
    return [hashlib.blake2b(row.tobytes(), digest_size=8).hexdigest()
            for row in tokens]


def batch_digest(tokens) -> dict:
    """An int64 [B, S + 1] batch on the host: its sum, the SHA-1 of its
    bytes and its rows' hashes."""
    import hashlib

    import numpy as np

    tokens = np.ascontiguousarray(tokens, dtype=np.int64)
    return {"sum": int(tokens.sum()),
            "sha1": hashlib.sha1(tokens.tobytes()).hexdigest(),
            "rows": row_hashes(tokens)}


def data_to_tokens(batch) -> dict:
    """The pipeline's map_batches: int32 ids to int64, ``data`` renamed
    ``tokens`` (the column ``train_step`` reads)."""
    import numpy as np

    return {"tokens": batch["data"].astype(np.int64)}


def data_pipeline(rd, root) -> tuple:
    """``read_numpy`` -> ``map_batches`` (a task stage) ->
    ``random_shuffle(seed=DATA_SHUFFLE_SEED)``, each stage materialized
    in turn, so each is timed alone and the next runs from its blocks.
    -> (the shuffled dataset, seconds, blocks and bytes by stage)."""
    stages = {}
    ds = rd.read_numpy(root)
    for name, make in (
            ("read", lambda d: d),
            ("map_batches", lambda d: d.map_batches(
                data_to_tokens, batch_size=DATA["map_batch_size"])),
            ("shuffle", lambda d: d.random_shuffle(seed=DATA_SHUFFLE_SEED))):
        t = time.perf_counter()
        ds = make(ds).materialize()
        stages[name] = {"s": time.perf_counter() - t,
                        "blocks": ds.num_blocks(), "bytes": ds.size_bytes()}
    return ds, stages


def data_loop(config):
    """The data phase's ``train_loop_per_worker``: Llama-125M (weights
    seed 0) trained on this rank's shard, read by ``iter_torch_batches``
    onto the worker's card. Each step reports its loss, its ms, the ms
    ``next()`` waited for the batch, the batch's device and digest
    (``batch_digest``, read back after the step), and this process's
    B1/B2/B3 launches since the loop began."""
    import torch
    from ray_tpu_torch.benchmarks.gpt_mfu import train_step
    from ray_tpu_torch.ops import attention as at
    from ray_tpu_torch.train import get_dataset_shard, report
    from ray_tpu_torch.train.torch import get_device

    torch.backends.cuda.matmul.allow_tf32 = False
    device = get_device()
    cfg, net, opt = trainer_model(torch, device)
    batches = iter(get_dataset_shard("train").iter_torch_batches(
        batch_size=DATA["batch_size"], device=device,
        prefetch=DATA["prefetch"], drop_last=True))
    at.reset_launches()
    step = 0
    while True:
        t = time.perf_counter()
        batch = next(batches, None)
        wait_ms = 1e3 * (time.perf_counter() - t)
        if batch is None:
            break
        step += 1
        t = time.perf_counter()
        loss = float(train_step(net, opt, batch))
        step_ms = 1e3 * (time.perf_counter() - t)
        tokens = batch["tokens"]
        report({"step": step, "loss": loss, "step_ms": step_ms,
                "wait_ms": wait_ms, "device": str(tokens.device),
                "dtype": str(tokens.dtype), "shape": list(tokens.shape),
                "digest": batch_digest(tokens.cpu().numpy()),
                "launches": dict(at.LAUNCHES)})


def data_reference(torch, batches) -> dict:
    """The same batches through the same loop in this process, from the
    same weight seed: losses and step ms; the state is freed before it
    returns."""
    from ray_tpu_torch.benchmarks.gpt_mfu import train_step

    device = torch.device("cuda", 0)
    cfg, net, opt = trainer_model(torch, device)
    losses, ms = [], []
    for b in batches:
        tokens = torch.from_numpy(b.copy()).to(device)
        t = time.perf_counter()
        losses.append(float(train_step(net, opt, {"tokens": tokens})))
        ms.append(1e3 * (time.perf_counter() - t))
    del net, opt
    torch.cuda.empty_cache()
    return {"losses": losses, "ms": ms}


def data_feed_ms(torch, ds) -> dict:
    """The gang's shard (``streaming_split(1)``: one 512-row block) read in
    this process with no step between batches, ms a ``next()``: of
    ``iter_batches`` (``host``: views of the block), of ``iter_batches``
    with each batch copied on the host (``host_copy``: the block's pages
    touched), of ``iter_torch_batches`` onto the card (``cuda``, prefetch
    as the gang's), each on a fresh shard (a new block, none of its pages
    touched by this process), and of ``iter_torch_batches`` again over
    the ``cuda`` variant's shard (``cuda_again``: its mapping and pages
    already in this process). Each: its first batch's, and the median and
    max of the rest."""
    kw = dict(batch_size=DATA["batch_size"], drop_last=True)

    def host(shard):
        return shard.iter_batches(**kw)

    def host_copy(shard):
        return ({k: v.copy() for k, v in b.items()}
                for b in shard.iter_batches(**kw))

    def cuda(shard):
        return shard.iter_torch_batches(device=torch.device("cuda", 0),
                                        prefetch=DATA["prefetch"], **kw)

    out, shard = {}, None
    for name, batches in (("host", host), ("host_copy", host_copy),
                          ("cuda", cuda), ("cuda_again", cuda)):
        if name != "cuda_again":
            shard = ds.streaming_split(1)[0]
        it, times = iter(batches(shard)), []
        while True:
            t = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                break
            times.append(1e3 * (time.perf_counter() - t))
        torch.cuda.synchronize()
        out[name] = {"first": times[0], "p50": statistics.median(times[1:]),
                     "max": max(times[1:]), "batches": len(times)}
    return out


def data_phase(torch, card) -> dict:
    """Train on the card from the port's Data: the token files read,
    mapped and shuffled by the port's tasks (``data_pipeline``), then
    ``TorchTrainer(data_loop, datasets={"train": ds})`` on
    ``ScalingConfig(num_workers=1, use_gpu=True)``: ``streaming_split``
    into the gang, ``iter_torch_batches`` onto the card, 32 steps of 16 x
    1024. Checks: every sequence of the files once across the gang's
    batches; each gang batch's digest that of the same dataset's
    ``iter_batches(batch_size=16, drop_last=True)`` read here; every loss
    within TRAINER_LOSS_TOL of this process's run of the same batches
    from the same weights (equal to the bit reported); B1, B2 and B3 12 a
    step (384 each); the batches int64 [16, 1025] on ``cuda:0``. Prints
    the dataset's seconds, blocks and bytes by stage, step ms through the
    gang against in process, the wait in ``next()`` (p50 and max) beside
    the same shard read here with no step between batches
    (``data_feed_ms``) and the phase's seconds against DATA_BUDGET_S. ->
    the worker's launches."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.train import RunConfig, ScalingConfig
    from ray_tpu_torch.train.torch import TorchTrainer

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="data_phase_")
    files = os.path.join(root, "tokens")
    os.makedirs(files)
    rt.init(num_cpus=4, num_gpus=1)
    try:
        file_rows = data_files(files)
        ds, stages = data_pipeline(rd, files)
        host = [b["tokens"] for b in ds.iter_batches(
            batch_size=DATA["batch_size"], drop_last=True)]
        want = [batch_digest(b) for b in host]
        ref = data_reference(torch, host)
        del host
        feed = data_feed_ms(torch, ds)
        t = time.perf_counter()
        result = TorchTrainer(
            data_loop,
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(name="llama_data",
                                 storage_path=os.path.join(root, "runs")),
            datasets={"train": ds}).fit()
        fit_s = time.perf_counter() - t
        out = data_checks(card, result, stages, file_rows, want, ref, fit_s)
        log("data: the shard read in this process with no step between "
            "batches, ms a next(): " + "; ".join(
                f"{name} p50 {f['p50']:.3f}, max {f['max']:.3f}, first "
                f"{f['first']:.3f} ({f['batches']} batches)"
                for name, f in feed.items()) + f" on {card}")
        out["feed"] = feed
    finally:
        if rt.is_initialized():
            rt.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"data phase: {seconds:.1f} s (target {DATA_BUDGET_S:.0f} s) on "
        f"{card}")
    return out


def data_checks(card, result, stages, file_rows, want, ref, fit_s) -> dict:
    log("data: stages " + "; ".join(
        f"{name} {st['s']:.3f} s, {st['blocks']} blocks, {st['bytes']} B"
        for name, st in stages.items()) + f" on {card}")
    hist = result.metrics_history
    steps = len(file_rows) // DATA["batch_size"]
    if result.error is not None or [m["step"] for m in hist] != \
            list(range(1, steps + 1)):
        raise AssertionError(f"data: fit reported steps "
                             f"{[m['step'] for m in hist]} (expected 1-"
                             f"{steps}): {result.error}")
    shapes = {(m["device"], m["dtype"], tuple(m["shape"])) for m in hist}
    if shapes != {("cuda:0", "torch.int64",
                   (DATA["batch_size"], DATA["seq_len"] + 1))}:
        raise AssertionError(f"data: batches arrived as {shapes}")
    seen = [r for m in hist for r in m["digest"]["rows"]]
    once = (len(set(file_rows)) == len(file_rows)
            and sorted(seen) == sorted(file_rows))
    got = [m["digest"] for m in hist]
    same = [g == w for g, w in zip(got, want)]
    log(f"data: {len(seen)} sequences through the gang, each of the files' "
        f"{len(file_rows)} once: {once}; batch digests (int64 sum, SHA-1) "
        f"equal to the driver's iter_batches: {sum(same)} of {len(want)}")
    if not once or len(want) != steps or not all(same):
        raise AssertionError(f"data: sequences once {once}, digests equal "
                             f"{sum(same)} of {len(want)}")
    diffs = [abs(m["loss"] - r) for m, r in zip(hist, ref["losses"])]
    equal = all(d == 0.0 for d in diffs)
    log(f"data: losses through the gang {[round(m['loss'], 6) for m in hist]} "
        f"against in-process {[round(x, 6) for x in ref['losses']]}: "
        f"largest difference {max(diffs):.3e} (tolerance {TRAINER_LOSS_TOL}); "
        f"equal to the bit: {equal}")
    if max(diffs) > TRAINER_LOSS_TOL:
        raise AssertionError(f"data: gang losses off the in-process run by "
                             f"{max(diffs)}")
    n_layer = 12
    for i, m in enumerate(hist):
        expect = {k: n_layer * (i + 1) for k in m["launches"]}
        if m["launches"] != expect or len(expect) != 3:
            raise AssertionError(f"data: step {m['step']} launches "
                                 f"{m['launches']}, expected {expect}")
    launches = hist[-1]["launches"]
    gang = [m["step_ms"] for m in hist]
    waits = [m["wait_ms"] for m in hist]
    log(f"data: launches in the worker {launches} (12 a step); step ms "
        f"through the gang {[round(x, 2) for x in gang]} (median after the "
        f"first {statistics.median(gang[1:]):.2f}) against in-process "
        f"{[round(x, 2) for x in ref['ms']]} (median after the first "
        f"{statistics.median(ref['ms'][1:]):.2f}); fit {fit_s:.2f} s on "
        f"{card}")
    log(f"data: wait in next() for a batch p50 {statistics.median(waits):.3f}"
        f" ms, max {max(waits):.3f} ms (first {waits[0]:.3f}) on {card}")
    return {"launches": launches, "gang_ms": gang, "ref_ms": ref["ms"],
            "wait_ms": waits, "stages": stages, "bitwise": equal}


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
    long_prefill_phase(torch)
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

    # the speculative path: Llama-125M bf16 and int8 spec-on engines, the
    # counts reset just before each counted pass and read just after
    paths = (*paths, "llama_spec")
    launches["llama_spec"], eager["llama_spec"] = {}, {}
    for kind in SPEC_KINDS:
        sp = spec_phase(torch, kind, card)
        suffix = f"_{kind}" if kind else ""
        for base in ("paged_decode", "paged_prefill"):
            launches["llama_spec"][base + suffix] = sp["launches"][
                base + suffix]
            eager["llama_spec"][base + suffix] = sp["eager"][base + suffix]
    spec_lossless_phase(torch, card)
    structured_phase(torch, card)

    # the preemption path: Llama-125M bf16 under priority traffic, the
    # counts reset just before its counted pass and read just after
    paths = (*paths, "llama_preempt")
    pre = priority_phase(torch, card)
    launches["llama_preempt"], eager["llama_preempt"] = (pre["launches"],
                                                        pre["eager"])

    # the observability path: Llama-125M bf16 with its metrics, ring and
    # fail-closed paths checked, the counts reset just before its counted
    # pass and read just after
    paths = (*paths, "llama_obs")
    torch.cuda.empty_cache()
    ob = obs_phase(torch, card)
    launches["llama_obs"], eager["llama_obs"] = ob["launches"], ob["eager"]

    # the MoE path: Llama-125M-MoE trained and served, the counts reset
    # just before each of its counted runs and read just after
    paths = (*paths, MOE)
    moe = moe_phase(torch, card, args.profile)
    launches[MOE], eager[MOE] = moe["launches"], moe["eager"]
    train[MOE] = moe["train"]

    # the core path: Llama-125M bf16 in a num_gpus=1 actor of the port's
    # distributed core, its counts reset just before its counted pass (in
    # the actor's process) and read just after, from its flight ring
    paths = (*paths, "llama_core")
    core = core_phase(torch, card)
    launches["llama_core"], eager["llama_core"] = core["launches"], core["eager"]

    # the Serve path: Llama-125M bf16 in a num_gpus=1 replica behind the
    # controller, router and HTTP proxy, its counts reset just before its
    # traced wave (in the replica's process) and read just after, from its
    # flight ring
    paths = (*paths, "llama_serve")
    sv = serve_phase(torch, card)
    launches["llama_serve"], eager["llama_serve"] = sv["launches"], sv["eager"]

    # the Train path: Llama-125M trained through TorchTrainer in a
    # num_gpus=1 gang, through a worker death and a resume; its counts
    # reset in the worker just before its loop and read from its reports
    train["llama_trainer"] = {"launches": trainer_phase(torch, card)[
        "launches"]}

    # the Data path: Llama-125M trained in a num_gpus=1 gang from a token
    # dataset read, mapped and shuffled by the port's tasks and fed by
    # iter_torch_batches; its counts reset in the worker just before its
    # loop and read from its reports
    train["llama_data"] = {"launches": data_phase(torch, card)["launches"]}

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
            "launches": sum(t["launches"][name] for t in train.values()),
            "launches_by_path": {m: t["launches"][name]
                                 for m, t in train.items()},
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
    for model in (*FAMILIES, MOE):
        train_backends_phase(torch, model)
    log(f"chip_smoke.py: {time.perf_counter() - t0:.1f} s from the kernels' "
        f"build on {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
