"""Time and profile the port's serving engine on one card: the engine
workload of ``chip_smoke.py`` (a model family at full width and depth,
GPT-2 125M or, with ``--model llama``, Llama-125M, or with ``--model
llama_moe`` Llama-125M-MoE; seeded random weights,
8 requests of 30-900 prompt tokens, 32 new tokens each, one of them
sampled).

For each engine (bf16, and ``--quant int8`` / ``fp8``) it prints one JSON
line with

- a timed warm pass: tokens/s, and the host time of each step by kind
  (each prefill ends in its token sync, and a decode step in the sync of
  its own ids, or under the lag-1 pipeline of the step before);
- the same pass under ``torch.profiler``: device busy time and the idle
  share of the wall time, the device time by kernel, and the launches of
  the paged kernels on the device (``paged_launches``: kernels replayed
  from a CUDA graph included);
- a window of decode steps alone (every request admitted and prefilled,
  the batch steady), profiled: host launch API calls per decode step
  (``cudaLaunchKernel``, ``cudaLaunchKernelExC``, ``cudaGraphLaunch``,
  ``cudaMemcpyAsync``, counted from the profiler's CPU-side runtime
  events), every CUDA runtime call by name, and the device kernels
  (copies included) per step.

The engine runs with ``prefix_caching=False`` where the version has the
knob: a pass repeats the same prompts, and with the cache on every pass
after the first would be a full prefix hit (what the cache costs on
traffic that never hits is measured by ``chip_smoke.py``'s
``unshared_cost_phase``, on prompts drawn anew for each pass). Shared-prefix traffic is its
own named workload, ``prefix_workload`` (the prefix phase of
``chip_smoke.py``), and so is priority traffic, ``priority_workload``
with ``make_priority_engine`` and its serving loop ``priority_serve`` (the
priority phase); this script adds no measurement of either.

It drives the engine through ``submit`` / ``step`` and reads its public
``stats()`` and ``last_step_kind`` only, so it measures any version of
the package: ``python3
ray_tpu_torch/benchmarks/engine_profile.py --tree DIR`` imports
``ray_tpu_torch`` from the checkout at DIR (default: the one holding this
file); compare two versions inside one call on one card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import statistics
import sys
import time

# a flight ring of 4096 records holds a whole counted pass (the second,
# profiler-free launch count of chip_smoke.py reads it)
RING = dict(flight_recorder_steps=4096)
ENGINE = dict(block_size=16, num_blocks=1024, max_batch_size=8,
              prefill_chunk_tokens=256, seed=0, prefix_caching=False, **RING)
PROMPT_LENGTHS = (30, 64, 120, 200, 333, 512, 700, 900)
NEW_TOKENS = 32
# shared-prefix traffic (prefix_workload): one 512-token prefix and a
# suffix of each request's own; 512 + 64 = 576 is 36 whole blocks
PREFIX_ENGINE = dict(block_size=16, num_blocks=256, max_batch_size=8,
                     prefill_chunk_tokens=256, seed=0, **RING)
SHARED_PREFIX = 512
SUFFIX_LENGTHS = (30, 64, 120, 200, 30, 64, 120, 200)
FLOOD_PROMPTS, FLOOD_LENGTH = 12, 700
# speculative-decoding traffic (spec_workload): 8 prompts, each a seeded
# random motif of 16-48 tokens repeated to 200-800 tokens, 64 new tokens
SPEC_MOTIF, SPEC_LENGTH, SPEC_NEW_TOKENS = (16, 48), (200, 800), 64
# priority traffic (priority_workload): batch-class streams that hold most
# of the pool (blocks_for(700 + 160) = 54 blocks each, 216 of 255), then
# bursts of interactive chat turns (32 new tokens each), each submitted
# once the engine has run PRIORITY_BURSTS[i][0] decode steps
PRIORITY_ENGINE = dict(block_size=16, num_blocks=256, max_batch_size=8,
                       prefill_chunk_tokens=256, seed=0, **RING)
PRIORITY_BATCH = (4, 700, 160)   # streams, prompt tokens, new tokens
PRIORITY_SEED = 2
PRIORITY_BURSTS = ((8, 4, 300), (40, 4, 300))  # decode steps, requests, tokens
PRIORITY_NEW_TOKENS = 32
# pressure-only thresholds: the queue-wait and aging clocks out of reach, so
# parks and resumes depend on the step sequence alone (and a rehearsal on
# the CPU gives the card's counts)
PREEMPTION = dict(kv_pressure=0.8, queue_wait_s=1e6, resume_pressure=0.7,
                  aging_s=1e6)
# the host launch API calls counted per decode step (CUPTI runtime names
# may carry a version suffix)
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch",
               "cudaMemcpyAsync")
# a paged kernel's symbol; its second template argument is the pool's type
_PAGED_KERNEL = re.compile(r"(paged_decode|paged_prefill)(?:_mma)?_kernel<([^>]*)>")
_POOL_SUFFIX = {"signed char": "_int8", "__nv_fp8_e4m3": "_fp8"}
# the CPU op that ties a trace's timeline to this process's wall clock
ANCHOR = "ray_tpu_torch.anchor"


def workload(vocab_size: int, new_tokens: int = NEW_TOKENS, seed: int = 0):
    """The 8 prompts (drawn from ``seed``) and their sampling params:
    greedy, but request 3 samples (temperature 0.8, top-p 0.9, seed 7)."""
    import numpy as np

    from ray_tpu_torch.serve.llm import SamplingParams

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab_size, n).tolist()
               for n in PROMPT_LENGTHS]
    params = [SamplingParams(max_new_tokens=new_tokens) for _ in prompts]
    params[3] = SamplingParams(max_new_tokens=new_tokens, temperature=0.8,
                               top_p=0.9, seed=7)
    return prompts, params


def prefix_workload(vocab_size: int, new_tokens: int = NEW_TOKENS) -> dict:
    """Shared-prefix traffic, seeded: ``wave``, 8 prompts of one shared
    512-token prefix and a suffix of their own of ``SUFFIX_LENGTHS``
    tokens, request 3 sampled (temperature 0.8, top-p 0.9, seed 7), the
    rest greedy; ``flood``, 12 unrelated 700-token prompts, greedy. Each
    is (prompts, params). A run sends wave, wave, flood, wave: the second
    wave hits the prefix on the device (its 576-token prompts whole), the
    flood evicts it (into the host tier when there is one), and the last
    wave hits it again (promoted from the host)."""
    import numpy as np

    from ray_tpu_torch.serve.llm import SamplingParams

    rng = np.random.default_rng(1)
    prefix = rng.integers(0, vocab_size, SHARED_PREFIX).tolist()
    wave = [prefix + rng.integers(0, vocab_size, n).tolist()
            for n in SUFFIX_LENGTHS]
    flood = [rng.integers(0, vocab_size, FLOOD_LENGTH).tolist()
             for _ in range(FLOOD_PROMPTS)]
    greedy = SamplingParams(max_new_tokens=new_tokens)
    params = [greedy] * len(wave)
    params[3] = SamplingParams(max_new_tokens=new_tokens, temperature=0.8,
                               top_p=0.9, seed=7)
    return {"wave": (wave, params), "flood": (flood, [greedy] * len(flood))}


def spec_workload(vocab_size: int, seed: int = 0,
                  new_tokens: int = SPEC_NEW_TOKENS):
    """Speculative-decoding traffic, seeded: 8 prompts, each a random motif
    of ``SPEC_MOTIF`` tokens repeated up to a length in ``SPEC_LENGTH``
    (the repeated structure prompt-lookup drafting targets: templated
    text, code, few-shot examples), ``new_tokens`` each; request 3
    samples (temperature 0.8, top-p 0.9, seed 7), the rest are greedy."""
    import numpy as np

    from ray_tpu_torch.serve.llm import SamplingParams

    rng = np.random.default_rng(seed)
    prompts = []
    for _ in range(8):
        motif = rng.integers(0, vocab_size,
                             int(rng.integers(SPEC_MOTIF[0],
                                              SPEC_MOTIF[1] + 1))).tolist()
        length = int(rng.integers(SPEC_LENGTH[0], SPEC_LENGTH[1] + 1))
        prompts.append((motif * (length // len(motif) + 1))[:length])
    params = [SamplingParams(max_new_tokens=new_tokens) for _ in prompts]
    params[3] = SamplingParams(max_new_tokens=new_tokens, temperature=0.8,
                               top_p=0.9, seed=7)
    return prompts, params


def priority_workload(vocab_size: int) -> dict:
    """Priority traffic drawn from PRIORITY_SEED: ``batch``,
    PRIORITY_BATCH's batch-class streams (long prompts, many new tokens;
    stream 3, the first one parked, samples at temperature 0.8, top-p
    0.9, seed 7, the rest are greedy), and
    ``bursts``, one (decode steps, prompts, params) per PRIORITY_BURSTS
    entry: interactive-class chat turns of 32 new tokens, greedy. Each
    is (prompts, params)."""
    import numpy as np

    from ray_tpu_torch.serve.llm import SamplingParams

    rng = np.random.default_rng(PRIORITY_SEED)
    n, length, new = PRIORITY_BATCH
    prompts = [rng.integers(0, vocab_size, length).tolist() for _ in range(n)]
    params = [SamplingParams(max_new_tokens=new, priority="batch")
              for _ in prompts]
    params[3] = SamplingParams(max_new_tokens=new, priority="batch",
                               temperature=0.8, top_p=0.9, seed=7)
    turn = SamplingParams(max_new_tokens=PRIORITY_NEW_TOKENS,
                          priority="interactive")
    bursts = [(after, [rng.integers(0, vocab_size, tokens).tolist()
                       for _ in range(count)], [turn] * count)
              for after, count, tokens in PRIORITY_BURSTS]
    return {"batch": (prompts, params), "bursts": bursts}


def distinct_blocks(prompts, block_size: int) -> int:
    """Full prompt blocks of distinct content (chain) among ``prompts``:
    the most blocks a run of them can demote."""
    from ray_tpu_torch.serve.llm.kv_cache import _block_key

    seen = set()
    for p in prompts:
        digest = b""
        for i in range(len(p) // block_size):
            digest = _block_key(digest, p[i * block_size:(i + 1) * block_size])
            seen.add(digest)
    return len(seen)


def _config(**kw):
    """An ``EngineConfig`` of the knobs this version of the package has."""
    from ray_tpu_torch.serve.llm import EngineConfig

    names = {f.name for f in dataclasses.fields(EngineConfig)}
    return EngineConfig(**{k: v for k, v in kw.items() if k in names})


def make_engine(quant=None, model="gpt", dtype=None, params=None,
                **overrides):
    """The engine of model ``model`` at full width: GPT-2 125M ("gpt"),
    Llama-125M ("llama") or Llama-125M-MoE ("llama_moe",
    ``families.MODELS``), in ``dtype`` (None: the config's bf16), on
    ``params`` (a state dict; None: the seeded weights of ``ENGINE``);
    ``overrides`` set other knobs (``prefix_caching``, ``speculative_k``)."""
    from ray_tpu_torch.models.families import family
    from ray_tpu_torch.serve.llm import LLMEngine

    if model == "llama_moe":
        from ray_tpu_torch.models.families import llama_125m_moe

        model, cfg = "llama", llama_125m_moe()
    else:
        cfg = family(model).full()
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return LLMEngine(_config(model=model, model_config=cfg,
                             quantization=quant, **{**ENGINE, **overrides}),
                     params=params, auto_step=False)


def make_prefix_engine(quant=None, model="llama", **overrides):
    """The engine of ``prefix_workload`` (``PREFIX_ENGINE``, prefix
    caching on) at full width; ``overrides`` set other knobs
    (``host_cache_bytes``, ``attention_backend``)."""
    from ray_tpu_torch.models.families import family
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    cfg = family(model).full()
    return LLMEngine(EngineConfig(model=model, model_config=cfg,
                                  quantization=quant,
                                  **{**PREFIX_ENGINE, **overrides}),
                     auto_step=False)


def make_priority_engine(dtype=None, preemption=True, model_config=None,
                         device=None):
    """The engine of ``priority_workload`` (``PRIORITY_ENGINE``, prefix
    caching on) on Llama-125M at full width in ``dtype`` (None: bf16),
    with a host tier that holds every block the traffic can make, and
    ``PREEMPTION`` (``preemption=False``: none). ``model_config`` and
    ``device`` replace the model and the card (the CPU rehearsal's)."""
    from ray_tpu_torch.models.families import family, kv_heads
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.serve.llm.kv_transfer import KVLayout, dtype_name

    cfg = model_config or family("llama").full()
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    bs = PRIORITY_ENGINE["block_size"]
    layout = KVLayout(n_layer=cfg.n_layer, block_size=bs,
                      n_kv_head=kv_heads(cfg), head_dim=cfg.head_dim,
                      dtype=dtype_name(cfg.dtype))
    n, length, new = PRIORITY_BATCH
    blocks = n * ((length + new) // bs) + sum(
        count * ((tokens + PRIORITY_NEW_TOKENS) // bs)
        for _, count, tokens in PRIORITY_BURSTS)
    engine = LLMEngine(EngineConfig(
        model="llama", model_config=cfg, device=device,
        host_cache_bytes=blocks * layout.record_bytes,
        preemption=dict(PREEMPTION) if preemption else None,
        **PRIORITY_ENGINE), auto_step=False)
    if engine.cache.layout != layout:
        raise AssertionError(f"{engine.cache.layout} != {layout}")
    return engine


def priority_serve(torch, engine, work) -> dict:
    """Serve ``priority_workload`` traffic: submit the batch streams, then
    each burst once the engine has run its decode steps (at once when the
    engine idles first), stepping until idle. Per request (batch streams
    first, then the bursts in order) its tokens, its time to first token
    and its completion time on the host clock from its ``submit`` (the
    end of the step that emitted the token; every emitted token is on
    the host); the pass's seconds."""
    prompts, params = work["batch"]
    bursts = list(work["bursts"])
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    d0 = engine.num_decode_steps
    streams = [engine.submit(p, s) for p, s in zip(prompts, params)]
    submitted = [t0] * len(streams)
    first, finished = [], []
    idle = False
    while True:
        while bursts and (idle or engine.num_decode_steps - d0 >= bursts[0][0]):
            _, ps, ss = bursts.pop(0)
            for p, s in zip(ps, ss):
                submitted.append(time.perf_counter())
                streams.append(engine.submit(p, s))
        idle = not engine.step()
        now = time.perf_counter()
        first += [None] * (len(streams) - len(first))
        finished += [None] * (len(streams) - len(finished))
        for i, st in enumerate(streams):
            if first[i] is None and st._request.generated:
                first[i] = now - submitted[i]
            if finished[i] is None and st.done:
                finished[i] = now - submitted[i]
        if idle and not bursts:
            break
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    return {"outs": [list(s) for s in streams], "ttft": first,
            "done_s": finished, "seconds": time.perf_counter() - t0,
            "batch": len(prompts), "ids": [s.request_id for s in streams]}


def serve(torch, engine, prompts, params) -> dict:
    """Submit every request and step the engine until idle; the streams,
    their request ids, the pass's seconds and per-step host times by
    kind."""
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
            "ids": [s.request_id for s in streams],
            "seconds": time.perf_counter() - t0, "steps": steps}


def spec_serve(torch, engine, prompts, params) -> dict:
    """``serve`` for an engine that may run verify steps: the host time of
    each step by what it ran ("prefill", "decode", "verify", or "drain": a
    step that only reconciled the step in flight), from the engine's call
    counters."""
    steps = {"prefill": [], "decode": [], "verify": [], "drain": []}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = [engine.submit(p, s) for p, s in zip(prompts, params)]
    while True:
        was = (engine.num_prefill_calls, engine.num_decode_steps,
               engine.num_verify_steps)
        ts = time.perf_counter()
        if not engine.step():
            break
        dt = time.perf_counter() - ts
        now = (engine.num_prefill_calls, engine.num_decode_steps,
               engine.num_verify_steps)
        kind = ("prefill" if now[0] > was[0] else "verify" if now[2] > was[2]
                else "decode" if now[1] > was[1] else "drain")
        steps[kind].append(dt)
    torch.cuda.synchronize()
    return {"outs": [list(s) for s in streams],
            "seconds": time.perf_counter() - t0, "steps": steps}


def device_rows(prof):
    """Device-side entries (kernels, copies, memsets) of a profile, by
    total time: (µs, count, name)."""
    from torch.autograd import DeviceType

    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return sorted(rows, reverse=True)


def runtime_calls(prof) -> dict:
    """CUDA runtime API calls on the host by name (the profiler's
    CPU-side ``cuda*`` events) -> count."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU and e.key.startswith("cuda"):
            out[e.key] = out.get(e.key, 0) + e.count
    return out


def paged_launches(prof) -> dict:
    """Launches on the device of each paged kernel in a profile, by its
    wrapper's ``paged_attention.LAUNCHES`` key, read from the kernel
    symbols (an int8 or fp8 pool names the quantized variant). Kernels
    replayed from a CUDA graph are traced like any other."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.key_averages():
        name = (_paged_name(e.key) if e.device_type == DeviceType.CUDA
                else None)
        if name is not None:
            out[name] = out.get(name, 0) + e.count
    return out


def _paged_name(symbol: str) -> str | None:
    m = _PAGED_KERNEL.search(symbol)
    if m is None:
        return None
    return m.group(1) + _POOL_SUFFIX.get(m.group(2).split(", ")[1], "")


def anchor(prof) -> None:
    """Mark a running profile with this process's wall clock (call just
    after the profiler starts): ``paged_walls`` maps the trace's times to
    wall seconds through the mark."""
    from torch.profiler import record_function

    with record_function(ANCHOR):
        prof.anchor_wall = time.time()


def paged_walls(prof) -> dict:
    """The wall-clock start (seconds) of every paged kernel launch on the
    device in an ``anchor``-ed profile, by ``paged_launches``' names,
    sorted. Against a flight ring's step records (wall ``ts``) it places
    the launches a trace lacks."""
    from torch.autograd import DeviceType

    events = prof.events()
    mark = next((e for e in events if e.name == ANCHOR), None)
    if mark is None or not hasattr(prof, "anchor_wall"):
        raise ValueError("the profile has no anchor: call anchor(prof) "
                         "just after the profiler starts")
    base = prof.anchor_wall - mark.time_range.start / 1e6
    out: dict = {}
    for e in events:
        name = (_paged_name(e.name) if e.device_type == DeviceType.CUDA
                else None)
        if name is not None:
            out.setdefault(name, []).append(base + e.time_range.start / 1e6)
    return {k: sorted(v) for k, v in out.items()}


def launch_calls(calls: dict) -> int:
    return sum(n for name, n in calls.items()
               if name.split("_v")[0] in LAUNCH_APIS)


def profiled_pass(torch, engine, prompts, params) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        anchor(prof)
        run = serve(torch, engine, prompts, params)
    rows = device_rows(prof)
    busy_ms = sum(r[0] for r in rows) / 1e3
    wall_ms = run["seconds"] * 1e3
    return {"outs": run["outs"], "ids": run["ids"],
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms,
            "decode_steps": len(run["steps"]["decode"]),
            "prefill_calls": len(run["steps"]["prefill"]),
            "paged_launches": paged_launches(prof),
            "paged_walls": paged_walls(prof),
            "device_ms_by_kernel": {k[:90]: round(us / 1e3, 4)
                                    for us, _, k in rows[:15]},
            "device_calls_by_kernel": {k[:90]: n for _, n, k in rows[:15]}}


def prefilled(engine, kinds: list) -> bool:
    """Whether every submitted request is admitted and prefilled, by the
    engine's public ``stats()``; for a version without its ``waiting`` /
    ``prefilling`` keys, once ``kinds`` (the step kinds so far) ends in
    two decode steps."""
    stats = engine.stats() if hasattr(engine, "stats") else {}
    if "waiting" in stats and "prefilling" in stats:
        return not (stats["waiting"] or stats["prefilling"])
    return kinds[-2:] == ["decode", "decode"]


def decode_window(torch, engine, prompts, steps: int = 16) -> dict:
    """Admit and prefill every request (greedy, enough new tokens), step
    into the steady batch, then profile ``steps`` decode steps alone."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.serve.llm import SamplingParams

    sp = SamplingParams(max_new_tokens=steps + 8)
    streams = [engine.submit(p, sp) for p in prompts]
    kinds = []
    while not prefilled(engine, kinds):
        engine.step()
        kinds.append(engine.last_step_kind)
    for _ in range(2):
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
            if engine.last_step_kind != "decode":
                raise AssertionError("the window ran a prefill step")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    while engine.step():
        pass
    for s in streams:
        list(s)
    calls = runtime_calls(prof)
    rows = device_rows(prof)
    return {"steps": steps, "step_ms": 1e3 * wall / steps,
            "launch_api_calls_per_step": launch_calls(calls) / steps,
            "runtime_calls_per_step": {k: n / steps
                                       for k, n in sorted(calls.items())},
            "device_ops_per_step": sum(r[1] for r in rows) / steps,
            "device_busy_ms_per_step": sum(r[0] for r in rows) / 1e3 / steps}


def measure(torch, engine) -> dict:
    """The whole measurement of one engine (see the module docstring)."""
    prompts, params = workload(engine.model_cfg.vocab_size)
    serve(torch, engine, prompts, params)  # warm-up (and graph captures)
    run = serve(torch, engine, prompts, params)
    ntok = sum(map(len, run["outs"]))
    steps = run["steps"]
    return {
        "tokens": ntok, "seconds": run["seconds"],
        "tokens_per_s": ntok / run["seconds"],
        "decode_steps": len(steps["decode"]),
        "decode_step_ms": 1e3 * statistics.mean(steps["decode"]),
        "prefill_ms": 1e3 * statistics.mean(steps["prefill"]),
        "profile": profiled_pass(torch, engine, prompts, params),
        "decode_window": decode_window(torch, engine, prompts),
    }


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        here)), help="checkout to import ray_tpu_torch from")
    parser.add_argument("--quant", nargs="*", default=[],
                        help="quantized engines to measure after bf16")
    parser.add_argument("--label", default="", help="tag of the JSON lines")
    parser.add_argument("--model", default="gpt",
                        choices=("gpt", "llama", "llama_moe"),
                        help="model: a family at full width, or "
                             "Llama-125M-MoE")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the engine profile needs a card",
              file=sys.stderr)
        return 2
    import ray_tpu_torch

    for quant in [None, *args.quant]:
        out = measure(torch, make_engine(quant, args.model))
        out.update(label=args.label, engine=quant or "bf16", model=args.model,
                   package=os.path.dirname(ray_tpu_torch.__file__),
                   card=torch.cuda.get_device_name(0))
        print("engine profile: " + json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
