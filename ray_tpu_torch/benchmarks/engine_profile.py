"""Time and profile the port's serving engine on one card: the engine
workload of ``chip_smoke.py`` (GPT-2 125M at full width and depth, seeded
random weights, 8 requests of 30-900 prompt tokens, 32 new tokens each,
one of them sampled).

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

It drives the engine through ``submit`` / ``step`` and reads its public
``stats()`` and ``last_step_kind`` only, so it measures any version of
the package: ``python3
ray_tpu_torch/benchmarks/engine_profile.py --tree DIR`` imports
``ray_tpu_torch`` from the checkout at DIR (default: the one holding this
file); compare two versions inside one call on one card.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import sys
import time

ENGINE = dict(block_size=16, num_blocks=1024, max_batch_size=8,
              prefill_chunk_tokens=256, seed=0)
PROMPT_LENGTHS = (30, 64, 120, 200, 333, 512, 700, 900)
NEW_TOKENS = 32
# the host launch API calls counted per decode step (CUPTI runtime names
# may carry a version suffix)
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch",
               "cudaMemcpyAsync")
# a paged kernel's symbol; its second template argument is the pool's type
_PAGED_KERNEL = re.compile(r"(paged_decode|paged_prefill)(?:_mma)?_kernel<([^>]*)>")
_POOL_SUFFIX = {"signed char": "_int8", "__nv_fp8_e4m3": "_fp8"}


def workload(vocab_size: int, new_tokens: int = NEW_TOKENS):
    """The 8 prompts (seeded) and their sampling params: greedy, but
    request 3 samples (temperature 0.8, top-p 0.9, seed 7)."""
    import numpy as np

    from ray_tpu_torch.serve.llm import SamplingParams

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab_size, n).tolist()
               for n in PROMPT_LENGTHS]
    params = [SamplingParams(max_new_tokens=new_tokens) for _ in prompts]
    params[3] = SamplingParams(max_new_tokens=new_tokens, temperature=0.8,
                               top_p=0.9, seed=7)
    return prompts, params


def make_engine(quant=None):
    from ray_tpu_torch.models.gpt import GPTConfig
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    return LLMEngine(EngineConfig(model_config=GPTConfig.gpt2_small(),
                                  quantization=quant, **ENGINE),
                     auto_step=False)


def serve(torch, engine, prompts, params) -> dict:
    """Submit every request and step the engine until idle; per-step host
    times by kind."""
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
        m = _PAGED_KERNEL.search(e.key)
        if e.device_type == DeviceType.CUDA and m:
            pool = m.group(2).split(", ")[1]
            name = m.group(1) + _POOL_SUFFIX.get(pool, "")
            out[name] = out.get(name, 0) + e.count
    return out


def launch_calls(calls: dict) -> int:
    return sum(n for name, n in calls.items()
               if name.split("_v")[0] in LAUNCH_APIS)


def profiled_pass(torch, engine, prompts, params) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run = serve(torch, engine, prompts, params)
    rows = device_rows(prof)
    busy_ms = sum(r[0] for r in rows) / 1e3
    wall_ms = run["seconds"] * 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms,
            "decode_steps": len(run["steps"]["decode"]),
            "prefill_calls": len(run["steps"]["prefill"]),
            "paged_launches": paged_launches(prof),
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
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the engine profile needs a card",
              file=sys.stderr)
        return 2
    import ray_tpu_torch

    for quant in [None, *args.quant]:
        out = measure(torch, make_engine(quant))
        out.update(label=args.label, engine=quant or "bf16",
                   package=os.path.dirname(ray_tpu_torch.__file__),
                   card=torch.cuda.get_device_name(0))
        print("engine profile: " + json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
