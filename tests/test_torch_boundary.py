"""The port's boundaries: ``ray_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of ``ray_tpu``; entry points never fall back to
the CPU on their own; a kernel wrapper refuses a CPU tensor."""
from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "ray_tpu")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "ray_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_imports_no_jax_and_no_ray_tpu():
    files = _port_files()
    assert len(files) > 10
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for name in _imported(tree):
            if name.split(".")[0] in FORBIDDEN:
                bad.append((os.path.relpath(path, ROOT), name))
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import ray_tpu_torch, ray_tpu_torch.convert\n"
        "import ray_tpu_torch.serve.llm, ray_tpu_torch.ops.paged_attention\n"
        "import ray_tpu_torch.ops.quantization\n"
        "import ray_tpu_torch.ops.attention, ray_tpu_torch.ops.loss\n"
        "import ray_tpu_torch.benchmarks.gpt_mfu\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from ray_tpu_torch.models.gpt import GPT, GPTConfig
    from ray_tpu_torch.serve.llm import LLMEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine(auto_step=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GPT(GPTConfig.tiny())
    engine = LLMEngine(auto_step=False, device="cpu")
    assert engine.device.type == "cpu"
    assert engine.model_cfg.attention_backend == "torch"


def test_kernel_wrappers_refuse_cpu_tensors():
    from ray_tpu_torch.ops import paged_attention as pa

    pool = torch.zeros(3, 4, 2, 8)
    tables = torch.ones(1, 2, dtype=torch.int32)
    before = dict(pa.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_attention_cuda(torch.zeros(1, 2, 8), pool, pool, tables,
                                torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_prefill_attention_cuda(
            torch.zeros(1, 3, 2, 8), pool, pool, tables,
            torch.zeros(1, 3, dtype=torch.int32))
    # an explicit cuda backend on CPU tensors reaches the wrapper and raises
    with pytest.raises(ValueError, match="CUDA"):
        pa.decode_attention(torch.zeros(1, 2, 8), pool, pool, tables,
                            torch.zeros(1, dtype=torch.int32), backend="cuda")
    assert pa.LAUNCHES == before  # a refused call launches nothing
    with pytest.raises(ValueError, match="attention_backend"):
        pa.resolve_backend("pallas", "cpu")
    assert pa.resolve_backend("auto", "cpu") == "torch"
    assert pa.resolve_backend("auto", torch.device("cuda", 0)) == "cuda"


def test_quantized_kernel_wrappers_refuse_cpu_and_bad_scales():
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.ops.quantization import QuantizedKV, quantize_kv

    pool = QuantizedKV(*quantize_kv(torch.ones(3, 4, 2, 16), "int8"))
    tables = torch.ones(1, 2, dtype=torch.int32)
    q, pos = torch.zeros(1, 2, 16), torch.zeros(1, dtype=torch.int32)
    before = dict(pa.LAUNCHES)
    for fn, qq, pp in (
        (pa.paged_attention_cuda, q, pos),
        (pa.paged_prefill_attention_cuda, q[:, None].contiguous(),
         pos[:, None].contiguous()),
    ):
        with pytest.raises(ValueError, match="CUDA"):
            fn(qq, pool, pool, tables, pp)
        bad = QuantizedKV(pool.data, pool.scale[:, :2].contiguous())
        with pytest.raises(ValueError, match="scale plane"):
            fn(qq, bad, bad, tables, pp)
        with pytest.raises(TypeError, match="int8 or float8"):
            fn(qq, *[QuantizedKV(pool.data.float(), pool.scale)] * 2, tables,
               pp)
    assert pa.LAUNCHES == before


def test_kernel_build_is_keyed_by_source_and_headers(tmp_path, monkeypatch):
    from ray_tpu_torch import _build

    (tmp_path / "k.cu").write_text("// kernel\n")
    (tmp_path / "common.cuh").write_text("// header\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    assert _build.sources() == ["k"]
    first = _build._artifact("k")
    (tmp_path / "common.cuh").write_text("// header, edited\n")
    second = _build._artifact("k")
    (tmp_path / "k.cu").write_text("// kernel, edited\n")
    third = _build._artifact("k")
    assert len({first, second, third}) == 3
    assert all(p.startswith(str(tmp_path / "build")) for p in (first, third))
    # no library on disk: building needs nvcc, and without it raises
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()


def test_shared_binding_declares_argument_types(monkeypatch):
    """``_build.bind`` (used by every kernel wrapper) declares one ctypes
    type per signature code and an int result; ``raise_on`` passes rc 0."""
    import ctypes

    from ray_tpu_torch import _build

    monkeypatch.setattr(_build, "load", lambda name: ctypes.CDLL(None))
    fn = _build.bind("libc", "abs", "i")
    assert fn.argtypes == [ctypes.c_int] and fn.restype is ctypes.c_int
    assert fn(-3) == 3
    assert [t for t in map(_build._CTYPES.get, "pif")] == [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_float]
    assert _build.raise_on("libc", "abs", 0) is None


def test_run_gpt_bench_needs_cuda_unless_cpu_is_asked(monkeypatch):
    from ray_tpu_torch.benchmarks.gpt_mfu import run_gpt_bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_gpt_bench(config="tiny", batch_size=1, seq_len=8, steps=1)
