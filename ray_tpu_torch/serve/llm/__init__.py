"""Continuous-batching LLM serving of the port: paged KV cache
(``kv_cache.py``), the model steps and their CUDA graphs (``decode.py``),
the device side (``executor.py``), the scheduler (``engine.py``), the
speculative drafter (``drafter.py``), grammar-constrained output
(``structured.py``) and the engine as a streaming Serve deployment
(``api.py``).

Exports resolve lazily (PEP 562), as in ``ray_tpu/serve/llm``: the engine
modules load torch, and the Serve controller, which imports ``obs`` for
the one-clock rule, must not pay that import in its process.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "DeadlineExceededError": "ray_tpu_torch.exceptions",
    "EngineDiedError": "ray_tpu_torch.exceptions",
    "EngineOverloadedError": "ray_tpu_torch.exceptions",
    "RequestCancelledError": "ray_tpu_torch.exceptions",
    "ModelParallelConfig": "ray_tpu_torch.serve.config",
    "LLMDeployment": "ray_tpu_torch.serve.llm.api",
    "build_llm_app": "ray_tpu_torch.serve.llm.api",
    "stream_tokens": "ray_tpu_torch.serve.llm.api",
    "EngineConfig": "ray_tpu_torch.serve.llm.engine",
    "LLMEngine": "ray_tpu_torch.serve.llm.engine",
    "SamplingParams": "ray_tpu_torch.serve.llm.engine",
    "TokenStream": "ray_tpu_torch.serve.llm.engine",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(mod), name)
    globals()[name] = value  # cache for subsequent lookups
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
