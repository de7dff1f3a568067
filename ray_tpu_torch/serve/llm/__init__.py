"""Continuous-batching LLM serving of the port: paged KV cache
(``kv_cache.py``), the model steps and their CUDA graphs (``decode.py``),
the device side (``executor.py``) and the scheduler (``engine.py``)."""
from __future__ import annotations

from ray_tpu_torch.exceptions import EngineDiedError, RequestCancelledError
from ray_tpu_torch.serve.llm.engine import (
    EngineConfig,
    LLMEngine,
    SamplingParams,
    TokenStream,
)

__all__ = [
    "EngineConfig", "EngineDiedError", "LLMEngine", "RequestCancelledError",
    "SamplingParams", "TokenStream",
]
