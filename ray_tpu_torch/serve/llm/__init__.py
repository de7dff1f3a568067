"""Continuous-batching LLM serving of the port: paged KV cache
(``kv_cache.py``), the model steps and their CUDA graphs (``decode.py``),
the device side (``executor.py``), the scheduler (``engine.py``), the
speculative drafter (``drafter.py``) and grammar-constrained output
(``structured.py``)."""
from __future__ import annotations

from ray_tpu_torch.exceptions import (
    DeadlineExceededError,
    EngineDiedError,
    EngineOverloadedError,
    RequestCancelledError,
)
from ray_tpu_torch.serve.llm.engine import (
    EngineConfig,
    LLMEngine,
    SamplingParams,
    TokenStream,
)

__all__ = [
    "DeadlineExceededError", "EngineConfig", "EngineDiedError",
    "EngineOverloadedError", "LLMEngine", "RequestCancelledError",
    "SamplingParams", "TokenStream",
]
