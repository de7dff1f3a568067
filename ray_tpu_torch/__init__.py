"""ray_tpu_torch — the PyTorch/CUDA port of ``ray_tpu``.

A package of its own beside the JAX one: it imports ``torch`` and never
``jax`` or anything of ``ray_tpu`` (what it needs from there it keeps its
own copy of). Module names follow the JAX package so every counterpart is
found at the same path:

- ``ops/``        — layers, flash attention, the fused lm-head loss, paged
  KV ops, sampling and the attention dispatchers over the hand-written
  Hopper kernels (``csrc/*.cu``, built at first use by ``_build.py``)
- ``models/gpt.py`` — the GPT-2 family's training and KV-cached serving
  paths
- ``benchmarks/gpt_mfu.py`` — GPT train steps: tokens/s and MFU
- ``convert.py``  — the JAX parameter tree into the port's weights
- ``serve/llm/``  — paged KV cache, single-device executor, the
  continuous-batching ``LLMEngine``

Entry points run on ``cuda:0`` unless the caller passes ``device="cpu"``;
with no CUDA device and no explicit device they raise (``_device.py``).
"""
from __future__ import annotations

from ray_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
