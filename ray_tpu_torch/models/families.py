"""The registry of model families (counterpart of
``ray_tpu/serve/llm/decode.py``'s ``FAMILIES``), importable by training
and serving alike: ``serve/llm/decode.py`` re-exports it.

Each family names its config and model classes, its seeded init, its
quantization axes, its config at full width and its speculative verify
step (``GPT.verify_step`` / ``Llama.verify_step``, as the reference
registry names ``gpt_verify_step`` / ``llama_verify_step``):

- ``gpt``: GPT-2 125M (``GPTConfig.gpt2_small()``);
- ``llama``: Llama-125M, the repo's own Llama benchmark shape
  (``docs/MICROBENCHMARKS.md:191-196``): 12 query heads on 4 kv heads,
  SwiGLU d_mlp 2048, vocab 32000, sequence 1024; 12 layers of d_model
  768 (head dim 64) from its "equal parameter count" with GPT-2 125M
  (124,668,672 parameters against GPT-2's 124,475,904). It is built from
  ``LlamaConfig``'s fields: the JAX config has no constructor for it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

from ray_tpu_torch.models import gpt, llama


def _llama_125m() -> llama.LlamaConfig:
    return dataclasses.replace(
        llama.LlamaConfig(), vocab_size=32000, max_seq_len=1024, n_layer=12,
        n_head=12, n_kv_head=4, d_model=768, d_mlp=2048)


@dataclass(frozen=True)
class Family:
    """One model family: its config class (whose ``tiny()`` is the
    engine's default), model class, seeded init ``(cfg, seed, device)``,
    per-weight quantization axes ``(cfg) -> dict``, its config at full
    width ``() -> config`` and its verify step ``(model, cache_k,
    cache_v, tokens, starts, draft_len, block_tables, sample=None)``."""

    config: type
    model: type
    init: Callable
    quant_axes: Callable
    full: Callable
    verify_step: Callable


FAMILIES = {
    "gpt": Family(gpt.GPTConfig, gpt.GPT, gpt.gpt_init, gpt.gpt_quant_axes,
                  gpt.GPTConfig.gpt2_small, gpt.GPT.verify_step),
    "llama": Family(llama.LlamaConfig, llama.Llama, llama.llama_init,
                    llama.llama_quant_axes, _llama_125m,
                    llama.Llama.verify_step),
}


def family(name: str) -> Family:
    """The registered family ``name``; an unknown name raises."""
    if name not in FAMILIES:
        raise ValueError(f"unknown model family {name!r}; expected one of "
                         f"{sorted(FAMILIES)}")
    return FAMILIES[name]


def family_of(model_cfg) -> str:
    """The name of the family whose config class ``model_cfg`` is."""
    for name, fam in FAMILIES.items():
        if isinstance(model_cfg, fam.config):
            return name
    raise TypeError(f"{type(model_cfg).__name__} is the config of no model "
                    f"family; expected one of {sorted(FAMILIES)}")


def kv_heads(model_cfg) -> int:
    """The kv heads a paged pool holds for ``model_cfg``: ``n_kv_head``
    (grouped-query attention), else one per query head."""
    return getattr(model_cfg, "n_kv_head", model_cfg.n_head)
