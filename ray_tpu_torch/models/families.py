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

``llama_125m_moe()`` is a second config of the ``llama`` family, not a
family of its own (the JAX registry has none): Llama-125M-MoE keeps
Llama-125M's attention, embeddings and head and swaps each SwiGLU MLP
for 8 GELU experts of 768 -> 2048 -> 768, top 2 (Mixtral-8x7B's routing,
``num_local_experts`` 8, ``num_experts_per_tok`` 2), capacity factor
1.25 and aux coefficient 0.01 (``LlamaConfig``'s defaults): 370,109,184
parameters, 143,616,768 active a token.
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


def llama_125m_moe() -> llama.LlamaConfig:
    """Llama-125M-MoE (module docstring)."""
    return dataclasses.replace(_llama_125m(), num_experts=8, top_k=2)


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


# the benchmarks' model names: each a family and one of its configs at
# full width (``python -m ray_tpu_torch.benchmarks.grad_agreement --model
# llama_moe``, ``engine_profile.py --model llama_moe``)
MODELS = {"gpt": ("gpt", gpt.GPTConfig.gpt2_small),
          "llama": ("llama", _llama_125m),
          "llama_moe": ("llama", llama_125m_moe)}


def full_config(name: str) -> tuple:
    """(family name, config) of the benchmarks' model ``name``."""
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}; expected one of "
                         f"{sorted(MODELS)}")
    fam, make = MODELS[name]
    return fam, make()


def kv_heads(model_cfg) -> int:
    """The kv heads a paged pool holds for ``model_cfg``: ``n_kv_head``
    (grouped-query attention), else one per query head."""
    return getattr(model_cfg, "n_kv_head", model_cfg.n_head)
