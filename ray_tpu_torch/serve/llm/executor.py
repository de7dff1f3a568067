"""The device side of the engine (counterpart of
``ray_tpu/serve/llm/executor.py``'s ``SingleDeviceExecutor``).

The engine stages every input as numpy; the executor owns the weights
(a ``GPT`` module), the paged pool tensors (``cache.k`` / ``cache.v``,
written in place by the model) and the one device-to-host copy per step,
``_host_tokens``: the step's sampled ids, O(batch) int32, never logits.
"""
from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.models.gpt import GPT, gpt_init


def _host_tokens(tokens: torch.Tensor) -> np.ndarray:
    """THE device->host sync point on the emit path: a step's sampled
    token ids as [B] int32 numpy."""
    return tokens.to("cpu").numpy().astype(np.int32, copy=False)


class SingleDeviceExecutor:
    """One device: unsharded weights and pool. ``params`` is a state dict
    (``convert.gpt_params_from_numpy``); None draws seeded random weights
    on the device."""

    def __init__(self, model_cfg, cache, *, params: dict | None = None,
                 seed: int = 0):
        self.model_cfg = model_cfg
        self.cache = cache
        self.device = cache.k.device
        if params is None:
            self.model = gpt_init(model_cfg, seed, self.device)
        else:
            self.model = GPT(model_cfg, self.device)
            self.model.load_state_dict(params)

    def _dev(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    @staticmethod
    def _host_sample(sample: dict | None) -> dict | None:
        # sampling controls stay on the host: the all-greedy test runs
        # there, and only a sampled batch moves them to the device
        if sample is None:
            return None
        return {k: torch.as_tensor(v) for k, v in sample.items()}

    def prefill(self, tokens, lengths, tables, sample=None):
        toks, self.cache.k, self.cache.v = self.model.prefill(
            self.cache.k, self.cache.v, self._dev(tokens),
            self._dev(lengths), self._dev(tables),
            sample=self._host_sample(sample),
        )
        return toks

    def prefill_chunk(self, tokens, lengths, starts, tables, sample=None):
        toks, self.cache.k, self.cache.v = self.model.prefill(
            self.cache.k, self.cache.v, self._dev(tokens),
            self._dev(lengths), self._dev(tables), start=self._dev(starts),
            sample=self._host_sample(sample),
        )
        return toks

    def decode_step(self, tokens, positions, tables, sample=None):
        toks, self.cache.k, self.cache.v = self.model.decode_step(
            self.cache.k, self.cache.v, self._dev(tokens),
            self._dev(positions), self._dev(tables),
            sample=self._host_sample(sample),
        )
        return toks

    def sync_tokens(self, tokens_dev) -> np.ndarray:
        toks = _host_tokens(tokens_dev)
        if toks.ndim != 1:
            raise RuntimeError(f"sync path must move [B] ids, got {toks.shape}")
        return toks
