"""Preemption on the card (marked ``gpu``: skips without an NVIDIA card of
compute capability 9.0 or more): a bf16 Llama batch stream at
Llama-125M's heads (12 query heads on 4 kv heads of 64), parked on the
host KV tier under an interactive flood and resumed, samples its next
token from logits computed by B5 over the resumed chain (its cached
blocks mapped back, the tail recomputed at true positions) that are
within LOGIT_TOL of the plain backend's logits for the same chain."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_kernels import cuda  # noqa: F401 — cuda is a fixture

pytestmark = pytest.mark.gpu

LOGIT_TOL = 0.1  # chip_smoke.py's bar for logits of two bf16 paths
PRESSURE = dict(kv_pressure=0.5, queue_wait_s=1e6, resume_pressure=0.4,
                aging_s=1e6)


def _engine(device):
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    cfg = LlamaConfig(vocab_size=512, max_seq_len=256, n_layer=2, n_head=12,
                      n_kv_head=4, d_model=768, d_mlp=512,
                      dtype=torch.bfloat16)
    return LLMEngine(EngineConfig(model_config=cfg, num_blocks=24,
                                  block_size=16, host_cache_bytes=1 << 24,
                                  preemption=dict(PRESSURE), device=device),
                     auto_step=False)


def resumed_logits(device):
    """Park a batch stream under a flood, capture the logits of the
    prefill call that completes its resumed chain, and the plain
    backend's logits for that chain. -> (engine, got, want)."""
    eng = _engine(device)
    model = eng.executor.model
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, 512, 40).tolist()
    batch = eng.submit(prompt, max_new_tokens=40, priority="batch")
    for _ in range(4):  # prefill, three decode steps
        eng.step()
    for i in range(6):
        eng.submit(rng.integers(0, 512, 48).tolist(),
                   max_new_tokens=(16, 32, 48)[i % 3],
                   priority="interactive", temperature=0.8, seed=100 + i)
    req, got = batch._request, []
    prefill, logits_fn = model.prefill, model._logits

    def hooked(cache_k, cache_v, tokens, lengths, tables, start=None,
               sample=None):
        chain = req.pending_resume
        row = (eng._prefilling.index(req)
               if chain is not None and req in eng._prefilling else None)
        seen = []

        def keep(h):
            seen.append(logits_fn(h))
            return seen[-1]

        model._logits = keep
        try:
            out = prefill(cache_k, cache_v, tokens, lengths, tables,
                          start=start, sample=sample)
        finally:
            del model._logits
        if row is not None and req.prefill_done + int(lengths[row]) == len(
                chain):
            got.append((list(chain), seen[0][row].float().cpu()))
        return out

    model.prefill = hooked
    while eng.step():
        pass
    del model.prefill
    assert eng.stats()["preemptions_total"] >= 1 and len(got) >= 1
    assert len(list(batch)) == 40
    chain, logits = got[0]
    plain = type(model)(dataclasses.replace(model.cfg,
                                            attention_backend="torch"),
                        model.device)
    plain.load_weights(model.weights())
    eng.cache.release_all()  # the idle pool is the plain pass's scratch
    nb = -(-len(chain) // 16)
    t = torch.tensor([chain], dtype=torch.int32, device=model.device)
    n = torch.tensor([len(chain)], dtype=torch.int32, device=model.device)
    tables = torch.arange(1, nb + 1, dtype=torch.int32,
                          device=model.device)[None, :]
    want, _, _ = plain.prefill(eng.cache.k, eng.cache.v, t, n, tables)
    return eng, logits, want[0].float().cpu()


def test_resumed_stream_logits_equal_plain_backend(cuda):
    """The first logits after the resume, B5 over the mapped chain,
    within LOGIT_TOL of the plain backend's; the resume promoted or hit
    the parked chain's blocks."""
    eng, got, want = resumed_logits(None)
    assert eng.stats()["prefix_hit_tokens"] > 0
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= LOGIT_TOL
