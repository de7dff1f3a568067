"""Attention reference (counterpart of ``ray_tpu/ops/attention.py``).

Only the plain formulation is ported in this slice; the flash-attention
training kernels wait for the training slice.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
LOG2E = math.log2(math.e)


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain attention. q, k, v: [B, H, S, D] (kv may have fewer heads —
    grouped-query; heads must divide). Scores and softmax in f32."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    q_heads, kv_heads = q.shape[1], k.shape[1]
    if q_heads != kv_heads:
        rep = q_heads // kv_heads
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s_q, s_k = q.shape[2], k.shape[2]
        mask = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device).tril(
            s_k - s_q
        )
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)
