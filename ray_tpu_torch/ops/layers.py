"""Elementwise and normalization building blocks (counterpart of
``ray_tpu/ops/layers.py``): layer norm and GELU for GPT, RMS norm and
rotary embedding for Llama. Norms compute in f32 and cast back."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """Layer norm over the last axis, computed in f32 and cast back."""
    out = F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(),
                       eps)
    return out.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis, computed in f32 with an f32 scale and
    cast back."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_cache(seq_len: int, head_dim: int, base: float = 10000.0,
               device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables, f32, [seq_len, head_dim // 2]. A model builds
    them once, on its device, at its ``max_seq_len``."""
    inv_freq = 1.0 / (base ** (torch.arange(0, head_dim, 2,
                                            dtype=torch.float32,
                                            device=device) / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
         positions: torch.Tensor | None = None) -> torch.Tensor:
    """Rotary embedding in the rotate-half layout (the two halves of the
    head dim), computed in f32. x: [B, S, H, hd]; cos, sin: [S, hd // 2],
    or tables indexed per row by ``positions`` [B, S]."""
    if positions is not None:
        cos, sin = cos[positions.long()], sin[positions.long()]
    c, s = cos.unsqueeze(-2), sin.unsqueeze(-2)  # [.., S, 1, hd / 2]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)
