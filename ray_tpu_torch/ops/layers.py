"""Elementwise and normalization building blocks (counterpart of
``ray_tpu/ops/layers.py``). Norms compute in f32 and cast back."""
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
