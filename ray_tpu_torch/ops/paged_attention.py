"""Paged-attention dispatchers and the wrappers of the two CUDA kernels
(counterpart of ``ray_tpu/ops/paged_attention.py``).

- ``paged_attention_cuda`` launches ``csrc/paged_decode.cu`` (kernel B4,
  replacing ``_paged_decode_kernel``): one query token per sequence.
- ``paged_prefill_attention_cuda`` launches ``csrc/paged_prefill.cu``
  (kernel B5, replacing ``_paged_prefill_kernel``): a chunk of queries at
  true positions, optional sliding window.

Both take the same arguments as their plain versions in
``ops/kv_cache.py``. A wrapper checks device, dtype, shape and contiguity
(not the block ids in the tables, which would cost a device sync: they
must lie in the pool),
allocates the output with ``torch.empty``, launches on the current stream
and raises if the launch returns a CUDA error; it never falls back to the
plain version. Each counts its launches in ``LAUNCHES``.

``decode_attention`` / ``prefill_attention`` are what the model calls.
Their ``backend`` knob is ``auto | torch | cuda``; ``auto`` picks the
kernel for a CUDA tensor and the plain version for a CPU tensor.
"""
from __future__ import annotations

import math

import torch

from ray_tpu_torch import _build
from ray_tpu_torch._device import resolve_backend
from ray_tpu_torch.ops.attention import LOG2E
from ray_tpu_torch.ops.kv_cache import paged_attention, paged_prefill_attention

# launches of each kernel by its wrapper — a run resets these to 0 and
# reads them to show which kernels its path went through
LAUNCHES = {"paged_decode": 0, "paged_prefill": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name, q, k_layer, v_layer, block_tables, positions, q_dims):
    tensors = (q, k_layer, v_layer, block_tables, positions)
    if not all(t.is_cuda for t in tensors):
        raise ValueError(
            f"{name} runs only on CUDA tensors, got devices "
            f"{[str(t.device) for t in tensors]}"
        )
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: all tensors must be on one device")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: q must be float32 or bfloat16, got {q.dtype}")
    if k_layer.dtype != q.dtype or v_layer.dtype != q.dtype:
        raise TypeError(
            f"{name}: pool dtype {k_layer.dtype}/{v_layer.dtype} != q {q.dtype}"
        )
    if block_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError(f"{name}: block tables and positions must be int32")
    if q.dim() != q_dims or k_layer.dim() != 4 or k_layer.shape != v_layer.shape:
        raise ValueError(
            f"{name}: bad shapes q {tuple(q.shape)}, pool "
            f"{tuple(k_layer.shape)}/{tuple(v_layer.shape)}"
        )
    hd, Hq = q.shape[-1], q.shape[-2]
    _, bs, Hkv, hd_pool = k_layer.shape
    if hd_pool != hd or Hq % Hkv or hd % 8 or hd > 256:
        raise ValueError(
            f"{name}: head_dim {hd} (pool {hd_pool}) must be a multiple of 8 "
            f"up to 256 and query heads {Hq} a multiple of kv heads {Hkv}"
        )
    B = q.shape[0]
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"{name}: block tables must be [B, NB], B = {B}")
    pos_shape = tuple(q.shape[: q_dims - 2])  # [B] or [B, S]
    if tuple(positions.shape) != pos_shape:
        raise ValueError(
            f"{name}: positions {tuple(positions.shape)} != {pos_shape}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: all tensors must be contiguous")


def paged_attention_cuda(
    q: torch.Tensor,
    k_layer: torch.Tensor,
    v_layer: torch.Tensor,
    block_tables: torch.Tensor,
    positions: torch.Tensor,
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Decode attention through kernel B4; same contract as
    ``ops/kv_cache.paged_attention``."""
    _check("paged_decode", q, k_layer, v_layer, block_tables, positions, 3)
    B, Hq, hd = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    _, bs, Hkv, _ = k_layer.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    fn = _build.bind("paged_decode", "paged_decode", "p" * 6 + "i" * 6 + "fip")
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), k_layer.data_ptr(), v_layer.data_ptr(),
            block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, hd, bs, block_tables.shape[1],
            scale * LOG2E, _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.raise_on("paged_decode", "paged_decode", rc)
    LAUNCHES["paged_decode"] += 1
    return out


def paged_prefill_attention_cuda(
    q: torch.Tensor,
    k_layer: torch.Tensor,
    v_layer: torch.Tensor,
    block_tables: torch.Tensor,
    positions: torch.Tensor,
    *,
    scale: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Multi-token attention through kernel B5; same contract as
    ``ops/kv_cache.paged_prefill_attention``."""
    _check("paged_prefill", q, k_layer, v_layer, block_tables, positions, 4)
    B, S, Hq, hd = q.shape
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    _, bs, Hkv, _ = k_layer.shape
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    fn = _build.bind("paged_prefill", "paged_prefill",
                     "p" * 6 + "i" * 7 + "fiip")
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), k_layer.data_ptr(), v_layer.data_ptr(),
            block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            B, S, Hq, Hkv, hd, bs, block_tables.shape[1],
            scale * LOG2E, window or 0, _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.raise_on("paged_prefill", "paged_prefill", rc)
    LAUNCHES["paged_prefill"] += 1
    return out


def decode_attention(q, k_layer, v_layer, block_tables, positions, *,
                     scale=None, backend="auto"):
    """Decode attention through the backend ``backend`` resolves to."""
    if resolve_backend(backend, q) == "cuda":
        return paged_attention_cuda(
            q, k_layer, v_layer, block_tables, positions, scale=scale
        )
    return paged_attention(
        q, k_layer, v_layer, block_tables, positions, scale=scale
    )


def prefill_attention(q, k_layer, v_layer, block_tables, positions, *,
                      scale=None, backend="auto", window=None):
    """Multi-token paged attention through the backend ``backend``
    resolves to."""
    if resolve_backend(backend, q) == "cuda":
        return paged_prefill_attention_cuda(
            q, k_layer, v_layer, block_tables, positions,
            scale=scale, window=window,
        )
    return paged_prefill_attention(
        q, k_layer, v_layer, block_tables, positions,
        scale=scale, window=window,
    )
