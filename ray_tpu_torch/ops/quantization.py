"""Quantized serving primitives: int8 / fp8-e4m3 weights and paged KV
(counterpart of ``ray_tpu/ops/quantization.py``).

Two carriers hold a (data, scale) pair:

- ``QuantizedTensor``: a weight. ``data`` holds the low-precision values
  and ``scale`` a broadcast-ready per-channel f32 factor (amax over the
  contraction axis, keepdims). ``.to(dtype)`` IS the dequant, computed in
  ``dtype`` as the JAX ``astype`` does, so the model's ``w.to(x.dtype)``
  at every use dequantizes and no dequantized copy is ever kept.
- ``QuantizedKV``: one side (k or v) of the paged pool. ``data`` is
  ``[..., block_size, n_kv_head, head_dim]`` and ``scale`` the f32 plane
  ``data.shape[:-1]``, one factor per written (slot, kv head), which is
  the write granularity of ``ops/kv_cache.scatter_kv``: a decode append
  never re-quantizes a block. Leading-axis indexing slices both, so
  ``cache.k[layer]`` is a view of one layer's data and scales.

Quantization is symmetric with no zero point: int8 uses s = amax / 127
and rounds half to even (``torch.round``, as ``jnp.round``), fp8-e4m3
uses s = amax / 448 and the dtype cast's own rounding; an all-zero row
gets a unit scale. These rules give the JAX package's data and scales
bit for bit.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

QUANT_KINDS = ("int8", "fp8")
_QMAX = {"int8": 127.0, "fp8": 448.0}  # e4m3fn saturates at +-448
_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def resolve_quantization(kind: Any) -> str | None:
    """Normalize the ``quantization`` knob: None / "" -> None (unquantized
    serving), "int8" | "fp8" pass through, anything else raises: a typo
    never falls back to unquantized serving."""
    if kind is None or kind == "":
        return None
    if kind not in QUANT_KINDS:
        raise ValueError(
            f"quantization must be one of {QUANT_KINDS} or None, got {kind!r}"
        )
    return kind


def quant_dtype(kind: str) -> torch.dtype:
    """Storage dtype of a quantization kind."""
    return _DTYPES[kind]


def quant_max(kind: str) -> float:
    return _QMAX[kind]


def quant_kind(dtype: torch.dtype) -> str:
    """The kind whose storage dtype is ``dtype``."""
    for kind, dt in _DTYPES.items():
        if dt == dtype:
            return kind
    raise TypeError(f"{dtype} is not a quantized storage dtype")


class QuantizedTensor:
    """A quantized weight: low-precision ``data`` and a per-channel f32
    ``scale`` of the same rank (size 1 on every axis but the channel
    axis). ``.to(dtype)`` is the dequant."""

    __slots__ = ("data", "scale")

    def __init__(self, data: torch.Tensor, scale: torch.Tensor):
        self.data = data
        self.scale = scale

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    def to(self, dtype: torch.dtype) -> torch.Tensor:
        """``data * scale`` computed in ``dtype`` (JAX ``astype``)."""
        return self.data.to(dtype) * self.scale.to(dtype)

    def rows(self, idx) -> "QuantizedTensor":
        """Rows ``idx`` of data and scale (an embedding gather; dequant of
        the gathered rows equals the gather of the dequantized table)."""
        return QuantizedTensor(self.data[idx], self.scale[idx])

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.data, self.scale))


class QuantizedKV:
    """One side of a quantized paged KV pool: ``data`` in int8 or
    fp8-e4m3 and the f32 ``scale`` plane ``data.shape[:-1]``."""

    __slots__ = ("data", "scale")

    def __init__(self, data: torch.Tensor, scale: torch.Tensor):
        self.data = data
        self.scale = scale

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def ndim(self):
        return self.data.dim()

    def __getitem__(self, idx):
        # leading-axis indexing only: head_dim exists on data, not on scale
        return QuantizedKV(self.data[idx], self.scale[idx])

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.data, self.scale))


def stack_blocks(blocks: list, axis: int = 1):
    """``np.stack`` over per-block payloads, plain arrays or
    ``QuantizedKV`` records of numpy leaves (data and scale planes
    stacked alike): the host-side landing paths stack them into one
    operand."""
    first = blocks[0]
    if isinstance(first, QuantizedKV):
        return QuantizedKV(np.stack([b.data for b in blocks], axis=axis),
                           np.stack([b.scale for b in blocks], axis=axis))
    return np.stack(blocks, axis=axis)


def _scale(amax: torch.Tensor, kind: str) -> torch.Tensor:
    return torch.where(amax > 0.0, amax, torch.ones_like(amax)) / quant_max(kind)


def _cast(scaled: torch.Tensor, kind: str) -> torch.Tensor:
    qmax = quant_max(kind)
    scaled = scaled.clamp(-qmax, qmax)
    if kind == "int8":
        return torch.round(scaled).to(torch.int8)
    return scaled.to(torch.float8_e4m3fn)


def quantize_kv(x: torch.Tensor, kind: str):
    """Quantize fresh K or V values at write granularity: amax over the
    trailing head_dim axis -> (data ``x.shape`` in the kind's dtype,
    scale ``x.shape[:-1]`` f32)."""
    xf = x.float()
    scale = _scale(xf.abs().amax(dim=-1), kind)
    return _cast(xf / scale[..., None], kind), scale


def quantize_weight(w: torch.Tensor, axis: int, kind: str) -> QuantizedTensor:
    """Per-channel weight quantization: amax over the contraction axis
    (keepdims), so the scale attaches to output channels."""
    wf = w.float()
    scale = _scale(wf.abs().amax(dim=axis, keepdim=True), kind)
    return QuantizedTensor(_cast(wf / scale, kind), scale)


def quantize_params(params: dict, axes: dict, kind: str) -> dict:
    """Quantize a dict of weights (nested dicts allowed) per a dict of
    the same keys whose values are each weight's amax reduction axis, or
    -1 (or a missing key) to keep the weight in full precision. Weights
    that are already quantized are kept as they are."""
    kind = resolve_quantization(kind)
    if kind is None:
        return params
    out = {}
    for name, w in params.items():
        axis = axes.get(name, -1)
        if isinstance(w, dict):
            out[name] = quantize_params(w, axis if isinstance(axis, dict)
                                        else {}, kind)
        elif isinstance(w, QuantizedTensor) or axis is None or axis < 0:
            out[name] = w
        else:
            out[name] = quantize_weight(w, int(axis), kind)
    return out
