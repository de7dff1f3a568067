"""Paged-attention dispatchers and the wrappers of the two CUDA kernels
(counterpart of ``ray_tpu/ops/paged_attention.py``).

- ``paged_attention_cuda`` launches ``csrc/paged_decode.cu`` (kernel B4,
  replacing ``_paged_decode_kernel``): one query token per sequence, as
  split-K flash-decoding in one launch. Each sequence's table is split
  into ``decode_splits(...)`` ranges, one block each, combined inside the
  launch by a thread-block cluster; the count comes from shapes and the
  card's SM count alone, so a call costs no device sync.
- ``paged_prefill_attention_cuda`` launches ``csrc/paged_prefill.cu``
  (kernel B5, replacing ``_paged_prefill_kernel``): a chunk of queries at
  true positions, optional sliding window. A bf16 q with head_dim up to
  128 runs on the tensor cores; an f32 q, and a bf16 q with head_dim
  129-256, run the CUDA-core walk.

Heads above 256 run both kernels' column-chunked walk
(``csrc/paged_common.cuh`` ``attend_wide``): a block per 256 output
columns, its scores summed over the whole head in slices of 256 (B4 keeps
its split-K clusters and combines per chunk).

Both take the same arguments as their plain versions in
``ops/kv_cache.py``, any head dim: a pool is held at
``pool_head_dim`` (16-byte rows), and where that is wider than q's head
dim the wrapper zero-pads q to it, launches at the scale of the true head
dim and slices the output back. A pool of ``QuantizedKV`` layers (int8 or fp8-e4m3
data, f32 scales ``data.shape[:-1]``) launches the quantized variant of
the same kernel, counted under ``<kernel>_int8`` / ``<kernel>_fp8``.
A wrapper checks device, dtype, shape and contiguity
(not the block ids in the tables, which would cost a device sync: they
must lie in the pool),
allocates the output with ``torch.empty``, launches on the current stream
and raises if the launch returns a CUDA error; it never falls back to the
plain version. Each counts its launches in ``LAUNCHES``: a call that
launches its kernel now, not one recorded into a CUDA graph under
capture (the graph's replays launch it without the wrapper, and a trace
of the device counts those: ``benchmarks/engine_profile.paged_launches``).
B4's wrapper also keeps the split count it last launched with in
``SPLITS``.

``decode_attention`` / ``prefill_attention`` are what the model calls.
Their ``backend`` knob is ``auto | torch | cuda``; ``auto`` picks the
kernel for a CUDA tensor and the plain version for a CPU tensor.
"""
from __future__ import annotations

import functools
import math

import torch

from ray_tpu_torch import _build
from ray_tpu_torch._device import resolve_backend
from ray_tpu_torch.ops.attention import LOG2E
from ray_tpu_torch.ops.kv_cache import (
    pad_head,
    paged_attention,
    paged_prefill_attention,
    pool_head_dim,
)
from ray_tpu_torch.ops.quantization import QuantizedKV

# launches of each kernel by its wrapper, outside graph captures — a run
# resets these to 0 and reads them to show which kernels its path went
# through
LAUNCHES = {"paged_decode": 0, "paged_decode_int8": 0, "paged_decode_fp8": 0,
            "paged_prefill": 0, "paged_prefill_int8": 0,
            "paged_prefill_fp8": 0}

# the split count of B4's last launch, by LAUNCHES key
SPLITS = {name: 0 for name in LAUNCHES if name.startswith("paged_decode")}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# B4's split-K: at most a portable thread-block cluster of ranges (the C
# entry refuses more: kMaxSplits in csrc/paged_decode.cu is this number),
# enough blocks for a few per SM of the card, and ranges of at least 64
# tokens (a shorter range saves less than the cluster's barriers and
# combine cost)
DECODE_MAX_SPLITS = 8
DECODE_BLOCKS_PER_SM = 4
DECODE_MIN_SPLIT_TOKENS = 64
# pool storage codes of the C entry points: 0 = q's dtype, else quantized
_KV_CODES = {torch.int8: (1, "_int8"), torch.float8_e4m3fn: (2, "_fp8")}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _launched(key: str) -> None:
    """Count a launch under ``key``, unless the current stream is being
    captured into a CUDA graph: then nothing launched."""
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES[key] += 1


def decode_splits(B: int, Hkv: int, NB: int, block_size: int,
                  num_sms: int) -> int:
    """Ranges of table entries B4 splits each (sequence, kv head) into on a
    card of ``num_sms`` SMs: the smallest power of two that gives
    ``DECODE_BLOCKS_PER_SM`` blocks an SM, at most ``DECODE_MAX_SPLITS``,
    one table entry and ``DECODE_MIN_SPLIT_TOKENS`` tokens a range. Shapes
    only, never the positions."""
    target = DECODE_BLOCKS_PER_SM * num_sms
    n = 1
    while (2 * n <= DECODE_MAX_SPLITS and B * Hkv * n < target
           and 2 * n <= NB
           and NB * block_size >= 2 * n * DECODE_MIN_SPLIT_TOKENS):
        n *= 2
    return n


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """SMs of CUDA card ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(name, q, k_layer, v_layer, block_tables, positions, q_dims):
    """Validate the launch; returns (the LAUNCHES key, the pool's kv code,
    the k, v, k-scale and v-scale pointers; no scales -> None)."""
    quant = isinstance(k_layer, QuantizedKV)
    if quant != isinstance(v_layer, QuantizedKV):
        raise TypeError(f"{name}: k and v must both be quantized or neither")
    scales = None
    if quant:
        if k_layer.dtype not in _KV_CODES or v_layer.dtype != k_layer.dtype:
            raise TypeError(
                f"{name}: quantized pool must be int8 or float8_e4m3fn, got "
                f"{k_layer.dtype}/{v_layer.dtype}"
            )
        for layer in (k_layer, v_layer):
            if (layer.scale.dtype != torch.float32
                    or layer.scale.shape != layer.data.shape[:-1]):
                raise ValueError(
                    f"{name}: scale plane must be float32 of shape "
                    f"{tuple(layer.data.shape[:-1])}, got "
                    f"{layer.scale.dtype} {tuple(layer.scale.shape)}"
                )
        scales = (k_layer.scale, v_layer.scale)
        code, suffix = _KV_CODES[k_layer.dtype]
        k_layer, v_layer = k_layer.data, v_layer.data
    else:
        code, suffix = 0, ""
    tensors = (q, k_layer, v_layer, block_tables, positions) + (scales or ())
    if not all(t.is_cuda for t in tensors):
        raise ValueError(
            f"{name} runs only on CUDA tensors, got devices "
            f"{[str(t.device) for t in tensors]}"
        )
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: all tensors must be on one device")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: q must be float32 or bfloat16, got {q.dtype}")
    if not quant and (k_layer.dtype != q.dtype or v_layer.dtype != q.dtype):
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
    if hd_pool != pool_head_dim(hd, quant) or Hq % Hkv:
        raise ValueError(
            f"{name}: head_dim {hd} must be held in a pool of head dim "
            f"pool_head_dim({hd}) = {pool_head_dim(hd, quant)} (got "
            f"{hd_pool}; the kernels copy rows in 16-byte pieces), and query "
            f"heads {Hq} a multiple of kv heads {Hkv}"
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
    if any(t.data_ptr() % 16 for t in (q, k_layer, v_layer)):
        raise ValueError(
            f"{name}: q and the pool must start on a 16-byte boundary (the "
            f"kernels copy them in 16-byte pieces)"
        )
    ks, vs = (t.data_ptr() for t in scales) if scales else (None, None)
    return name + suffix, code, (k_layer.data_ptr(), v_layer.data_ptr(), ks, vs)


def paged_attention_cuda(
    q: torch.Tensor,
    k_layer: torch.Tensor,
    v_layer: torch.Tensor,
    block_tables: torch.Tensor,
    positions: torch.Tensor,
    *,
    scale: float | None = None,
    nsplit: int | None = None,
) -> torch.Tensor:
    """Decode attention through kernel B4; same contract as
    ``ops/kv_cache.paged_attention``. ``nsplit`` (1-8) overrides the split
    count ``decode_splits`` picks, for measuring the choice."""
    key, code, pool = _check("paged_decode", q, k_layer, v_layer,
                             block_tables, positions, 3)
    B, Hq, hd = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    _, bs, Hkv, hd_pool = k_layer.shape
    if hd_pool != hd:  # a padded pool: q padded to it, at the true scale
        out = paged_attention_cuda(pad_head(q, hd_pool), k_layer, v_layer,
                                   block_tables, positions, scale=scale,
                                   nsplit=nsplit)
        return out[..., :hd].contiguous()
    out = torch.empty_like(q)
    if B == 0:
        return out
    NB = block_tables.shape[1]
    if nsplit is None:
        nsplit = decode_splits(B, Hkv, NB, bs, sm_count(q.device.index))
    fn = _build.bind("paged_decode", "paged_decode",
                     "p" * 8 + "i" * 7 + "fiip")
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), *pool,
            block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, hd, bs, NB, nsplit,
            scale * LOG2E, _DTYPE_CODES[q.dtype], code,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.raise_on("paged_decode", key, rc)
    _launched(key)
    SPLITS[key] = nsplit
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
    key, code, pool = _check("paged_prefill", q, k_layer, v_layer,
                             block_tables, positions, 4)
    B, S, Hq, hd = q.shape
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    _, bs, Hkv, hd_pool = k_layer.shape
    if hd_pool != hd:  # a padded pool: q padded to it, at the true scale
        out = paged_prefill_attention_cuda(
            pad_head(q, hd_pool), k_layer, v_layer, block_tables, positions,
            scale=scale, window=window)
        return out[..., :hd].contiguous()
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    fn = _build.bind("paged_prefill", "paged_prefill",
                     "p" * 8 + "i" * 7 + "fiiip")
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), *pool,
            block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            B, S, Hq, Hkv, hd, bs, block_tables.shape[1],
            scale * LOG2E, window or 0, _DTYPE_CODES[q.dtype], code,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.raise_on("paged_prefill", key, rc)
    _launched(key)
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
