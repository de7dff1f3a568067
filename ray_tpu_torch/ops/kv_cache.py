"""Paged KV-cache tensor primitives (counterpart of ``ray_tpu/ops/kv_cache.py``).

One layer of the pool is ``[num_blocks, block_size, n_kv_head, head_dim]``;
sequence b's logical position p lives at
``(block_tables[b, p // block_size], p % block_size)``. Tables are int32,
padded with block 0, the garbage sink: padding writes are redirected there,
so every op below is mask-free and shape-static.

Unlike the JAX arrays, the pool is updated IN PLACE by ``write_kv`` (a
``[n_layer, ...]`` pool at GPT-2 width is far too large to copy per step).

The pool's head dim may be wider than the model's: the CUDA kernels copy
pool rows in 16-byte pieces, so a pool is allocated at ``pool_head_dim``
(the head dim rounded up to 8 elements, 16 for a 1-byte pool) and its
extra columns stay zero. ``scatter_kv`` zero-pads each written row, and
the attentions below read only q's head dim, at the scale of that true
head dim. An aligned head dim (GPT-2's 64) keeps its layout and bytes.

A quantized pool is a ``QuantizedKV`` pair per side (``ops/quantization.py``):
``scatter_kv`` quantizes each incoming (token, kv head) row and lands its
data and scale at the same (block, slot); ``gather_kv`` dequantizes the
gathered context to f32, so the two attention functions below are also
the plain versions of the quantized kernels.

``copy_blocks`` (the prefix cache's copy-on-write) and ``land_blocks``
(host-tier promotions, adopted handoffs) move whole blocks of every layer
in place, data and scale planes alike; they are XLA scatters in the JAX
package, not kernels. In place matters beyond memory: the decode CUDA
graphs (``serve/llm/decode.py``) captured the pool's addresses, so a
rebound pool would leave every later replay reading a stale one.

The attention functions here are the PLAIN versions of the two CUDA
kernels (``csrc/paged_decode.cu``, ``csrc/paged_prefill.cu``): the CPU path
of the dispatchers in ``ops/paged_attention.py``, and the yardstick the
kernels are held against on the card. Contexts of 2048 tokens and more
take a streaming path in the JAX package; ``max_seq_len`` 1024 never
reaches it, so only the dense path is ported here.
"""
from __future__ import annotations

import math

import torch

from ray_tpu_torch.ops.attention import NEG_INF
from ray_tpu_torch.ops.quantization import QuantizedKV, quant_kind, quantize_kv


def pool_head_dim(head_dim: int, quantized: bool = False) -> int:
    """Head dim a pool is allocated with: ``head_dim`` rounded up to a
    16-byte row piece (8 elements of 2 bytes or more, 16 of 1 byte)."""
    align = 16 if quantized else 8
    return -(-head_dim // align) * align


def pad_head(x: torch.Tensor, width: int) -> torch.Tensor:
    """x zero-padded along its last axis to ``width``."""
    if x.shape[-1] == width:
        return x
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def physical_slots(
    positions: torch.Tensor, block_tables: torch.Tensor, block_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Logical positions ([B] or [B, S]) -> (physical block id, slot).
    Table indices are clamped so the gather stays in bounds."""
    idx = torch.div(positions, block_size, rounding_mode="floor")
    slot = positions % block_size
    idx = idx.clamp(0, block_tables.shape[1] - 1).long()
    if positions.dim() == 1:
        blk = torch.gather(block_tables, 1, idx[:, None])[:, 0]
    else:
        blk = torch.gather(block_tables, 1, idx)
    return blk, slot


def write_kv(
    k_layer: torch.Tensor,
    v_layer: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    positions: torch.Tensor,
    block_tables: torch.Tensor,
    *,
    valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter new keys/values into one layer of the pool, in place.

    k, v: [B, H_kv, hd] with positions [B] (decode) or [B, S, H_kv, hd]
    with positions [B, S] (prefill). Rows/tokens where ``valid`` is False
    are redirected to the garbage block 0, slot 0. Returns the (updated)
    layer tensors."""
    slots = write_slots(positions, block_tables, k_layer.shape[1], valid)
    return scatter_kv(k_layer, v_layer, k, v, slots)


def write_slots(
    positions: torch.Tensor,
    block_tables: torch.Tensor,
    block_size: int,
    valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The (block, slot) index pair ``write_kv`` scatters to, padding
    redirected to block 0, slot 0. Every layer of one step writes the same
    slots, so the model computes them once per step."""
    blk, slot = physical_slots(positions, block_tables, block_size)
    if valid is not None:
        blk = torch.where(valid, blk, torch.zeros_like(blk))
        slot = torch.where(valid, slot, torch.zeros_like(slot))
    return blk.long(), slot.long()


def scatter_kv(k_layer, v_layer, k, v, slots):
    """In-place scatter of k, v into one layer at ``write_slots`` indices,
    each row zero-padded to the pool's head dim. A ``QuantizedKV`` layer
    takes each row quantized (one scale per (token, kv head); the zero
    columns leave its amax as it is), its data and scale at the same
    (block, slot)."""
    blk, slot = slots
    width = k_layer.shape[-1]
    k, v = pad_head(k, width), pad_head(v, width)
    if isinstance(k_layer, QuantizedKV):
        kind = quant_kind(k_layer.dtype)
        for layer, x in ((k_layer, k), (v_layer, v)):
            data, scale = quantize_kv(x, kind)
            # moved as bytes: index_put is defined for uint8 everywhere
            layer.data.view(torch.uint8)[blk, slot] = data.view(torch.uint8)
            layer.scale[blk, slot] = scale
        return k_layer, v_layer
    k_layer[blk, slot] = k.to(k_layer.dtype)
    v_layer[blk, slot] = v.to(v_layer.dtype)
    return k_layer, v_layer


def block_planes(side) -> list:
    """The planes of one pool side, or of a payload shaped like one
    (tensors, or numpy arrays on the host): the data, as bytes when it
    is an fp8 tensor, then a quantized side's scale plane."""
    if isinstance(side, QuantizedKV):
        data = side.data
        if data.dtype == torch.float8_e4m3fn:
            data = data.view(torch.uint8)
        return [data, side.scale]
    return [side]


def planes_nbytes(*sides) -> int:
    """The bytes of every plane of ``sides`` (``block_planes``)."""
    return sum(a.nbytes for side in sides for a in block_planes(side))


def copy_blocks(cache_k, cache_v, src: torch.Tensor, dst: torch.Tensor):
    """Clone blocks ``src`` onto ``dst`` ([P] int64, on the pool's device)
    in every layer, in place: data and scale planes in the same call.
    Pairs padded with (0, 0) copy the garbage block onto itself."""
    for side in (cache_k, cache_v):
        for a in block_planes(side):
            a.index_copy_(1, dst, a.index_select(1, src))
    return cache_k, cache_v


def land_blocks(cache_k, cache_v, blocks: torch.Tensor, k_new, v_new):
    """Write payloads ``k_new``, ``v_new`` ([n_layer, P, block_size,
    n_kv_head, head_dim], or ``QuantizedKV`` with their scale planes, on
    the pool's device) into blocks ``blocks`` ([P] int64) of every layer,
    in place. A data plane narrower than the pool's head dim is
    zero-padded to it; values of another dtype are cast to the pool's,
    as the JAX ``astype``."""
    for side, new in ((cache_k, k_new), (cache_v, v_new)):
        planes = zip(block_planes(side), block_planes(new))
        for i, (a, n) in enumerate(planes):
            if i == 0:
                n = pad_head(n, a.shape[-1])
            a.index_copy_(1, blocks, n.to(a.dtype))
    return cache_k, cache_v


def _dequant_rows(layer: QuantizedKV, idx: torch.Tensor) -> torch.Tensor:
    """Blocks ``idx`` of a quantized layer, dequantized to f32."""
    data = layer.data.view(torch.uint8)[idx].view(layer.dtype)
    return data.float() * layer.scale[idx][..., None]


def gather_kv(
    k_layer: torch.Tensor, v_layer: torch.Tensor, block_tables: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each sequence's context in position order: [B, NB * bs, H_kv, hd].
    Unallocated entries point at the garbage block; callers mask them. A
    quantized layer comes back dequantized to f32 (only the gathered
    context, never the whole pool)."""
    B, NB = block_tables.shape
    _, bs, H, hd = k_layer.shape
    idx = block_tables.long()
    if isinstance(k_layer, QuantizedKV):
        keys = _dequant_rows(k_layer, idx).reshape(B, NB * bs, H, hd)
        values = _dequant_rows(v_layer, idx).reshape(B, NB * bs, H, hd)
        return keys, values
    keys = k_layer[idx].reshape(B, NB * bs, H, hd)
    values = v_layer[idx].reshape(B, NB * bs, H, hd)
    return keys, values


def paged_prefill_attention(
    q: torch.Tensor,
    k_layer: torch.Tensor,
    v_layer: torch.Tensor,
    block_tables: torch.Tensor,
    positions: torch.Tensor,
    *,
    scale: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Multi-token attention over the pool (plain version of B5 and of
    its quantized variant).

    q: [B, S, H_q, hd], a chunk of queries whose own K/V are already
    written; positions [B, S] their true positions. Query row attends
    ``t <= position`` (and ``t > position - window`` with a window).
    The pool's head dim may be ``pool_head_dim(hd)``; its padding columns
    are not read. Returns [B, S, H_q, hd] in q.dtype."""
    B, S, Hq, hd = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    Hkv = k_layer.shape[2]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, hd)
    keys, values = gather_kv(k_layer, v_layer, block_tables)  # [B,T,Hkv,*]
    keys, values = keys[..., :hd], values[..., :hd]
    T = keys.shape[1]
    logits = torch.einsum("bshgd,bthd->bshgt", qg.float(), keys.float()) * scale
    t = torch.arange(T, device=q.device)
    pos = positions.long()
    mask = t[None, None, :] <= pos[:, :, None]  # [B, S, T]
    if window is not None:
        mask = mask & (t[None, None, :] > pos[:, :, None] - window)
    logits = logits.masked_fill(~mask[:, :, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(values.dtype)
    out = torch.einsum("bshgt,bthd->bshgd", probs, values)
    return out.reshape(B, S, Hq, hd).to(q.dtype)


def paged_attention(
    q: torch.Tensor,
    k_layer: torch.Tensor,
    v_layer: torch.Tensor,
    block_tables: torch.Tensor,
    positions: torch.Tensor,
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Single-token decode attention over the pool (plain version of B4
    and of its quantized variant).

    q: [B, H_q, hd], the current token's query after its own K/V were
    written (the mask ``t <= position`` includes self). The pool's head
    dim may be ``pool_head_dim(hd)``; its padding columns are not read.
    Returns [B, H_q, hd] in q.dtype; GQA by regrouping queries onto their
    KV head."""
    B, Hq, hd = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    keys, values = gather_kv(k_layer, v_layer, block_tables)  # [B,T,Hkv,*]
    keys, values = keys[..., :hd], values[..., :hd]
    Hkv = keys.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, hd)
    logits = torch.einsum("bhgd,bthd->bhgt", qg.float(), keys.float()) * scale
    T = keys.shape[1]
    mask = torch.arange(T, device=q.device)[None, :] <= positions.long()[:, None]
    logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(values.dtype)
    out = torch.einsum("bhgt,bthd->bhgd", probs, values)
    return out.reshape(B, Hq, hd).to(q.dtype)
