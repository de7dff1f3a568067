"""Paged KV-cache manager: preallocated block pool + per-sequence block
tables and the dispatch-ahead quarantine (counterpart of
``ray_tpu/serve/llm/kv_cache.py`` without its prefix cache and host tier).

The pool is ONE tensor pair on the device,

    k, v: [n_layer, num_blocks, block_size, n_kv_head, pool_head_dim]

(``pool_head_dim`` is the head dim rounded up to a 16-byte row, the same
for every aligned head dim; ``ops/kv_cache.py``) and sequences own lists of physical block ids in logical-position order.
Block 0 is the garbage sink for padding writes, so the allocator hands
out blocks [1, num_blocks). With ``quantization`` set, each side of the
pool is a ``QuantizedKV``: int8 or fp8-e4m3 data of that shape and an f32
scale plane ``[n_layer, num_blocks, block_size, n_kv_head]``, one scale
per written (slot, kv head). Admission reserves a sequence's worst-case
block count (prompt + max_new_tokens) up front, so a running sequence never
fails a mid-flight append. The free list is LIFO: a just-freed block is
reused first.

Blocks freed while a decode step is still in flight (the engine's lag-1
pipeline) can park in a quarantine instead of the free list, until the
engine's next token sync proves that the step has executed
(``free(..., quarantine=True)``, ``flush_quarantine``). The port's one
CUDA stream already orders a later write to a reused block after the
step; the quarantine keeps the reference's host bookkeeping and its
exactly-once accounting (``debug_snapshot``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ray_tpu_torch.ops.kv_cache import pool_head_dim
from ray_tpu_torch.ops.quantization import (
    QuantizedKV,
    quant_dtype,
    resolve_quantization,
)


@dataclass(frozen=True)
class KVCacheConfig:
    n_layer: int
    n_kv_head: int
    head_dim: int
    num_blocks: int = 64
    block_size: int = 16
    dtype: Any = torch.bfloat16
    device: Any = "cpu"
    quantization: str | None = None  # int8 | fp8: a QuantizedKV pool

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1  # block 0 is the garbage sink

    def blocks_for(self, num_tokens: int) -> int:
        return -(-num_tokens // self.block_size)  # ceil


class PagedKVCache:
    """Host-side block accounting + the device pool tensors. Not
    thread-safe by itself: the engine serializes access under its lock."""

    def __init__(self, cfg: KVCacheConfig):
        self.cfg = cfg
        kind = resolve_quantization(cfg.quantization)
        shape = (
            cfg.n_layer, cfg.num_blocks, cfg.block_size,
            cfg.n_kv_head, pool_head_dim(cfg.head_dim, kind is not None),
        )
        if kind is not None:
            def side():
                # zeroed as bytes, then viewed in the kind's dtype
                data = torch.zeros(shape, dtype=torch.uint8, device=cfg.device)
                scale = torch.zeros(shape[:-1], dtype=torch.float32,
                                    device=cfg.device)
                return QuantizedKV(data.view(quant_dtype(kind)), scale)

            self.k, self.v = side(), side()
        else:
            self.k = torch.zeros(shape, dtype=cfg.dtype, device=cfg.device)
            self.v = torch.zeros(shape, dtype=cfg.dtype, device=cfg.device)
        self._free: list[int] = list(range(1, cfg.num_blocks))
        # blocks freed while a device step was in flight: they return to
        # the free list at the engine's next token sync (flush_quarantine)
        self._quarantine: list[int] = []
        self._tables: dict[Any, list[int]] = {}
        self._reserved = 0
        self._allocated_total = 0  # blocks ever drawn from the free list
        self._freed_total = 0      # blocks ever returned by free()
        # bumped whenever a sequence's table changes — lets the engine
        # cache host-side numpy tables
        self._versions: dict[Any, int] = {}

    def nbytes(self) -> int:
        """Device bytes of the pool, both sides (scales included)."""
        return sum(t.nbytes() if isinstance(t, QuantizedKV)
                   else t.numel() * t.element_size() for t in (self.k, self.v))

    # ---------------- reservation (admission control) ----------------

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def reserved_blocks(self) -> int:
        return self._reserved

    def can_reserve(self, n_blocks: int) -> bool:
        return n_blocks <= len(self._free) - self._reserved

    def reserve(self, n_blocks: int) -> None:
        if not self.can_reserve(n_blocks):
            raise RuntimeError(
                f"cannot reserve {n_blocks} blocks: {len(self._free)} free, "
                f"{self._reserved} already reserved"
            )
        self._reserved += n_blocks

    def release_reservation(self, n_blocks: int) -> None:
        if n_blocks > self._reserved:
            raise RuntimeError("reservation accounting went negative")
        self._reserved -= n_blocks

    # ---------------- allocate / append / free ----------------

    def allocate(self, seq_id) -> None:
        """Register a sequence with an empty block table."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already allocated")
        self._tables[seq_id] = []
        self._versions[seq_id] = 0

    def ensure_capacity(self, seq_id, num_tokens: int) -> int:
        """Append blocks, drawn from the sequence's reservation, until it
        can hold ``num_tokens``; returns the number appended."""
        table = self._tables[seq_id]
        appended = 0
        while len(table) * self.cfg.block_size < num_tokens:
            if not self._free:
                raise RuntimeError(
                    "KV block pool exhausted — reservation accounting bug"
                )
            table.append(self._free.pop())
            self._reserved -= 1
            self._allocated_total += 1
            appended += 1
        if appended:
            self._versions[seq_id] += 1
        return appended

    def free(self, seq_id, *, quarantine: bool = False) -> int:
        """Return a finished sequence's blocks to the free list, or with
        ``quarantine`` (a decode step is in flight) to the quarantine until
        ``flush_quarantine``; -> count."""
        table = self._tables.pop(seq_id)
        self._versions.pop(seq_id, None)
        # LIFO: newest block reused first
        (self._quarantine if quarantine else self._free).extend(
            reversed(table))
        self._freed_total += len(table)
        return len(table)

    def flush_quarantine(self) -> int:
        """Move quarantined blocks to the free list; -> count. The engine
        calls it right after a token sync, which proves that every step
        dispatched before it has executed."""
        n = len(self._quarantine)
        self._free.extend(self._quarantine)
        self._quarantine.clear()
        return n

    def release_all(self) -> int:
        """Free every sequence, empty the quarantine and drop all
        reservations (shutdown and failure path); -> blocks returned."""
        returned = sum(self.free(s) for s in list(self._tables))
        self.flush_quarantine()
        self._reserved = 0
        return returned

    # ---------------- views ----------------

    @property
    def used_blocks(self) -> int:
        """Blocks held by live tables or quarantined."""
        return self.cfg.usable_blocks - len(self._free)

    def debug_snapshot(self) -> dict:
        """JSON-safe accounting of the block pool (the reference's keys
        that this cache has)."""
        return {
            "num_blocks": self.cfg.num_blocks,
            "block_size": self.cfg.block_size,
            "used_blocks": self.used_blocks,
            "free_blocks": len(self._free),
            "quarantined_blocks": len(self._quarantine),
            "reserved_blocks": self._reserved,
            "live_sequences": len(self._tables),
            "allocated_total": self._allocated_total,
            "freed_total": self._freed_total,
        }

    def block_table(self, seq_id, pad_to: int) -> np.ndarray:
        """[pad_to] int32 table, the unallocated tail padded with the
        garbage block 0 (those positions are always masked)."""
        table = self._tables[seq_id]
        if len(table) > pad_to:
            raise ValueError(
                f"sequence {seq_id!r} holds {len(table)} blocks, "
                f"table was asked to fit in {pad_to}"
            )
        out = np.zeros((pad_to,), np.int32)
        out[: len(table)] = table
        return out

    def table_version(self, seq_id) -> int:
        return self._versions[seq_id]

    def num_allocated(self, seq_id) -> int:
        return len(self._tables[seq_id])
