"""Paged KV-cache manager: preallocated block pool + per-sequence block
tables (counterpart of ``ray_tpu/serve/llm/kv_cache.py`` without its
prefix cache, host tier and quarantine).

The pool is ONE tensor pair on the device,

    k, v: [n_layer, num_blocks, block_size, n_kv_head, head_dim]

and sequences own lists of physical block ids in logical-position order.
Block 0 is the garbage sink for padding writes, so the allocator hands
out blocks [1, num_blocks). Admission reserves a sequence's worst-case
block count (prompt + max_new_tokens) up front, so a running sequence never
fails a mid-flight append. The free list is LIFO: a just-freed block is
reused first.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch


@dataclass(frozen=True)
class KVCacheConfig:
    n_layer: int
    n_kv_head: int
    head_dim: int
    num_blocks: int = 64
    block_size: int = 16
    dtype: Any = torch.bfloat16
    device: Any = "cpu"

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
        shape = (
            cfg.n_layer, cfg.num_blocks, cfg.block_size,
            cfg.n_kv_head, cfg.head_dim,
        )
        self.k = torch.zeros(shape, dtype=cfg.dtype, device=cfg.device)
        self.v = torch.zeros(shape, dtype=cfg.dtype, device=cfg.device)
        self._free: list[int] = list(range(1, cfg.num_blocks))
        self._tables: dict[Any, list[int]] = {}
        self._reserved = 0
        # bumped whenever a sequence's table changes — lets the engine
        # cache host-side numpy tables
        self._versions: dict[Any, int] = {}

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
            appended += 1
        if appended:
            self._versions[seq_id] += 1
        return appended

    def free(self, seq_id) -> int:
        """Return a finished sequence's blocks to the free list; -> count."""
        table = self._tables.pop(seq_id)
        self._versions.pop(seq_id, None)
        self._free.extend(reversed(table))  # LIFO: newest block reused first
        return len(table)

    def release_all(self) -> int:
        """Free every sequence and drop all reservations (shutdown and
        failure path); -> blocks returned."""
        returned = sum(self.free(s) for s in list(self._tables))
        self._reserved = 0
        return returned

    # ---------------- views ----------------

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
