"""Paged KV-cache manager: preallocated block pool, per-sequence block
tables, the dispatch-ahead quarantine, the block-granular prefix cache
(content-addressed blocks, copy-on-write, LRU eviction) and the host KV
tier (counterpart of ``ray_tpu/serve/llm/kv_cache.py``).

The pool is ONE tensor pair on the device,

    k, v: [n_layer, num_blocks, block_size, n_kv_head, pool_head_dim]

(``pool_head_dim`` is the head dim rounded up to a 16-byte row, the same
for every aligned head dim; ``ops/kv_cache.py``) and sequences own lists
of physical block ids in logical-position order. Block 0 is the garbage
sink for padding writes, so the allocator hands out blocks
[1, num_blocks). With ``quantization`` set, each side of the pool is a
``QuantizedKV``: int8 or fp8-e4m3 data of that shape and an f32 scale
plane ``[n_layer, num_blocks, block_size, n_kv_head]``, one scale per
written (slot, kv head). Admission reserves a sequence's worst-case
block count (prompt + max_new_tokens) up front, so a running sequence
never fails a mid-flight append. The free list is LIFO: a just-freed
block is reused first.

Prefix caching (block granularity): every FULL prompt block is
content-addressed by the chain digest of all token ids up to and
including it (``_block_key``), so a new request whose prompt shares a
prefix with earlier traffic maps the shared blocks into its table
instead of recomputing their K/V. A block is then in one of three
states:

  free        in ``_free``          no meaningful content
  referenced  refcount >= 1         mapped by one or more live tables
  cached      in ``_lru``           refcount 0 but content-addressed;
                                    resurrectable by a future hit,
                                    evicted LRU when ``_free`` runs dry

Writes never land in a content-addressed or shared block:
``prepare_write`` redirects them copy-on-write onto a fresh private
block (the device-side clone is ``ops.kv_cache.copy_blocks``).
Reservations draw uniformly from hits, appends and copies, so the
no-mid-flight-failure invariant holds; ``release_all`` also drops the
content-addressed set.

Blocks freed while a decode step is still in flight (the engine's lag-1
pipeline) park in a quarantine instead of the free list, until the
engine's next token sync proves that the step has executed
(``free(..., quarantine=True)``, ``flush_quarantine``). The port's one
CUDA stream already orders a later write to a reused block after the
step; the quarantine keeps the reference's host bookkeeping and its
exactly-once accounting (``debug_snapshot``). Content-addressed blocks
are never quarantined: they are full prompt blocks, and an in-flight
step writes only past the prompt.

Host tier (``host_cache_bytes > 0``): LRU eviction DEMOTES a full prefix
block into a host arena (``HostKVTier``) instead of discarding it. Each
entry is one RTKV record (``kv_transfer.py``: chain digest, content
digest, the k||v payload), verified again before it can land.
``peek_prefix`` / ``assign_prefix`` consult the arena after a device
miss and PROMOTE hits: the block is claimed like an append (the same
reservation accounting) and its payload queued; the engine lands the
queue as one ``land_blocks`` per dispatch window through the executor.
This module stays device-free: the device-to-host capture at demote time
goes through ``demote_fn`` (the engine installs
``executor.export_blocks``), and promotion payloads are numpy.
"""
from __future__ import annotations

import hashlib
import logging
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ray_tpu_torch._private import chaos
from ray_tpu_torch.ops.kv_cache import pool_head_dim
from ray_tpu_torch.ops.quantization import (
    QuantizedKV,
    quant_dtype,
    resolve_quantization,
)
from ray_tpu_torch.serve.llm import kv_transfer, obs
from ray_tpu_torch.util import tracing

logger = logging.getLogger("ray_tpu_torch.serve.llm")


def _block_key(prev: bytes, block_tokens) -> bytes:
    """Chain digest of one full block: blake2b-16 over the parent digest
    and the block's int64 token ids. Equal blocks at different prompt
    offsets are distinct, so a hit always means 'the same tokens from
    position 0'."""
    h = hashlib.blake2b(prev, digest_size=16)
    h.update(np.asarray(block_tokens, np.int64).tobytes())
    return h.digest()


@dataclass(frozen=True)
class KVCacheConfig:
    n_layer: int
    n_kv_head: int
    head_dim: int
    num_blocks: int = 64
    block_size: int = 16
    dtype: Any = torch.bfloat16
    device: Any = "cpu"
    # Host tier capacity in bytes; 0 disables it (eviction discards).
    # Counted in RTKV record bytes, digests included.
    host_cache_bytes: int = 0
    quantization: str | None = None  # int8 | fp8: a QuantizedKV pool

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1  # block 0 is the garbage sink

    def blocks_for(self, num_tokens: int) -> int:
        return -(-num_tokens // self.block_size)  # ceil


@dataclass
class CacheStats:
    high_water_blocks: int = 0
    allocated_total: int = 0
    freed_total: int = 0
    prefix_hit_blocks: int = 0
    prefix_hit_tokens: int = 0
    prefix_evicted_blocks: int = 0
    cow_copies: int = 0
    adopted_blocks: int = 0  # handoff blocks landed from another engine
    demoted_blocks: int = 0      # device blocks spilled into the host tier
    promoted_blocks: int = 0     # host-tier hits claimed back into the pool
    host_evicted_blocks: int = 0  # arena entries dropped to fit the byte cap
    promotion_drops: int = 0     # queued promotions invalidated before landing
    demote_drops: int = 0        # demote captures that failed (content lost)
    host_corrupt_drops: int = 0  # arena entries failing RTKV verification


class HostKVTier:
    """Host-memory arena of demoted prefix blocks: an LRU ``OrderedDict``
    keyed by chain digest whose values are one-record RTKV payloads,
    capped in bytes. Packing on the way in and verifying on the way out
    means a bit flipped while a block sat in host memory fails the
    content digest at promote time instead of reaching the pool. No
    device access and no policy: ``PagedKVCache`` decides when to demote,
    promote and verify."""

    def __init__(self, capacity_bytes: int, layout) -> None:
        self.capacity_bytes = int(capacity_bytes)
        self.layout = layout  # kv_transfer.KVLayout of the device pool
        self._wire: OrderedDict[bytes, bytes] = OrderedDict()
        self._nbytes = 0

    def __contains__(self, digest: bytes) -> bool:
        return digest in self._wire

    @property
    def blocks(self) -> int:
        return len(self._wire)

    @property
    def nbytes(self) -> int:
        return self._nbytes

    def digests(self):
        """Resident chain digests, most-recently-used first."""
        return reversed(self._wire)

    def touch(self, digest: bytes) -> None:
        if digest in self._wire:
            self._wire.move_to_end(digest)

    def put(self, digest: bytes, k_block, v_block) -> tuple[bool, int]:
        """Store one demoted block; -> (stored, entries evicted to make
        room). A record larger than the whole cap is refused; a digest
        already resident is refreshed, not packed again."""
        if digest in self._wire:
            self._wire.move_to_end(digest)
            return True, 0
        wire = kv_transfer.pack_blocks(
            self.layout, [(digest, k_block, v_block)], prefix_tokens=0
        )
        if len(wire) > self.capacity_bytes:
            return False, 0
        evicted = 0
        while self._nbytes + len(wire) > self.capacity_bytes:
            _, old = self._wire.popitem(last=False)  # oldest first
            self._nbytes -= len(old)
            evicted += 1
        self._wire[digest] = wire
        self._nbytes += len(wire)
        return True, evicted

    def get(self, digest: bytes):
        """Unpack and verify one entry -> (k_block, v_block). Raises
        ``kv_transfer.KVTransferError`` on any corruption: the caller
        treats that as a miss and ``discard``s the entry."""
        _, _, records = kv_transfer.unpack_blocks(self._wire[digest],
                                                  expect=self.layout)
        chain, k_block, v_block = records[0]
        if chain != digest:
            raise kv_transfer.KVTransferError(
                "host-tier entry chain digest mismatch")
        self._wire.move_to_end(digest)
        return k_block, v_block

    def discard(self, digest: bytes) -> None:
        wire = self._wire.pop(digest, None)
        if wire is not None:
            self._nbytes -= len(wire)

    def clear(self) -> None:
        self._wire.clear()
        self._nbytes = 0


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
        # prefix cache state
        self._ref: dict[int, int] = {}            # block -> live references
        self._lru: OrderedDict[int, None] = OrderedDict()  # refcount-0 cached
        self._hash_to_block: dict[bytes, int] = {}
        self._block_hash: dict[int, bytes] = {}
        # seq -> (chain digest so far, number of blocks hashed into it)
        self._chain: dict[Any, tuple[bytes, int]] = {}
        # bumped whenever a sequence's table changes (append, copy, prefix
        # mapping): lets the engine cache host-side numpy tables
        self._versions: dict[Any, int] = {}
        # the device-to-host capture of a demotion; the engine installs
        # executor.export_blocks when the tier is on
        self.demote_fn = None
        self.host_tier = (HostKVTier(cfg.host_cache_bytes, self.layout)
                          if cfg.host_cache_bytes > 0 else None)
        # promotions staged by assign_prefix, landed by the engine at the
        # top of its next dispatch window: (digest, block, k, v)
        self._pending_promotions: list[tuple[bytes, int, Any, Any]] = []
        # blocks claimed for promotion whose payload has not landed: their
        # device bytes are garbage, so they are never demote-exported (the
        # arena keeps the entry through the promotion)
        self._unlanded: set[int] = set()
        self.stats = CacheStats()

    @property
    def layout(self) -> kv_transfer.KVLayout:
        """The pool's layout on the wire: the model's head dim (the
        padding columns never travel) and the JAX package's dtype name."""
        c = self.cfg
        return kv_transfer.KVLayout(
            n_layer=c.n_layer, block_size=c.block_size,
            n_kv_head=c.n_kv_head, head_dim=c.head_dim,
            dtype=kv_transfer.dtype_name(self.k.dtype),
            quantization=resolve_quantization(c.quantization),
        )

    def nbytes(self) -> int:
        """Device bytes of the pool, both sides (scales included)."""
        return sum(t.nbytes() if isinstance(t, QuantizedKV)
                   else t.numel() * t.element_size() for t in (self.k, self.v))

    # ---------------- reservation (admission control) ----------------

    @property
    def free_blocks(self) -> int:
        """Blocks on the free list (cached blocks not counted)."""
        return len(self._free)

    @property
    def available_blocks(self) -> int:
        """Blocks an admission may claim: free + evictable cached."""
        return len(self._free) + len(self._lru)

    @property
    def spare_blocks(self) -> int:
        """Claimable blocks beyond outstanding reservations: the most a
        handoff landing can adopt without live admissions evicting the
        landed payloads at once."""
        return max(0, self.available_blocks - self._reserved)

    @property
    def reserved_blocks(self) -> int:
        return self._reserved

    def can_reserve(self, n_blocks: int) -> bool:
        return n_blocks <= self.available_blocks - self._reserved

    def reserve(self, n_blocks: int) -> None:
        if not self.can_reserve(n_blocks):
            raise RuntimeError(
                f"cannot reserve {n_blocks} blocks: "
                f"{self.available_blocks} available "
                f"({len(self._lru)} cached), {self._reserved} already reserved"
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
        self._chain[seq_id] = (b"", 0)
        self._versions[seq_id] = 0

    def _take_block(self, *, reserved: bool) -> int:
        """Claim one writable block: from the free list, else by evicting
        the LRU-oldest cached block (its digest entry dies; with the host
        tier on, its content demotes instead)."""
        if self._free:
            b = self._free.pop()
        elif self._lru:
            b, _ = self._lru.popitem(last=False)  # oldest first
            h = self._block_hash.pop(b)
            del self._hash_to_block[h]
            self.stats.prefix_evicted_blocks += 1
            self._demote_evicted(h, b)
        else:
            raise RuntimeError(
                "KV block pool exhausted — reservation accounting bug"
            )
        if reserved:
            self._reserved -= 1
        self.stats.allocated_total += 1
        return b

    def _high_water(self) -> None:
        self.stats.high_water_blocks = max(self.stats.high_water_blocks,
                                           self.used_blocks)

    def ensure_capacity(self, seq_id, num_tokens: int) -> int:
        """Append blocks until the sequence can hold ``num_tokens``,
        drawn from its reservation; -> blocks appended."""
        table = self._tables[seq_id]
        appended = 0
        while len(table) * self.cfg.block_size < num_tokens:
            b = self._take_block(reserved=True)
            self._ref[b] = 1
            table.append(b)
            appended += 1
        if appended:
            self._versions[seq_id] += 1
            self._high_water()
        return appended

    def _deref(self, b: int, *, quarantine: bool = False) -> None:
        self._ref[b] -= 1
        if self._ref[b] == 0:
            del self._ref[b]
            if b in self._block_hash:
                self._lru[b] = None  # cached, at the MRU end
            elif quarantine:
                self._quarantine.append(b)
            else:
                self._free.append(b)

    def free(self, seq_id, *, quarantine: bool = False) -> int:
        """Drop a finished sequence's references; -> its table length.
        Blocks shared with live sequences stay; sole-owned blocks return
        to the free list, content-addressed ones to the LRU set. With
        ``quarantine`` (a decode step is in flight) sole-owned blocks
        that are not content-addressed park in the quarantine until
        ``flush_quarantine``."""
        table = self._tables.pop(seq_id)
        self._chain.pop(seq_id, None)
        self._versions.pop(seq_id, None)
        for b in reversed(table):  # LIFO: newest block reused first
            self._deref(b, quarantine=quarantine)
        self.stats.freed_total += len(table)
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
        """Free every sequence, empty the quarantine, drop all
        reservations, the whole prefix cache and the host tier (shutdown
        and failure path); -> blocks returned. The free list is whole
        again afterwards."""
        returned = sum(self.free(s) for s in list(self._tables))
        self.flush_quarantine()
        self._free.extend(self._lru)
        self._lru.clear()
        self._hash_to_block.clear()
        self._block_hash.clear()
        self._reserved = 0
        # a promotion landing after release could write a reallocated block
        self._pending_promotions.clear()
        self._unlanded.clear()
        if self.host_tier is not None:
            self.host_tier.clear()
        return returned

    # ---------------- prefix cache ----------------

    def _chain_digests(self, tokens, n_blocks: int):
        digest = b""
        bs = self.cfg.block_size
        for i in range(n_blocks):
            digest = _block_key(digest, tokens[i * bs:(i + 1) * bs])
            yield digest

    def peek_prefix(self, tokens) -> int:
        """Number of LEADING full blocks of ``tokens`` servable without
        recompute, resident on the device or in the host tier. A pure
        lookup; a host hit that later fails verification in
        ``assign_prefix`` just shortens the assigned prefix, which the
        admission's reservation already covers."""
        hits = 0
        for digest in self._chain_digests(tokens,
                                          len(tokens) // self.cfg.block_size):
            if digest not in self._hash_to_block and not (
                self.host_tier is not None and digest in self.host_tier
            ):
                break
            hits += 1
        return hits

    def export_chain(self, tokens) -> list[tuple[bytes, int]]:
        """(chain digest, block) of each LEADING full block of ``tokens``
        resident on the device; a partial walk is a shorter, valid
        export."""
        out = []
        for digest in self._chain_digests(tokens,
                                          len(tokens) // self.cfg.block_size):
            b = self._hash_to_block.get(digest)
            if b is None:
                break
            out.append((digest, b))
        return out

    def has_digest(self, digest: bytes) -> bool:
        """Whether a chain digest is resident (referenced or cached)."""
        return digest in self._hash_to_block

    def adopt_block(self, digest: bytes) -> int | None:
        """Claim one block for a handoff landing, content-addressed under
        ``digest`` as a CACHED (refcount-0) entry: after the caller lands
        the payload there, ``assign_prefix`` hits it. None, with no side
        effect, when the digest is already resident or no block is
        claimable. ``available_blocks`` is unchanged."""
        if digest in self._hash_to_block:
            return None
        if not self._free and not self._lru:
            return None
        b = self._take_block(reserved=False)
        self._hash_to_block[digest] = b
        self._block_hash[b] = digest
        self._lru[b] = None  # MRU end: just-landed blocks evict last
        self.stats.adopted_blocks += 1
        return b

    def assign_prefix(self, seq_id, tokens,
                      max_blocks: int | None = None) -> int:
        """Map the longest servable prefix of ``tokens`` (full blocks
        only, at most ``max_blocks``) into ``seq_id``'s empty table, one
        reference and one reservation unit per block, as an append.
        Device misses are promoted from the host tier. -> prompt tokens
        covered (hits * block_size)."""
        table = self._tables[seq_id]
        if table:
            raise RuntimeError("assign_prefix requires an empty table")
        bs = self.cfg.block_size
        limit = len(tokens) // bs
        if max_blocks is not None:
            limit = min(limit, max_blocks)
        hits = 0
        digest = b""
        for nxt in self._chain_digests(tokens, limit):
            b = self._hash_to_block.get(nxt)
            if b is not None:
                if b in self._lru:  # resurrect: cached -> referenced
                    del self._lru[b]
                    self._ref[b] = 1
                else:
                    self._ref[b] += 1
                self._reserved -= 1
            else:
                # promote: claimed like an append, content-addressed at
                # once, payload staged for the engine's next landing; the
                # arena keeps its entry until the block is evicted again
                payload = self._host_lookup(nxt)
                if payload is None:
                    break
                b = self._take_block(reserved=True)
                self._ref[b] = 1
                self._hash_to_block[nxt] = b
                self._block_hash[b] = nxt
                self._pending_promotions.append((nxt, b, *payload))
                self._unlanded.add(b)
                self.stats.promoted_blocks += 1
            table.append(b)
            digest = nxt
            hits += 1
        if hits:
            self._chain[seq_id] = (digest, hits)
            self._versions[seq_id] += 1
            self.stats.prefix_hit_blocks += hits
            self.stats.prefix_hit_tokens += hits * bs
            self._high_water()
        return hits * bs

    def register_prefix(self, seq_id, tokens, upto_tokens: int) -> int:
        """Content-address ``seq_id``'s full prompt blocks whose tokens
        [0, upto_tokens) are written (the engine calls it after each
        prefill chunk). A block whose digest is already claimed (a
        concurrent identical prompt) stays private. -> blocks registered."""
        digest, hashed = self._chain[seq_id]
        table = self._tables[seq_id]
        bs = self.cfg.block_size
        nfull = min(upto_tokens // bs, len(tokens) // bs, len(table))
        registered = 0
        while hashed < nfull:
            digest = _block_key(digest, tokens[hashed * bs:(hashed + 1) * bs])
            b = table[hashed]
            if digest not in self._hash_to_block and b not in self._block_hash:
                self._hash_to_block[digest] = b
                self._block_hash[b] = digest
                registered += 1
            hashed += 1
        self._chain[seq_id] = (digest, hashed)
        return registered

    def prepare_write(self, seq_id, start_pos: int,
                      end_pos: int) -> list[tuple[int, int]]:
        """Make positions [start_pos, end_pos) of ``seq_id`` writable: an
        allocated block in that range that is shared (refcount > 1) or
        content-addressed is replaced in the table by a fresh private
        block, drawn from the sequence's reservation. -> the (src, dst)
        pairs, to be copied on the device (``ops.kv_cache.copy_blocks``)
        BEFORE the write. The source keeps its digest and its other
        readers."""
        if end_pos <= start_pos:
            return []
        table = self._tables[seq_id]
        bs = self.cfg.block_size
        hi = min(len(table) - 1, (end_pos - 1) // bs)
        pairs = []
        for idx in range(start_pos // bs, hi + 1):
            b = table[idx]
            if self._ref.get(b, 0) > 1 or b in self._block_hash:
                dst = self._take_block(reserved=True)
                self._ref[dst] = 1
                table[idx] = dst
                self._deref(b)
                pairs.append((b, dst))
                self.stats.cow_copies += 1
        if pairs:
            self._versions[seq_id] += 1
            self._high_water()
        return pairs

    # ---------------- host tier (demote / promote) ----------------

    def _demote_evicted(self, digest: bytes, block: int) -> None:
        """Spill one LRU-evicted prefix block into the host tier (nothing
        without the tier or a ``demote_fn``). A failed capture loses a
        cache entry, never correctness, so it is counted and logged, not
        raised. A block whose promotion has not landed is never exported:
        its device bytes are garbage, and the arena still holds them."""
        tier = self.host_tier
        if tier is None:
            return
        if block in self._unlanded:
            # the queued landing is stale now; the drain drops it
            self._unlanded.discard(block)
            if digest in tier:
                tier.touch(digest)
            else:
                self.stats.demote_drops += 1
                logger.warning(
                    "unlanded promoted block %d evicted after its arena "
                    "entry %s was dropped — content lost", block,
                    digest.hex())
            return
        if digest in tier:
            tier.touch(digest)  # already backed: refresh, skip the export
            return
        if self.demote_fn is None:
            return
        try:
            chaos.fire("llm.kv.demote", block=block)
            k, v = self.demote_fn([block])
            stored, evicted = tier.put(digest, k[:, 0], v[:, 0])
            if stored:
                self.stats.demoted_blocks += 1
                self.stats.host_evicted_blocks += evicted
            else:
                self.stats.demote_drops += 1
                logger.warning(
                    "host tier refused demoted block %d (record exceeds "
                    "host_cache_bytes=%d)", block, tier.capacity_bytes)
        except Exception as exc:  # noqa: BLE001 — a cache miss, not a fault
            self.stats.demote_drops += 1
            logger.warning("host-tier demotion of block %d failed: %r",
                           block, exc)

    def demote_chain(self, tokens, upto_tokens: int,
                     trace_ctx: dict | None = None) -> int:
        """Back the leading full blocks of ``tokens`` (within its first
        ``upto_tokens``) into the host tier with ONE ``demote_fn`` export
        of every block not already there (the reference's preemption
        pause path). Best-effort like every demote. -> blocks captured.
        With ``trace_ctx`` (the parked request's) the demote is a
        ``kv.demote`` span on its trace."""
        t0 = obs.wall() if trace_ctx else 0.0
        captured = self._demote_chain(tokens, upto_tokens)
        if trace_ctx:
            tracing.record_span(
                "kv.demote", trace_id=trace_ctx["trace_id"],
                parent_span_id=trace_ctx.get("parent_span_id"),
                start=t0, end=obs.wall(), kind="kv",
                attrs={"blocks": captured,
                       "upto_tokens": min(upto_tokens, len(tokens))},
            )
        return captured

    def _demote_chain(self, tokens, upto_tokens: int) -> int:
        tier = self.host_tier
        if tier is None or self.demote_fn is None:
            return 0
        todo = []
        n = min(upto_tokens, len(tokens)) // self.cfg.block_size
        for digest in self._chain_digests(tokens, n):
            b = self._hash_to_block.get(digest)
            if b is None:
                break  # not registered, or evicted: the chain ends
            if digest in tier:
                tier.touch(digest)
            elif b not in self._unlanded:  # garbage until it lands
                todo.append((digest, b))
        if not todo:
            return 0
        captured = 0
        try:
            chaos.fire("llm.kv.demote", blocks=len(todo))
            k, v = self.demote_fn([b for _, b in todo])
            for i, (d, b) in enumerate(todo):
                stored, evicted = tier.put(d, k[:, i], v[:, i])
                if stored:
                    captured += 1
                    self.stats.demoted_blocks += 1
                    self.stats.host_evicted_blocks += evicted
                else:
                    self.stats.demote_drops += 1
        except Exception as exc:  # noqa: BLE001 — a cache miss, not a fault
            self.stats.demote_drops += len(todo) - captured
            logger.warning("host-tier chain demotion of %d blocks failed: %r",
                           len(todo), exc)
        return captured

    def _host_lookup(self, digest: bytes):
        """Fetch and verify one host-tier entry -> (k, v) or None. A
        failed verification is a miss: the entry is dropped, counted and
        logged, and its bytes never reach the pool."""
        tier = self.host_tier
        if tier is None or digest not in tier:
            return None
        try:
            return tier.get(digest)
        except Exception as exc:  # noqa: BLE001 — any corruption is a miss
            tier.discard(digest)
            self.stats.host_corrupt_drops += 1
            logger.warning("host-tier entry %s failed verification, "
                           "dropped: %r", digest.hex(), exc)
            return None

    def take_pending_promotions(self) -> list[tuple[int, Any, Any]]:
        """Drain the staged promotions -> (block, k, v) records, each at
        most once. A record whose block lost its digest before landing
        (its sequence was cancelled and the block evicted) is dropped: the
        arena still holds its bytes. Callers follow a landing with
        ``promotions_landed``."""
        staged, self._pending_promotions = self._pending_promotions, []
        out = []
        for digest, b, k_block, v_block in staged:
            if self._block_hash.get(b) != digest:
                self._unlanded.discard(b)
                self.stats.promotion_drops += 1
                continue
            out.append((b, k_block, v_block))
        return out

    def promotions_landed(self, block_ids) -> None:
        """Ack that the payloads of ``block_ids`` are on the device: they
        become ordinary resident prefix blocks, exportable again."""
        self._unlanded.difference_update(block_ids)

    def prefix_digest_summary(self, limit: int = 32) -> list[str]:
        """At most ``limit`` hex chain digests of the prefix blocks this
        cache serves without recompute: device-resident entries newest
        registered first, then host-tier entries most recently used first
        (the routing keys the autoscaling snapshot carries)."""
        out: list[str] = []
        seen: set[bytes] = set()
        for digest in reversed(self._hash_to_block):
            if len(out) >= limit:
                return out
            out.append(digest.hex())
            seen.add(digest)
        if self.host_tier is not None:
            for digest in self.host_tier.digests():
                if len(out) >= limit:
                    break
                if digest not in seen:
                    out.append(digest.hex())
        return out

    # ---------------- views ----------------

    @property
    def used_blocks(self) -> int:
        """Blocks held by live tables or quarantined (cached blocks are
        reclaimable and not counted)."""
        return self.cfg.usable_blocks - len(self._free) - len(self._lru)

    @property
    def cached_blocks(self) -> int:
        """Content-addressed blocks with no live reference (the LRU set)."""
        return len(self._lru)

    @property
    def utilization(self) -> float:
        return self.used_blocks / max(1, self.cfg.usable_blocks)

    def debug_snapshot(self) -> dict:
        """JSON-safe accounting of the block pool and the cumulative
        ``CacheStats`` counters (the reference's keys)."""
        s, tier = self.stats, self.host_tier
        return {
            "num_blocks": self.cfg.num_blocks,
            "block_size": self.cfg.block_size,
            "used_blocks": self.used_blocks,
            "free_blocks": len(self._free),
            "quarantined_blocks": len(self._quarantine),
            "cached_blocks": self.cached_blocks,
            "reserved_blocks": self._reserved,
            "live_sequences": len(self._tables),
            "utilization": round(self.utilization, 4),
            "high_water_blocks": s.high_water_blocks,
            "allocated_total": s.allocated_total,
            "freed_total": s.freed_total,
            "prefix_hit_blocks": s.prefix_hit_blocks,
            "prefix_hit_tokens": s.prefix_hit_tokens,
            "prefix_evicted_blocks": s.prefix_evicted_blocks,
            "cow_copies": s.cow_copies,
            "adopted_blocks": s.adopted_blocks,
            "host_blocks": 0 if tier is None else tier.blocks,
            "host_bytes": 0 if tier is None else tier.nbytes,
            "demotions": s.demoted_blocks,
            "promotions": s.promoted_blocks,
            "host_evicted_blocks": s.host_evicted_blocks,
            "promotion_drops": s.promotion_drops,
            "demote_drops": s.demote_drops,
            "host_corrupt_drops": s.host_corrupt_drops,
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
