"""Continuous-batching scheduler over the paged KV cache (counterpart of
``ray_tpu/serve/llm/engine.py``, first slice).

Every step is EITHER one batched prefill call (new admissions, or the next
chunk of a long prompt) OR one batched decode step over all running
sequences. New requests join the decode batch the step after their
prefill completes, finished ones leave it the step they complete, and
their KV blocks return to the pool at once, exactly once. Fresh
admissions prefill immediately; continuing chunks of a long prompt
alternate with decode steps, so a long prompt never starves running
sequences.

Batch sizes pad to ``batch_buckets`` and token/context lengths to
``length_buckets`` (``serve/_shapes.py``), as in the JAX engine, so a
model step sees a closed set of shapes: on a card each decode signature
is one captured CUDA graph (``decode.py``), so a decode step costs the
host a few copies and one graph launch. Sampling runs on the device
inside the model step, keyed by (request seed, absolute position)
(``ops/sampling.py``; the draws are computed on the host and staged with
the step), so a request's stream is the same solo or batched and the
same as the JAX engine's on the same weights.

The decode loop is pipelined with a one-step sync lag (dispatch-ahead),
as the JAX engine's: step N+1 is fed straight from step N's sampled ids,
still on the device, and the host syncs step N's ids after dispatching
N+1, so bucketing, table packing and scheduling run while the device
computes. Any change of the batch (a join, a finish, an eviction, a row
at its token budget) first collapses the lag: the pending step is
reconciled on the host and the next one dispatched from host tokens.
EOS and cancel are reconciled when the lagged tokens arrive (at most one
wasted speculative row per finished request), and a row's blocks are
released exactly once, after its last in-flight step; blocks freed while
a step is in flight are quarantined until the next sync
(``kv_cache.flush_quarantine``). Prefill syncs its first tokens at once
(lag 0).

``EngineConfig.model`` names the model family (``decode.FAMILIES``:
"llama", the default as in the JAX engine, or "gpt"); the pool holds the
family's kv heads (``n_kv_head`` for Llama's grouped-query attention).
``EngineConfig.quantization`` ("int8" | "fp8") serves from quantized
weights and a quantized pool (``ops/quantization.py``).

Prefix caching (``EngineConfig.prefix_caching``, on by default as in the
JAX engine): admission maps the resident full blocks of a prompt into
its table (``kv_cache.assign_prefix``) and prefill computes only the
rest, at true positions on the chunk path; a prompt that is resident
whole still recomputes its last token (a one-token chunk, through a
copy-on-write of the shared tail block) for its first token's logits.
Each prefill chunk content-addresses the prompt blocks it completed
(``register_prefix``); a write into a shared or content-addressed block
first copies it (``prepare_write``, ``executor.copy_blocks``); finished
prompt blocks stay cached until the LRU evicts them. With
``host_cache_bytes`` > 0 an evicted block demotes into a host arena of
RTKV records (``executor.export_blocks``, a device-to-host sync recorded
as kind ``"demote"`` in ``debug_dump()``) and a later hit promotes it:
the staged payloads land in one ``executor.land_blocks`` at the top of
the next dispatch window, before any copy-on-write. ``export_prefix`` /
``adopt_prefix`` move a prompt's blocks between engines (also the JAX
engine's records, f32).

What this slice leaves out of the JAX engine: preemption (and its use of
``kv_cache.demote_chain``), admission skip-ahead
(``admission_probe``), the router's prefix digests, speculative
decoding, structured output (so no batch forces the lag to collapse),
stop sequences, deadlines, admission-queue limits, sharded executors,
observability beyond ``stats()`` and the sync records of
``debug_dump()``, and graphs for prefill (it runs eagerly). The head of
the admission queue blocks the requests behind it until it fits.
"""
from __future__ import annotations

import dataclasses
import math
import queue
import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.exceptions import EngineDiedError, RequestCancelledError
from ray_tpu_torch.models.families import kv_heads
from ray_tpu_torch.ops import kv_cache as kv_ops
from ray_tpu_torch.ops.paged_attention import resolve_backend
from ray_tpu_torch.ops.quantization import resolve_quantization, stack_blocks
from ray_tpu_torch.serve._shapes import pad_to_bucket, pow2_buckets
from ray_tpu_torch.serve.llm.decode import family
from ray_tpu_torch.serve.llm.executor import SingleDeviceExecutor
from ray_tpu_torch.serve.llm.kv_cache import (
    KVCacheConfig,
    PagedKVCache,
    _block_key,
)

_DONE = object()  # stream sentinel

# sync records kept for debug_dump()
_FLIGHT_RECORDS = 256

# sanity ceiling for max_new_tokens (submit() also checks max_seq_len)
_MAX_NEW_TOKENS_CAP = 1 << 20


@dataclass(frozen=True)
class SamplingParams:
    max_new_tokens: int = 16
    temperature: float = 0.0  # 0 -> greedy
    top_k: int = 0            # 0 or -1 -> full distribution
    top_p: float = 1.0        # nucleus mass in (0, 1]; 1.0 -> disabled
    seed: int = 0

    def __post_init__(self):
        if not (1 <= self.max_new_tokens <= _MAX_NEW_TOKENS_CAP):
            raise ValueError(
                f"max_new_tokens must be in [1, {_MAX_NEW_TOKENS_CAP}], "
                f"got {self.max_new_tokens}"
            )
        if not math.isfinite(self.temperature) or self.temperature < 0:
            raise ValueError(
                f"temperature must be finite and >= 0, got {self.temperature}"
            )
        if self.top_k < -1:
            raise ValueError(
                f"top_k must be >= -1 (0 or -1 disables), got {self.top_k}"
            )
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")


@dataclass(frozen=True)
class EngineConfig:
    model: str = "llama"          # gpt | llama (decode.py FAMILIES)
    model_config: Any = None      # GPTConfig/LlamaConfig; None -> .tiny()
    block_size: int = 16
    num_blocks: int = 64
    max_batch_size: int = 8       # max concurrently-running sequences
    max_prefill_batch: int = 4    # max requests coalesced into one prefill
    batch_buckets: tuple[int, ...] | None = None   # None -> pow2 ladder
    length_buckets: tuple[int, ...] | None = None  # None -> pow2 ladder
    eos_id: int | None = None
    seed: int = 0                 # weight init seed (when params not given)
    # prefill one prompt in slices of at most this many tokens, alternating
    # with decode steps; None -> the whole uncached rest in one call
    prefill_chunk_tokens: int | None = None
    prefix_caching: bool = True   # map prompts onto resident KV blocks
    # host KV tier capacity in bytes (RTKV records), 0 disables it: LRU
    # eviction demotes full prefix blocks into a host arena and prefix
    # hits promote them back (kv_cache.HostKVTier)
    host_cache_bytes: int = 0
    # None -> the model config's own; "auto" | "torch" | "cuda"
    attention_backend: str | None = None
    # None -> the model config's own; "int8" | "fp8": quantized weights and
    # paged pool on the quantized kernels
    quantization: str | None = None
    # None -> cuda:0 (raises without a card); "cpu" only when asked
    device: Any = None


class TokenStream:
    """Iterator over one request's generated token ids, delivered as the
    engine produces them (blocks between tokens; ends at completion)."""

    def __init__(self, request: "_Request"):
        self._request = request

    @property
    def request_id(self):
        return self._request.id

    @property
    def done(self) -> bool:
        return self._request.done

    def __iter__(self):
        while True:
            item = self._request.out.get()
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item


class _Request:
    __slots__ = (
        "id", "prompt", "sampling", "out", "generated", "reserved_blocks",
        "drawn_blocks", "prefill_done", "started", "table_np", "table_key",
        "done",
        # dispatch-ahead decode: dispatched-but-unreconciled steps that
        # include this row, and whether its KV blocks went back to the
        # pool (exactly-once release under the lag)
        "inflight", "blocks_released",
    )

    def __init__(self, req_id, prompt, sampling: SamplingParams):
        self.id = req_id
        self.prompt = list(prompt)
        self.sampling = sampling
        self.out: queue.Queue = queue.Queue()
        self.generated: list[int] = []
        self.reserved_blocks = 0
        self.drawn_blocks = 0     # blocks appended from the reservation
        self.prefill_done = 0     # prompt tokens whose KV is resident
        self.started = False      # ran at least one prefill chunk
        self.table_np: np.ndarray | None = None
        self.table_key: tuple | None = None
        self.done = False
        self.inflight = 0
        self.blocks_released = False

    @property
    def total_len(self) -> int:
        return len(self.prompt) + len(self.generated)


@dataclass
class _PendingDecode:
    """One dispatched-but-unsynced decode step: its ids (still on the
    device; row i belongs to ``batch[i]``, padding rows are garbage) and
    the exact batch it was dispatched over. The steady state keeps one in
    flight: step N+1 feeds from ``tokens`` and the host syncs N's ids one
    step behind."""

    tokens: Any          # executor.StepIds
    batch: list          # the _Request rows of this dispatch, in order


class LLMEngine:
    """Continuous-batching inference engine over a paged KV cache.

    ``auto_step=True`` runs the scheduler on a background thread;
    ``auto_step=False`` lets the caller drive ``step()``. All scheduler
    and cache state is guarded by one lock. ``params`` is a state dict of
    the family's weights (``convert.gpt_params_from_numpy`` /
    ``llama_params_from_numpy``); None draws seeded random weights on the
    device."""

    def __init__(
        self,
        cfg: EngineConfig | None = None,
        *,
        params: dict | None = None,
        auto_step: bool = True,
        **overrides,
    ):
        if cfg is None:
            cfg = EngineConfig(**overrides)
        elif overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        fam = family(cfg.model)
        model_cfg = cfg.model_config or fam.config.tiny()
        if not isinstance(model_cfg, fam.config):
            raise TypeError(
                f"model={cfg.model!r} takes a {fam.config.__name__}, got "
                f"{type(model_cfg).__name__}"
            )
        device = resolve_device(cfg.device)
        backend = resolve_backend(
            cfg.attention_backend or model_cfg.attention_backend, device
        )
        if model_cfg.attention_backend != backend:
            model_cfg = dataclasses.replace(model_cfg, attention_backend=backend)
        # EngineConfig wins, else the model config's own; normalized (a
        # typo raises) and written back into the model config
        quant = resolve_quantization(
            cfg.quantization if cfg.quantization is not None
            else model_cfg.quantization
        )
        if model_cfg.quantization != quant:
            model_cfg = dataclasses.replace(model_cfg, quantization=quant)
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.device = device
        self.cache = PagedKVCache(
            KVCacheConfig(
                n_layer=model_cfg.n_layer,
                n_kv_head=kv_heads(model_cfg),
                head_dim=model_cfg.head_dim,
                num_blocks=cfg.num_blocks,
                block_size=cfg.block_size,
                dtype=model_cfg.dtype,
                device=device,
                host_cache_bytes=cfg.host_cache_bytes,
                quantization=quant,
            )
        )
        self.executor = SingleDeviceExecutor(
            model_cfg, self.cache, params=params, seed=cfg.seed
        )
        if cfg.host_cache_bytes > 0:
            # an eviction's capture for the host tier (called under the
            # lock, from the cache): the executor's export, metered
            self.cache.demote_fn = lambda ids: self._metered_export(
                ids, "demote")
        self._batch_buckets = cfg.batch_buckets or pow2_buckets(
            1, cfg.max_batch_size
        )
        self._length_buckets = cfg.length_buckets or pow2_buckets(
            cfg.block_size, model_cfg.max_seq_len
        )
        for b in self._length_buckets:
            if b % cfg.block_size:
                raise ValueError(
                    f"length bucket {b} is not a multiple of "
                    f"block_size={cfg.block_size}"
                )
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self._waiting: deque[_Request] = deque()
        self._prefilling: list[_Request] = []  # admitted, prefill incomplete
        self._running: list[_Request] = []
        self._next_id = 0
        self._auto_step = auto_step
        self._thread: threading.Thread | None = None
        self._stopped = False
        self._failed: EngineDiedError | None = None
        # the one in-flight decode step (None when the lag is collapsed)
        self._pending: _PendingDecode | None = None
        # reusable numpy staging, two buffers per (name, shape) (see
        # _scratch_buf)
        self._scratch: dict[tuple, list] = {}
        self._sync_bytes_total = 0
        self._prefill_tokens_total = 0  # prompt tokens computed by prefill
        # one record per token sync: kind, rows, bytes and lag
        self._flight: deque[dict] = deque(maxlen=_FLIGHT_RECORDS)
        # "prefill" | "decode" | None: drives prefill/decode alternation
        self.last_step_kind: str | None = None
        # model calls made, by kind ("prefill" counts whole-prompt and
        # chunked prefill calls alike)
        self.num_prefill_calls = 0
        self.num_decode_steps = 0

    # ---------------- public API ----------------

    def submit(
        self,
        prompt: Sequence[int],
        sampling: SamplingParams | None = None,
        **sampling_overrides,
    ) -> TokenStream:
        """Enqueue one request; returns a stream of generated token ids."""
        if sampling is None:
            sampling = SamplingParams(**sampling_overrides)
        elif sampling_overrides:
            sampling = dataclasses.replace(sampling, **sampling_overrides)
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("prompt must contain at least one token")
        total = len(prompt) + sampling.max_new_tokens
        if total > self.model_cfg.max_seq_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({sampling.max_new_tokens}) exceeds model max_seq_len "
                f"{self.model_cfg.max_seq_len}"
            )
        need = self.cache.cfg.blocks_for(total)
        if need > self.cache.cfg.usable_blocks:
            raise ValueError(
                f"request needs {need} KV blocks "
                f"but the pool only has {self.cache.cfg.usable_blocks}"
            )
        if self._failed is not None:
            raise self._failed
        with self._lock:
            if self._stopped:
                raise RuntimeError("engine is shut down")
            req = _Request(self._next_id, prompt, sampling)
            self._next_id += 1
            self._waiting.append(req)
            self._work.notify_all()
        if self._auto_step:
            self._ensure_thread()
        return TokenStream(req)

    def generate(
        self,
        prompt: Sequence[int],
        sampling: SamplingParams | None = None,
        **sampling_overrides,
    ) -> list[int]:
        """Synchronous convenience: submit and collect all tokens."""
        stream = self.submit(prompt, sampling, **sampling_overrides)
        if not self._auto_step:
            while not stream.done:
                if not self.step():
                    break
        return list(stream)

    def step(self) -> bool:
        """One scheduler iteration: admit what fits, then EITHER one
        prefill call OR one batched decode step. Returns False when idle
        (nothing waiting, running or in flight)."""
        with self._lock:
            self._admit_locked()
            if self._prefilling and (
                self.last_step_kind != "prefill"
                or not self._running
                or any(not r.started for r in self._prefilling)
            ):
                self._prefill_chunk_locked()
                self.last_step_kind = "prefill"
                return True
            if self._running or self._pending is not None:
                # a pending step with nothing running still needs a step:
                # its tokens are reconciled and its rows' blocks freed
                self._decode_locked()
                self.last_step_kind = "decode"
                return True
            return False

    def cancel(self, request_id) -> bool:
        """Evict a waiting/prefilling/running request, fail its stream with
        ``RequestCancelledError`` and return its KV blocks at once. False
        when the request is unknown or already finished."""
        with self._lock:
            req = self._find_locked(request_id)
            if req is None:
                return False
            self._evict_locked(req)
            req.out.put(
                RequestCancelledError(f"request {request_id!r} cancelled")
            )
            req.out.put(_DONE)
            return True

    def stats(self) -> dict:
        """The reference engine's ``stats()`` keys that this engine
        fills."""
        with self._lock:
            cs = self.cache.stats
            hit = cs.prefix_hit_tokens
            computed = self._prefill_tokens_total
            tier = self.cache.host_tier
            return {
                "waiting": len(self._waiting),
                "prefilling": len(self._prefilling),
                "running": len(self._running),
                "kv_used_blocks": self.cache.used_blocks,
                "kv_utilization": self.cache.utilization,
                "kv_high_water_blocks": cs.high_water_blocks,
                "num_compiled_shapes": self.num_compiled_shapes,
                "prefix_hit_tokens": hit,
                "prefix_hit_blocks": cs.prefix_hit_blocks,
                "prefix_cached_blocks": self.cache.cached_blocks,
                "prefix_evicted_blocks": cs.prefix_evicted_blocks,
                "host_cache_blocks": 0 if tier is None else tier.blocks,
                "kv_demoted_blocks": cs.demoted_blocks,
                "kv_promoted_blocks": cs.promoted_blocks,
                "cow_blocks": cs.cow_copies,
                "prefill_tokens_total": computed,
                "prefix_hit_rate": hit / max(1, hit + computed),
                "host_sync_bytes_total": self._sync_bytes_total,
                "decode_inflight": 1 if self._pending is not None else 0,
                "failed": self._failed is not None,
            }

    @property
    def fns(self):
        """The executor's ``DecodeFns`` (signature accounting, graphs)."""
        return self.executor.fns

    @property
    def num_compiled_shapes(self) -> int:
        return self.fns.num_compiled_shapes

    def debug_dump(self) -> dict:
        """The recent token-sync records (``steps``: kind, batch,
        ``sync_bytes``, ``sync_lag``) and the pool's accounting."""
        with self._lock:
            return {"steps": list(self._flight),
                    "cache": self.cache.debug_snapshot(),
                    "stats": self.stats()}

    # ---------------- prefix export / adoption ----------------

    def export_prefix(self, prompt) -> list:
        """The resident leading full blocks of ``prompt`` as (chain
        digest, k, v) host records in chain order (``export_blocks``'s
        arrays). Under the lock, so no block is evicted between the chain
        walk and the gather; a partial chain is a shorter, valid export.
        Call after the prompt's prefill finished."""
        with self._lock:
            chain = self.cache.export_chain(prompt)
            if not chain:
                return []
            k, v = self._metered_export([b for _, b in chain], "export")
        return [(d, k[:, i], v[:, i]) for i, (d, _) in enumerate(chain)]

    def adopt_prefix(self, prompt, records) -> int:
        """Land another engine's ``export_prefix`` records of ``prompt``:
        each record's chain digest is checked against THIS engine's
        digest of the prompt (``kv_cache._block_key``; the records' own
        claim is never trusted), pool blocks are claimed as cached
        entries, and the payloads land in one ``land_blocks``, so the
        next ``submit`` of the prompt is a prefix hit. Already-resident
        blocks are skipped; a digest mismatch or a full pool stops the
        walk. -> leading prompt blocks resident afterwards."""
        bs = self.cache.cfg.block_size
        with self._lock:
            # within the unreserved capacity: landing into reserved
            # headroom would be evicted by the admissions holding it
            budget = self.cache.spare_blocks
            digest = b""
            ids, ks, vs = [], [], []
            resident = 0
            for i, (chain, k_blk, v_blk) in enumerate(records):
                if (i + 1) * bs > len(prompt):
                    break  # beyond the prompt's full blocks
                digest = _block_key(digest, prompt[i * bs:(i + 1) * bs])
                if digest != chain:
                    break  # not our tokens from position 0
                if self.cache.has_digest(digest):
                    resident += 1
                    continue
                if len(ids) >= budget:
                    break
                b = self.cache.adopt_block(digest)
                if b is None:
                    break
                ids.append(b)
                ks.append(k_blk)
                vs.append(v_blk)
                resident += 1
            if ids:
                self.executor.land_blocks(ids, stack_blocks(ks, axis=1),
                                          stack_blocks(vs, axis=1))
        return resident

    def shutdown(self) -> None:
        """Stop stepping, fail every pending stream and return all KV
        blocks to the pool."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            self._fan_out_locked(RequestCancelledError("engine shut down"))
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # ---------------- scheduler internals (lock held) ----------------

    def _find_locked(self, request_id) -> _Request | None:
        for r in (*self._running, *self._prefilling, *self._waiting):
            if r.id == request_id:
                return r
        return None

    def _release_blocks_locked(self, r: _Request) -> None:
        """Return an admitted request's blocks and leftover reservation to
        the pool EXACTLY ONCE, respecting the dispatch lag: while the row
        is in an unreconciled step (``inflight > 0``) release waits for
        the reconcile that retires it, and blocks freed while any step is
        in flight are quarantined until the next sync."""
        if r.blocks_released or r.reserved_blocks == 0 or r.inflight > 0:
            return
        r.blocks_released = True
        self.cache.free(r.id, quarantine=self._pending is not None)
        leftover = r.reserved_blocks - r.drawn_blocks
        if leftover > 0:
            self.cache.release_reservation(leftover)
        self._work.notify_all()  # freed blocks may unblock admissions

    def _evict_locked(self, r: _Request) -> None:
        if r in self._running:
            self._running.remove(r)
        elif r in self._prefilling:
            self._prefilling.remove(r)
        else:
            self._waiting.remove(r)
        r.done = True  # before release: an in-flight row defers it
        self._release_blocks_locked(r)

    def _try_admit_one_locked(self, req: _Request) -> bool:
        """Reserve the request's worst-case blocks (prompt +
        max_new_tokens), give it a table and map its resident prompt
        prefix; False (no state change) when they do not fit right now.
        A prompt resident whole reserves ONE extra block: its last token
        is recomputed for the first token's logits, and that write lands
        in a shared block, so it always makes one copy-on-write."""
        bs = self.cfg.block_size
        toks = req.prompt
        need = self.cache.cfg.blocks_for(
            len(toks) + req.sampling.max_new_tokens
        )
        max_hit_blocks = None
        if self.cfg.prefix_caching:
            max_hit_blocks = self.cache.peek_prefix(toks)
            if max_hit_blocks * bs >= len(toks):  # full-chain hit
                if (need + 1 <= self.cache.cfg.usable_blocks
                        and self.cache.can_reserve(need + 1)):
                    need += 1
                else:  # no room for the copy: recompute the last block
                    max_hit_blocks -= 1
        if not self.cache.can_reserve(need):
            return False
        self.cache.reserve(need)
        req.reserved_blocks = need
        self.cache.allocate(req.id)
        if self.cfg.prefix_caching:
            hit_tokens = self.cache.assign_prefix(req.id, toks,
                                                  max_blocks=max_hit_blocks)
            req.drawn_blocks += hit_tokens // bs
            # a full-chain hit still recomputes the LAST token
            req.prefill_done = min(hit_tokens, len(toks) - 1)
        return True

    def _admit_locked(self) -> int:
        """Move waiting requests into the prefilling set in FIFO order,
        up to the batch and prefill limits; stops at the first request
        whose reservation does not fit. Returns the number admitted."""
        admitted = 0
        while (
            self._waiting
            and len(self._running) + len(self._prefilling)
            < self.cfg.max_batch_size
            and admitted < self.cfg.max_prefill_batch
            and self._try_admit_one_locked(self._waiting[0])
        ):
            self._prefilling.append(self._waiting.popleft())
            admitted += 1
        return admitted

    def _table_for(self, r: _Request, nb: int) -> np.ndarray:
        """Host block table for one request, rebuilt only when a block was
        appended or the padded width changed."""
        key = (nb, self.cache.table_version(r.id))
        if r.table_key != key:
            r.table_np = self.cache.block_table(r.id, nb)
            r.table_key = key
        return r.table_np

    def _apply_promotions_locked(self) -> None:
        """Land the host-tier promotions staged by admission in ONE
        ``land_blocks``. Runs at the TOP of a dispatch window, before
        ``prepare_write``: a copy-on-write of a promoted block must clone
        landed content, and an eviction in the same window must see the
        landing acked before it may export the block."""
        staged = self.cache.take_pending_promotions()
        if not staged:
            return
        ids = [b for b, _, _ in staged]
        self.executor.land_blocks(
            ids,
            stack_blocks([k for _, k, _ in staged], axis=1),
            stack_blocks([v for _, _, v in staged], axis=1),
        )
        self.cache.promotions_landed(ids)

    def _metered_export(self, block_ids: list[int], kind: str):
        """``executor.export_blocks``, recorded as a device-to-host sync
        of ``kind`` (it waits for every step queued before it)."""
        k, v = self.executor.export_blocks(block_ids)
        nbytes = kv_ops.planes_nbytes(k, v)
        self._sync_bytes_total += nbytes
        self._flight.append({"kind": kind, "batch": len(block_ids),
                             "sync_bytes": int(nbytes),
                             "sync_lag": 0 if self._pending is None else 1})
        return k, v

    def _prefill_chunk_locked(self) -> None:
        """ONE prefill call for up to ``max_prefill_batch`` admitted
        requests, each contributing its next chunk. Whole cold prompts
        take the fresh path (start=None); anything mid-prompt or
        prefix-seeded takes the chunked path at true positions."""
        batch = self._prefilling[: self.cfg.max_prefill_batch]
        # promotions land before capacity and copy-on-write work
        self._apply_promotions_locked()
        bs = self.cfg.block_size
        cap = self.cfg.prefill_chunk_tokens
        ns = []
        for r in batch:
            r.started = True
            remaining = len(r.prompt) - r.prefill_done
            ns.append(remaining if cap is None else min(remaining, cap))
        pairs = []
        for r, n in zip(batch, ns):
            r.drawn_blocks += self.cache.ensure_capacity(
                r.id, r.prefill_done + n
            )
            cow = self.cache.prepare_write(r.id, r.prefill_done,
                                           r.prefill_done + n)
            r.drawn_blocks += len(cow)
            pairs.extend(cow)
        self.executor.copy_blocks(pairs)
        fresh = all(
            r.prefill_done == 0 and n == len(r.prompt)
            for r, n in zip(batch, ns)
        )
        S = pad_to_bucket(max(ns), self._length_buckets)
        B = pad_to_bucket(len(batch), self._batch_buckets)
        if fresh:
            nb = S // bs
        else:
            ctx = pad_to_bucket(
                max(r.prefill_done + n for r, n in zip(batch, ns)),
                self._length_buckets,
            )
            nb = ctx // bs
        tokens = self._scratch_buf("pf_tokens", (B, S), np.int32)
        lengths = self._scratch_buf("pf_lengths", (B,), np.int32)
        starts = self._scratch_buf("pf_starts", (B,), np.int32)
        tables = self._scratch_buf("pf_tables", (B, nb), np.int32)
        # padding rows: length 1, all-garbage table
        tokens[:] = 0
        lengths[:] = 1
        starts[:] = 0
        tables[:] = 0
        for i, (r, n) in enumerate(zip(batch, ns)):
            tokens[i, :n] = r.prompt[r.prefill_done: r.prefill_done + n]
            lengths[i] = n
            starts[i] = r.prefill_done
            tables[i] = self._table_for(r, nb)
        sample = self._sample_args_locked(batch, B)
        if fresh:
            toks_dev = self.executor.prefill(tokens, lengths, tables,
                                             sample=sample)
        else:
            toks_dev = self.executor.prefill_chunk(
                tokens, lengths, starts, tables, sample=sample
            )
        # first tokens sync at once (lag 0): the first token must not wait
        # for the next decode step
        host = self._sync_tokens_locked(toks_dev, "prefill", len(batch),
                                        lag=0)
        self.num_prefill_calls += 1
        for i, (r, n) in enumerate(zip(batch, ns)):
            r.prefill_done += n
            self._prefill_tokens_total += n
            if self.cfg.prefix_caching:
                self.cache.register_prefix(r.id, r.prompt, r.prefill_done)
            if r.prefill_done >= len(r.prompt):
                # the final chunk's last-token logits give the first token
                self._prefilling.remove(r)
                self._emit_token_locked(r, int(host[i]))
                if not r.done:
                    self._running.append(r)

    def _decode_locked(self) -> None:
        """One pipelined decode iteration. Steady state (the eligible
        batch is exactly the batch of the step in flight): dispatch step
        N+1 fed from step N's ids on the device, THEN sync N's ids, so the
        host work above the dispatch overlaps N on the device and the
        sync finds N done. Any batch change first collapses the lag:
        reconcile the pending step, rebuild the batch and dispatch from
        host tokens."""
        bs = self.cfg.block_size
        pending = self._pending

        def eligible() -> list[_Request]:
            # the budget counts the in-flight token: a row at
            # max_new_tokens - 1 with one token in flight is not
            # dispatched again (its last token arrives at reconcile)
            return [r for r in self._running
                    if len(r.generated) + r.inflight
                    < r.sampling.max_new_tokens]

        batch = eligible()
        # list equality is element identity here: the same _Request
        # objects in the same order <=> nothing joined, finished or left
        steady = pending is not None and batch == pending.batch
        if pending is not None and not steady:
            self._reconcile_locked(pending)
            pending = None
            batch = eligible()
        if not batch:
            return  # a drain step: the reconcile above retired the lag
        self._apply_promotions_locked()
        pairs = []
        for r in batch:
            # the effective length counts the in-flight token: this
            # dispatch writes its K/V at position eff - 1
            eff = r.total_len + r.inflight
            r.drawn_blocks += self.cache.ensure_capacity(r.id, eff)
            cow = self.cache.prepare_write(r.id, eff - 1, eff)
            r.drawn_blocks += len(cow)
            pairs.extend(cow)
        self.executor.copy_blocks(pairs)
        B = pad_to_bucket(len(batch), self._batch_buckets)
        ctx = pad_to_bucket(
            max(max(r.total_len + r.inflight,
                    self.cache.num_allocated(r.id) * bs) for r in batch),
            self._length_buckets,
        )
        nb = ctx // bs
        positions = self._scratch_buf("dec_positions", (B,), np.int32)
        tables = self._scratch_buf("dec_tables", (B, nb), np.int32)
        # reused buffers: re-zero padding rows (a stale table row could
        # point at blocks now owned by a live sequence)
        positions[len(batch):] = 0
        tables[len(batch):] = 0
        for i, r in enumerate(batch):
            positions[i] = r.total_len + r.inflight - 1
            tables[i] = self._table_for(r, nb)
        if steady:
            # step N+1 fed from step N's ids without a host round trip
            tokens = pending.tokens
        else:
            tokens = self._scratch_buf("dec_tokens", (B,), np.int32)
            tokens[len(batch):] = 0
            for i, r in enumerate(batch):
                tokens[i] = r.generated[-1]
        nxt = self.executor.decode_step(
            tokens, positions, tables,
            sample=self._sample_args_locked(batch, B),
        )
        self.num_decode_steps += 1
        for r in batch:
            r.inflight += 1
        self._pending = _PendingDecode(tokens=nxt, batch=batch)
        if steady:
            # reconcile step N only after dispatching N+1
            self._reconcile_locked(pending)

    def _reconcile_locked(self, pending: _PendingDecode) -> None:
        """Collapse the lag for one in-flight decode step: sync its ids,
        flush the quarantine (the sync proves every earlier dispatch
        executed), then emit per row. Rows that ended after the dispatch
        (EOS raced the lag, cancel) drop their speculative token and
        release their blocks, exactly once."""
        if self._pending is pending:
            self._pending = None
        toks = self._sync_tokens_locked(pending.tokens, "decode",
                                        len(pending.batch), lag=1)
        self.cache.flush_quarantine()
        for i, r in enumerate(pending.batch):
            r.inflight -= 1
            if r.done:
                self._release_blocks_locked(r)
            else:
                self._emit_token_locked(r, int(toks[i]))
        self._running = [r for r in self._running if not r.done]

    def _sync_tokens_locked(self, ids, kind: str, rows: int, *,
                            lag: int) -> np.ndarray:
        """THE device->host sync: a step's O(batch) int32 ids, metered.
        ``lag`` is the number of dispatches between the step that made
        them and this sync (0: prefill's immediate sync; 1: the pipelined
        decode)."""
        toks = self.executor.sync_tokens(ids)
        self._sync_bytes_total += toks.nbytes
        self._flight.append({"kind": kind, "batch": rows,
                             "sync_bytes": int(toks.nbytes),
                             "sync_lag": lag})
        return toks

    def _sample_args_locked(self, batch: list, B: int) -> dict:
        """Per-row sampling controls as [B] host arrays; padding rows are
        greedy so an all-greedy batch skips the sort."""
        seeds = self._scratch_buf("sp_seeds", (B,), np.int64)
        temp = self._scratch_buf("sp_temp", (B,), np.float32)
        top_k = self._scratch_buf("sp_top_k", (B,), np.int32)
        top_p = self._scratch_buf("sp_top_p", (B,), np.float32)
        seeds[:] = 0
        temp[:] = 0.0
        top_k[:] = 0
        top_p[:] = 1.0
        for i, r in enumerate(batch):
            sp = r.sampling
            seeds[i] = sp.seed & 0xFFFFFFFF
            temp[i] = sp.temperature
            top_k[i] = sp.top_k
            top_p[i] = sp.top_p
        return {"seeds": seeds, "temperature": temp, "top_k": top_k,
                "top_p": top_p}

    def _scratch_buf(self, name: str, shape: tuple, dtype) -> np.ndarray:
        """Reusable numpy staging buffer for one (name, shape) slot. Two
        buffers alternate per slot, as in the reference engine, where
        ``jnp.asarray`` may alias a host buffer that a dispatch still
        reads. Here the executor copies a staged array into its own
        pinned pair at dispatch, so the alternation keeps the reference's
        invariant rather than guarding a copy; the executor's pinned
        pairs are the ones the lag-1 sync protects. Callers overwrite
        every element they use and re-zero padding tails."""
        key = (name, shape)
        slot = self._scratch.get(key)
        if slot is None:
            slot = self._scratch[key] = [np.zeros(shape, dtype),
                                         np.zeros(shape, dtype), 0]
        slot[2] ^= 1
        return slot[slot[2]]

    def _emit_token_locked(self, r: _Request, tok: int) -> None:
        r.generated.append(tok)
        r.out.put(tok)
        if (
            len(r.generated) >= r.sampling.max_new_tokens
            or (self.cfg.eos_id is not None and tok == self.cfg.eos_id)
        ):
            r.done = True
            r.out.put(_DONE)
            # last: a row ending while its next token is in flight defers
            # the free to that step's reconcile (exactly-once release)
            self._release_blocks_locked(r)

    def _fan_out_locked(self, err: BaseException) -> None:
        """Fail every live stream with ``err`` and return all blocks."""
        for r in (*self._waiting, *self._prefilling, *self._running):
            if not r.done:
                r.done = True
                r.out.put(err)
                r.out.put(_DONE)
        self._waiting.clear()
        self._prefilling = []
        self._running = []
        self._pending = None  # the in-flight step dies with the engine
        self.cache.release_all()

    # ---------------- background stepping ----------------

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._stopped or self._failed is not None:
                return
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, name="llm-engine-step", daemon=True
                )
                self._thread.start()

    def _loop(self) -> None:
        while True:
            with self._lock:
                if self._stopped:
                    return
            try:
                progressed = self.step()
            except Exception as e:  # noqa: BLE001 — fail closed, fan out
                err = EngineDiedError(f"engine step failed: {e!r}")
                err.__cause__ = e
                with self._lock:
                    self._failed = err
                    self._fan_out_locked(err)
                return
            if not progressed:
                with self._work:
                    if not (self._stopped or self._waiting
                            or self._prefilling or self._running):
                        self._work.wait(timeout=0.05)
