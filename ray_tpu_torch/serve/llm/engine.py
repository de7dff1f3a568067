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
EOS, cancel and deadlines are reconciled when the lagged tokens arrive
(at most one wasted speculative row per finished request), and a row's
blocks are released exactly once, after its last in-flight step; blocks
freed while a step is in flight are quarantined until the next sync
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

Speculative decoding (``EngineConfig.speculative_k`` > 0, as in the JAX
engine): a host drafter (``drafter.py``, "ngram" by default) proposes up
to k tokens a row, clamped to the row's budget and, for a constrained
row, to its grammar; when any row drafts, the lag collapses and ONE
verify step scores the [B, k + 1] window (``executor.verify_step``: one
CUDA graph per verify signature, B5 over the window at true positions),
syncs its packed verdicts at lag 0 and commits 1..k + 1 tokens a row,
losslessly (exact match against the keyed sampler). When no row drafts,
the lag-1 decode runs untouched.

The request surface of ``SamplingParams``: ``structured`` (JSON mode, a
JSON-Schema subset or a regex, ``structured.py``: a token DFA whose
allow-mask rows ride the step's sampling inputs; a constrained row
collapses the lag every step, its drafts are cut at the grammar and a
verify window stages one mask per column), ``stop`` sequences (matched
across the resume boundary), ``deadline_s`` (expired requests are
evicted at the top of a step and fail with ``DeadlineExceededError``)
and ``start_index`` (failover resume: the grammar replays the prompt's
delivered tail).

Priority classes (``SamplingParams.priority``: "batch" < "default" <
"interactive"), with ``EngineConfig.preemption`` set: under KV-pool
pressure (or a higher class's queue wait) the lowest-ranked running
stream is parked: the lag collapses, its chain is registered up to its
last resident token and demoted to the host tier in one
``executor.export_blocks`` (``kv_cache.demote_chain``), its blocks go
back once, and it waits in ``preempted`` with its tokens, grammar cursor
and sampling keys intact. When pressure clears, or its aging floor
trips, it is re-admitted as prompt + generated tokens: the cached blocks
come back from the device or the host tier, the tail is recomputed at
true positions, and keyed sampling gives the tokens an unparked run
would. Admission takes the rank order when preemption is on, probes
``admission_probe`` requests past a head that does not fit (at most
``admission_max_skips`` times for one head), and ``submit`` refuses with
``EngineOverloadedError`` past ``max_waiting`` requests or
``max_waiting_blocks`` worst-case blocks queued.

What the port's engine leaves out of the JAX engine so far:
observability beyond ``stats()`` and the sync records of
``debug_dump()`` (``obs.py``, the flight recorder, the watchdog, the
preemption metrics and timeline events, ``autoscaling_snapshot``), the
chaos points, the Serve deployment (``api.py``: class-aware shedding,
Retry-After), the router's prefix digests, sharded executors, and graphs
for prefill (it runs eagerly).
"""
from __future__ import annotations

import dataclasses
import logging
import math
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.exceptions import (
    DeadlineExceededError,
    EngineDiedError,
    EngineOverloadedError,
    RequestCancelledError,
)
from ray_tpu_torch.models.families import kv_heads
from ray_tpu_torch.ops import kv_cache as kv_ops
from ray_tpu_torch.ops.paged_attention import resolve_backend
from ray_tpu_torch.ops.quantization import resolve_quantization, stack_blocks
from ray_tpu_torch.serve._shapes import pad_to_bucket, pow2_buckets
from ray_tpu_torch.serve.llm import structured
from ray_tpu_torch.serve.llm.decode import family, mask_words
from ray_tpu_torch.serve.llm.drafter import build_drafter
from ray_tpu_torch.serve.llm.executor import SingleDeviceExecutor
from ray_tpu_torch.serve.llm.kv_cache import (
    KVCacheConfig,
    PagedKVCache,
    _block_key,
)

logger = logging.getLogger("ray_tpu_torch.serve.llm")

_DONE = object()  # stream sentinel

# sync records kept for debug_dump()
_FLIGHT_RECORDS = 256

# sanity ceiling for max_new_tokens (submit() also checks max_seq_len)
_MAX_NEW_TOKENS_CAP = 1 << 20

# priority classes, lowest rank first: preemption parks the lower ranks
# first, and admission (preemption on) takes the higher ranks first
_PRIORITIES = ("batch", "default", "interactive")
PRIORITY_RANK = {name: rank for rank, name in enumerate(_PRIORITIES)}


@dataclass(frozen=True)
class SamplingParams:
    max_new_tokens: int = 16
    temperature: float = 0.0  # 0 -> greedy
    top_k: int = 0            # 0 or -1 -> full distribution
    top_p: float = 1.0        # nucleus mass in (0, 1]; 1.0 -> disabled
    seed: int = 0
    deadline_s: float | None = None  # wall-clock budget from submit()
    start_index: int = 0      # tokens already delivered (failover resume)
    # grammar constraint (serve/llm/structured.py): None, "json" /
    # "json_object", a response_format dict, or a GrammarSpec
    structured: Any = None
    # stop sequences: token-id sequences that terminate the stream when
    # they appear as a suffix of the generated tokens (the matched stop
    # tokens ARE emitted, like EOS). Normalized to a tuple of tuples.
    stop: Any = ()
    # priority class: "interactive" | "default" | "batch"; orders
    # preemption and (preemption on) admission, never the tokens
    priority: str = "default"

    def __post_init__(self):
        if self.priority not in _PRIORITIES:
            raise ValueError(
                f"priority must be one of {_PRIORITIES}, "
                f"got {self.priority!r}"
            )
        if not (1 <= self.max_new_tokens <= _MAX_NEW_TOKENS_CAP):
            raise ValueError(
                f"max_new_tokens must be in [1, {_MAX_NEW_TOKENS_CAP}], "
                f"got {self.max_new_tokens}"
            )
        if self.start_index < 0:
            raise ValueError("start_index must be >= 0")
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
        norm = []
        for seq in self.stop:
            if isinstance(seq, int):
                seq = (seq,)
            seq = tuple(int(t) for t in seq)
            if not seq:
                raise ValueError("stop sequences must be non-empty")
            norm.append(seq)
        object.__setattr__(self, "stop", tuple(norm))


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
    max_waiting: int = 128        # admission queue bound (overload beyond)
    max_waiting_blocks: int | None = None  # worst-case block budget queued
    # prefill one prompt in slices of at most this many tokens, alternating
    # with decode steps; None -> the whole uncached rest in one call
    prefill_chunk_tokens: int | None = None
    prefix_caching: bool = True   # map prompts onto resident KV blocks
    admission_probe: int = 4      # skip-ahead width when the head won't fit
    admission_max_skips: int = 16  # aging cap: stop skipping a starved head
    # host KV tier capacity in bytes (RTKV records), 0 disables it: LRU
    # eviction demotes full prefix blocks into a host arena and prefix
    # hits promote them back (kv_cache.HostKVTier)
    host_cache_bytes: int = 0
    # None -> the model config's own; "auto" | "torch" | "cuda"
    attention_backend: str | None = None
    # None -> the model config's own; "int8" | "fp8": quantized weights and
    # paged pool on the quantized kernels
    quantization: str | None = None
    # speculative decoding: > 0 drafts up to k tokens a row on the host
    # (``drafter``) and scores the [B, k+1] window in one verify step,
    # committing the accepted drafts and one corrected token (1..k+1);
    # lossless, exact-match against the keyed sampler
    speculative_k: int = 0
    # Drafter | "ngram" | None (None drafts nothing); read only when
    # speculative_k > 0
    drafter: Any = "ngram"
    # PreemptionConfig, or a dict of its fields; None disables priority
    # preemption (low-rank running streams parked on the host tier under
    # pressure, resumed when it clears)
    preemption: Any = None
    # None -> cuda:0 (raises without a card); "cpu" only when asked
    device: Any = None


@dataclass(frozen=True)
class PreemptionConfig:
    """Thresholds for priority preemption (``EngineConfig.preemption``).
    Pressure is the fraction of usable KV blocks a new admission cannot
    claim (reservations included); times are ``time.monotonic`` seconds."""

    kv_pressure: float = 0.90   # park when pool pressure crosses this
    queue_wait_s: float = 0.25  # ... or a higher-rank wait exceeds this
    resume_pressure: float = 0.75  # resume parked streams below this
    aging_s: float = 30.0       # starvation floor: waiting/parked this long
    # ranks above interactive and is no longer preemptible
    max_preempted: int = 64     # cap on concurrently parked streams


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
        "done", "deadline",
        # dispatch-ahead decode: dispatched-but-unreconciled steps that
        # include this row, and whether its KV blocks went back to the
        # pool (exactly-once release under the lag)
        "inflight", "blocks_released",
        # grammar-constrained decoding: the request's structured.FSMCursor,
        # or None when unconstrained
        "fsm",
        # admission and preemption: submit time, admissions that jumped
        # past this head, the chain a parked stream re-prefills (prompt +
        # generated; None otherwise), its last park time and park count
        "submitted_clock", "skips", "pending_resume", "preempted_clock",
        "preempt_count",
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
        self.fsm = None
        self.submitted_clock = time.monotonic()
        self.skips = 0
        self.pending_resume: list[int] | None = None
        self.preempted_clock: float | None = None
        self.preempt_count = 0
        self.deadline = (self.submitted_clock + sampling.deadline_s
                         if sampling.deadline_s is not None else None)

    @property
    def total_len(self) -> int:
        return len(self.prompt) + len(self.generated)

    @property
    def prefill_tokens(self) -> list[int]:
        """The chain prefill makes resident: the prompt, or prompt +
        generated tokens when resuming from a park."""
        return (self.pending_resume if self.pending_resume is not None
                else self.prompt)


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
        if cfg.speculative_k < 0:
            raise ValueError("speculative_k must be >= 0")
        self._drafter = (build_drafter(cfg.drafter)
                         if cfg.speculative_k > 0 else None)
        self._spec_drafted_total = 0    # draft tokens proposed
        self._spec_accepted_total = 0   # draft tokens accepted by verify
        self._spec_committed_total = 0  # tokens emitted by verify steps
        self._deadline_total = 0
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
        self._waiting_blocks = 0  # worst-case blocks held by the queue
        self._prefilling: list[_Request] = []  # admitted, prefill incomplete
        self._running: list[_Request] = []
        self._preemption: PreemptionConfig | None = (
            PreemptionConfig(**cfg.preemption)
            if isinstance(cfg.preemption, dict) else cfg.preemption)
        # parked streams: no KV blocks held, tokens and FSM cursor intact
        self._preempted: list[_Request] = []
        self._preempted_total = 0
        # pressure holds and no running stream is outranked by a waiter
        self._preempt_exhausted = False
        self._rejected_total = 0
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
        self.num_verify_steps = 0       # speculative verify steps

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
        # grammar constraint: compiled (LRU-cached) and the cursor
        # positioned outside the lock; a bad grammar raises GrammarError
        # (a ValueError) here, at submit
        fsm = None
        spec = structured.parse_response_format(sampling.structured)
        if spec is not None:
            dfa = structured.compile_grammar(
                spec, self.model_cfg.vocab_size, self.cfg.eos_id
            )
            fsm = structured.FSMCursor(dfa)
            if sampling.start_index > 0:
                # failover resume: replay the already-delivered tokens
                # (the prompt tail) so the cursor lands where the dead
                # replica's stood
                for t in prompt[-sampling.start_index:]:
                    if not fsm.advance(t):
                        raise structured.GrammarError(
                            f"resumed prefix rejected by the grammar at "
                            f"token {t} (response_format mismatch on "
                            "resume?)"
                        )
        if self._failed is not None:
            raise self._failed
        with self._lock:
            if self._stopped:
                raise RuntimeError("engine is shut down")
            if len(self._waiting) >= self.cfg.max_waiting or (
                self.cfg.max_waiting_blocks is not None
                and self._waiting_blocks + need > self.cfg.max_waiting_blocks
            ):
                self._rejected_total += 1
                raise EngineOverloadedError(
                    f"admission queue full ({len(self._waiting)} waiting, "
                    f"{self._waiting_blocks} worst-case blocks queued); "
                    "retry later"
                )
            req = _Request(self._next_id, prompt, sampling)
            req.fsm = fsm
            self._next_id += 1
            self._waiting.append(req)
            self._waiting_blocks += need
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
        """One scheduler iteration: expire deadlines, resume and park
        streams (preemption on), admit what fits, then EITHER one prefill
        call OR one batched decode (or verify) step. Returns False when
        there is nothing to prefill, decode or reconcile."""
        with self._lock:
            self._expire_deadlines_locked()
            if self._preemption is not None:
                self._maybe_resume_locked()
                self._maybe_preempt_locked()
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
                "preempted": len(self._preempted),
                "preemptions_total": self._preempted_total,
                "preempt_exhausted": self._preempt_exhausted,
                "kv_used_blocks": self.cache.used_blocks,
                "kv_utilization": self.cache.utilization,
                "kv_high_water_blocks": cs.high_water_blocks,
                "num_compiled_shapes": self.num_compiled_shapes,
                "rejected_total": self._rejected_total,
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
                "deadline_exceeded_total": self._deadline_total,
                "spec_steps": self.num_verify_steps,
                "spec_drafted_tokens": self._spec_drafted_total,
                "spec_accepted_tokens": self._spec_accepted_total,
                "spec_committed_tokens": self._spec_committed_total,
                "spec_accept_rate": (self._spec_accepted_total
                                     / max(1, self._spec_drafted_total)),
                "spec_committed_per_step": (self._spec_committed_total
                                            / max(1, self.num_verify_steps)),
                "structured_running": sum(
                    1 for r in self._running if r.fsm is not None),
                "grammar_cache": structured.cache_stats(),
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
        for r in (*self._running, *self._prefilling, *self._waiting,
                  *self._preempted):
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
        """Take a live request out of the scheduler and give back what it
        holds: an admitted row's blocks (once), a waiting one's queued
        budget; a parked row holds nothing. Leaves its stream alone."""
        if r in self._running:
            self._running.remove(r)
        elif r in self._prefilling:
            self._prefilling.remove(r)
        elif r in self._preempted:
            self._preempted.remove(r)
        else:
            self._waiting.remove(r)
            self._waiting_blocks -= self._queued_blocks(r)
        r.done = True  # before release: an in-flight row defers it
        self._release_blocks_locked(r)
        self._work.notify_all()

    def _queued_blocks(self, r: _Request) -> int:
        """The worst-case blocks a waiting request counts against
        ``max_waiting_blocks``."""
        return self.cache.cfg.blocks_for(
            len(r.prompt) + r.sampling.max_new_tokens)

    def _expire_deadlines_locked(self) -> None:
        """Evict every request whose deadline passed (blocks back once,
        deferred past an in-flight step as any eviction), fail its stream
        with ``DeadlineExceededError`` and end it."""
        now = time.monotonic()
        expired = [r for r in (*self._waiting, *self._prefilling,
                               *self._running, *self._preempted)
                   if r.deadline is not None and now >= r.deadline]
        for r in expired:
            self._evict_locked(r)
            self._deadline_total += 1
            r.out.put(DeadlineExceededError(
                f"request {r.id!r} deadline ({r.sampling.deadline_s}s) "
                f"expired after {len(r.generated)} tokens"))
            r.out.put(_DONE)

    # ---------------- priority preemption ----------------

    def _kv_pressure_locked(self) -> float:
        """The fraction of usable blocks a new admission cannot claim:
        allocations, reservations and quarantined blocks count, cached
        prefix blocks (evictable) do not."""
        cache = self.cache
        usable = max(1, cache.cfg.usable_blocks)
        claimable = max(0, cache.available_blocks - cache.reserved_blocks)
        return min(1.0, max(0.0, 1.0 - claimable / usable))

    def _rank_locked(self, r: _Request, now: float) -> int:
        """A request's effective rank at ``now``: its class rank, raised
        above every class once it has waited or sat parked past the aging
        floor. An aged waiter is admitted first; an aged running stream
        (a parked one keeps aging from its park) is never a victim."""
        pc = self._preemption
        rank = PRIORITY_RANK[r.sampling.priority]
        ref = (r.preempted_clock if r.preempted_clock is not None
               else r.submitted_clock)
        if pc is not None and now - ref >= pc.aging_s:
            rank = len(_PRIORITIES)
        return rank

    def _maybe_preempt_locked(self) -> None:
        """Park the lowest-ranked running stream when pool pressure, or
        the wait of the highest-ranked waiter, crosses its threshold; ONE
        victim a step (admission runs right after and sees the freed
        blocks). While pressure holds and no running stream is outranked
        by that waiter (or the parked set is full), ``preempt_exhausted``
        latches True."""
        pc = self._preemption
        if not self._waiting:
            self._preempt_exhausted = False
            return
        now = time.monotonic()
        waiter = max(self._waiting, key=lambda rq: self._rank_locked(rq, now))
        w_rank = self._rank_locked(waiter, now)
        if not (self._kv_pressure_locked() >= pc.kv_pressure
                or now - waiter.submitted_clock >= pc.queue_wait_s):
            self._preempt_exhausted = False
            return
        victims = [r for r in self._running
                   if self._rank_locked(r, now) < w_rank]
        if not victims or len(self._preempted) >= pc.max_preempted:
            self._preempt_exhausted = True
            return
        self._preempt_exhausted = False
        # the lowest class first; within it the youngest stream (the
        # oldest are nearest completion, which frees their blocks for good)
        victim = min(victims, key=lambda r: (self._rank_locked(r, now),
                                             -r.submitted_clock))
        self._preempt_one_locked(victim, now)

    def _preempt_one_locked(self, r: _Request, now: float) -> bool:
        """Park one running stream: reconcile the step in flight (a decode
        graph's ids hold only until its next replay, and the victim may
        complete there: then False), register its chain up to its last
        resident token and demote it to the host tier in one export,
        give its blocks back once and reset the row to its pre-admission
        shape. Its resume re-admits prompt + generated tokens."""
        if self._pending is not None:
            self._reconcile_locked(self._pending)
        if r.done or r not in self._running:
            return False
        chain = r.prompt + r.generated
        # the last emitted token's K/V lands only when it is fed back
        resident = r.total_len - 1
        if self.cfg.prefix_caching:
            self.cache.register_prefix(r.id, chain, resident)
        self.cache.demote_chain(chain, resident)
        self._running.remove(r)
        self._release_blocks_locked(r)
        r.blocks_released = False
        r.reserved_blocks = 0
        r.drawn_blocks = 0
        r.prefill_done = 0
        r.started = False
        r.skips = 0
        r.table_np = None
        r.table_key = None
        r.pending_resume = chain
        r.preempted_clock = now
        r.preempt_count += 1
        self._preempted.append(r)
        self._preempted_total += 1
        return True

    def _maybe_resume_locked(self) -> None:
        """Re-admit parked streams while pressure is at most
        ``resume_pressure``, or unconditionally once a stream's aging
        floor trips; the highest rank first, the oldest park first within
        it, stopping at the first that does not fit. ``preempted_clock``
        stays set: a resumed stream keeps aging from its park, so it is
        soon no longer preemptible."""
        pc = self._preemption
        now = time.monotonic()
        while self._preempted:
            cand = max(self._preempted,
                       key=lambda r: (self._rank_locked(r, now),
                                      -r.preempted_clock))
            aged = now - cand.preempted_clock >= pc.aging_s
            if not aged and self._kv_pressure_locked() > pc.resume_pressure:
                break
            if (len(self._running) + len(self._prefilling)
                    >= self.cfg.max_batch_size):
                break
            if not self._try_admit_one_locked(cand):
                break
            self._preempted.remove(cand)
            self._prefilling.append(cand)

    # ---------------- admission ----------------

    def _try_admit_one_locked(self, req: _Request) -> bool:
        """Reserve the request's worst-case blocks (prompt +
        max_new_tokens; for a resumed stream its chain plus the tokens
        still to generate, the same count), give it a table and map its
        resident prefix; False (no state change) when they do not fit
        right now. A chain resident whole reserves ONE extra block: its
        last token is recomputed for the next token's logits, and that
        write lands in a shared block, so it always makes one
        copy-on-write."""
        bs = self.cfg.block_size
        toks = req.prefill_tokens
        need = self.cache.cfg.blocks_for(
            len(toks) + req.sampling.max_new_tokens - len(req.generated)
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
        """Move waiting requests into the prefilling set, up to the batch
        and prefill limits: in FIFO order, or with preemption on by
        effective rank (a stable sort: FIFO within a rank). When one does
        not fit, probe up to ``admission_probe`` requests behind it,
        unless the head has been skipped ``admission_max_skips`` times;
        then admission waits for the head. Returns the number admitted."""
        if not self._waiting:
            return 0
        if self._preemption is not None and len(self._waiting) > 1:
            now = time.monotonic()
            order = sorted(self._waiting,
                           key=lambda rq: -self._rank_locked(rq, now))
        else:
            order = list(self._waiting)
        head = order[0]
        probe_budget = (self.cfg.admission_probe
                        if head.skips < self.cfg.admission_max_skips else 0)
        admitted = probed = 0
        for req in order:
            if (len(self._running) + len(self._prefilling)
                    >= self.cfg.max_batch_size
                    or admitted >= self.cfg.max_prefill_batch):
                break
            if self._try_admit_one_locked(req):
                self._waiting.remove(req)
                self._waiting_blocks -= self._queued_blocks(req)
                self._prefilling.append(req)
                admitted += 1
            elif probed >= probe_budget:
                break
            else:
                probed += 1
        if admitted and head in self._waiting:
            head.skips += 1  # an admission jumped past the head
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
            remaining = len(r.prefill_tokens) - r.prefill_done
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
            r.prefill_done == 0 and n == len(r.prefill_tokens)
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
            tokens[i, :n] = r.prefill_tokens[r.prefill_done:
                                             r.prefill_done + n]
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
            toks = r.prefill_tokens
            r.prefill_done += n
            self._prefill_tokens_total += n
            if self.cfg.prefix_caching:
                self.cache.register_prefix(r.id, toks, r.prefill_done)
            if r.prefill_done >= len(toks):
                # the final chunk's last-token logits give the next token
                # (a resumed chain's: the keyed sampler at its true
                # position, as an unparked decode step would)
                self._prefilling.remove(r)
                r.pending_resume = None
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
        # speculative draft-and-verify: drafting needs the rows' committed
        # tokens on the host, so a verify step is never dispatched ahead.
        # When any row drafts, collapse the lag, re-draft on the
        # reconciled state and run ONE synchronous verify step; when no
        # row drafts, the plain lag-1 path below runs untouched
        if self._drafter is not None and batch:
            proposals = self._propose_drafts_locked(batch)
            if proposals is not None:
                if pending is not None:
                    self._reconcile_locked(pending)
                    pending = None
                    batch = eligible()
                    proposals = (self._propose_drafts_locked(batch)
                                 if batch else None)
                if batch and proposals is not None:
                    self._verify_locked(batch, proposals)
                    return
        # list equality is element identity here: the same _Request
        # objects in the same order <=> nothing joined, finished or left.
        # A grammar-constrained row collapses the lag every step: the mask
        # of step N+1 is a function of the FSM state after step N's token,
        # which exists on the host only once N's ids are synced
        constrained = any(r.fsm is not None for r in batch)
        steady = (pending is not None and batch == pending.batch
                  and not constrained)
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

    def _propose_drafts_locked(self, batch: list) -> list[list[int]] | None:
        """Up to ``speculative_k`` draft tokens a row from the drafter,
        clamped to the row's remaining budget minus one (so the committed
        tokens, the accepted drafts and one corrected token, never pass
        ``max_new_tokens``, and every speculative K/V write stays inside
        the row's reservation), truncated at the first out-of-vocab id and,
        for a constrained row, at the first token its grammar rejects.
        None when no row drafted anything."""
        k = self.cfg.speculative_k
        V = self.model_cfg.vocab_size
        out: list[list[int]] = []
        any_draft = False
        for r in batch:
            k_eff = min(k, r.sampling.max_new_tokens - len(r.generated)
                        - r.inflight - 1)
            clean: list[int] = []
            if k_eff > 0:
                for t in self._drafter.propose(r.prompt, r.generated, k_eff):
                    t = int(t)
                    if not 0 <= t < V or len(clean) >= k_eff:
                        break
                    clean.append(t)
                if r.fsm is not None and clean:
                    clean = r.fsm.filter_draft(clean)
            out.append(clean)
            any_draft = any_draft or bool(clean)
        return out if any_draft else None

    def _verify_locked(self, batch: list, proposals: list[list[int]]) -> None:
        """One synchronous verify step over ``batch`` (the lag is
        collapsed): stage the [B, W] window (column 0 each row's last
        committed token, then its drafts; W = speculative_k + 1 for every
        step of the engine), replay the verify signature's graph, sync the
        packed [B, W + 1] verdicts at lag 0 (the next window's drafts need
        them) and emit 1..draft_len + 1 tokens a row. EOS inside a window
        stops that row's emission there; its blocks go back once, through
        the completion path (``inflight`` is 0 under a verify)."""
        bs = self.cfg.block_size
        W = self.cfg.speculative_k + 1
        draft_lens = [len(p) for p in proposals]
        self._apply_promotions_locked()
        pairs = []
        for r, dl in zip(batch, draft_lens):
            # the window writes K/V at total_len - 1 .. total_len - 1 + dl
            # (padding columns go to the garbage block)
            eff = r.total_len + dl
            r.drawn_blocks += self.cache.ensure_capacity(r.id, eff)
            cow = self.cache.prepare_write(r.id, r.total_len - 1, eff)
            r.drawn_blocks += len(cow)
            pairs.extend(cow)
        self.executor.copy_blocks(pairs)
        B = pad_to_bucket(len(batch), self._batch_buckets)
        # the table spans what each row HOLDS: a rejected window may have
        # appended blocks past this window's end
        ctx = pad_to_bucket(
            max(max(r.total_len + dl, self.cache.num_allocated(r.id) * bs)
                for r, dl in zip(batch, draft_lens)),
            self._length_buckets,
        )
        nb = ctx // bs
        tokens = self._scratch_buf("vf_tokens", (B, W), np.int32)
        starts = self._scratch_buf("vf_starts", (B,), np.int32)
        dlen = self._scratch_buf("vf_dlen", (B,), np.int32)
        tables = self._scratch_buf("vf_tables", (B, nb), np.int32)
        # reused buffers: re-zero padding (a stale table row could point
        # at blocks now owned by a live sequence)
        tokens[:] = 0
        starts[len(batch):] = 0
        dlen[len(batch):] = 0
        tables[len(batch):] = 0
        for i, (r, props) in enumerate(zip(batch, proposals)):
            tokens[i, 0] = r.generated[-1] if r.generated else r.prompt[-1]
            tokens[i, 1:1 + len(props)] = props
            starts[i] = r.total_len - 1
            dlen[i] = len(props)
            tables[i] = self._table_for(r, nb)
        sample = self._sample_args_locked(batch, B)
        if "mask" in sample:
            # one allow-mask per column: column s is sampled from the FSM
            # state after consuming the row's first s drafts
            vf_mask = self._scratch_buf(
                "vf_mask", (B, W, mask_words(self.model_cfg.vocab_size)),
                np.uint32)
            vf_mask[:] = 0xFFFFFFFF
            for i, (r, props) in enumerate(zip(batch, proposals)):
                if r.fsm is not None:
                    r.fsm.stage_verify_masks(vf_mask[i], props)
            sample["mask"] = vf_mask
        packed_dev = self.executor.verify_step(tokens, starts, dlen, tables,
                                               sample=sample)
        packed = self._sync_verify_locked(packed_dev, len(batch))
        # the sync proves every earlier dispatch executed
        self.cache.flush_quarantine()
        accepted = committed_total = 0
        for i, (r, dl) in enumerate(zip(batch, draft_lens)):
            # the device gives 1 <= committed <= dl + 1; clamped so a bad
            # verdict can never overrun the budget
            committed = max(1, min(int(packed[i, 0]), dl + 1))
            accepted += committed - 1
            for j in range(committed):
                self._emit_token_locked(r, int(packed[i, 1 + j]))
                committed_total += 1
                if r.done:
                    break
        self._running = [r for r in self._running if not r.done]
        self.num_verify_steps += 1
        self._spec_drafted_total += sum(draft_lens)
        self._spec_accepted_total += accepted
        self._spec_committed_total += committed_total

    def _sync_verify_locked(self, packed_dev, rows: int) -> np.ndarray:
        """The verify step's device->host sync: its packed [B, W + 1] int32
        verdicts, metered and recorded as kind "verify" at lag 0."""
        packed = self.executor.sync_verify(packed_dev)
        self._sync_bytes_total += packed.nbytes
        self._flight.append({"kind": "verify", "batch": rows,
                             "sync_bytes": int(packed.nbytes),
                             "sync_lag": 0})
        return packed

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
        greedy so an all-greedy batch skips the sort. A batch that holds a
        grammar-constrained row adds ``mask``, [B, words] uint32 allow-sets
        (all-ones for the other rows, on which the mask is the identity);
        an unconstrained batch stages none."""
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
        out = {"seeds": seeds, "temperature": temp, "top_k": top_k,
               "top_p": top_p}
        if any(r.fsm is not None for r in batch):
            mask = self._scratch_buf(
                "sp_mask", (B, mask_words(self.model_cfg.vocab_size)),
                np.uint32)
            mask[:] = 0xFFFFFFFF
            for i, r in enumerate(batch):
                if r.fsm is not None:
                    mask[i] = r.fsm.allow_row()
            out["mask"] = mask
        return out

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
        is_eos = self.cfg.eos_id is not None and tok == self.cfg.eos_id
        if r.fsm is not None and not is_eos:
            # advance the grammar cursor BEFORE emitting: a rejection ends
            # the stream without the token, so every prefix a client sees
            # is grammar-valid
            if not self._advance_fsm_locked(r, tok):
                self._complete_locked(r)
                return
        r.generated.append(tok)
        r.out.put(tok)
        if (
            len(r.generated) >= r.sampling.max_new_tokens
            or is_eos
            or (r.fsm is not None and r.fsm.must_stop)
            or self._hits_stop_locked(r)
        ):
            self._complete_locked(r)

    def _complete_locked(self, r: _Request) -> None:
        r.done = True
        r.out.put(_DONE)
        # last: a row ending while its next token is in flight defers the
        # free to that step's reconcile (exactly-once release)
        self._release_blocks_locked(r)

    def _advance_fsm_locked(self, r: _Request, tok: int) -> bool:
        """Advance a request's grammar cursor on an emitted (host) token
        id. The device masked the logits, so a rejection here means the
        mask degraded: it is logged and ends the stream, never emitted."""
        try:
            ok = r.fsm.advance(tok)
        except (IndexError, TypeError, ValueError) as e:
            logger.error("grammar FSM advance failed for %r on token %d: %r",
                         r.id, tok, e)
            return False
        if not ok:
            logger.warning(
                "grammar rejected sampled token %d for %r (state=%d, "
                "dead=%s): terminating the stream early",
                tok, r.id, r.fsm.state, r.fsm.dead)
        return ok

    def _hits_stop_locked(self, r: _Request) -> bool:
        """True when the token just emitted completes one of the request's
        stop sequences. The match spans the failover resume boundary: a
        resumed request's delivered tokens are its prompt's last
        ``start_index`` tokens, so a stop sequence straddling the kill
        point still fires."""
        stops = r.sampling.stop
        if not stops:
            return False
        gen = r.generated
        si = r.sampling.start_index
        for seq in stops:
            L = len(seq)
            if L <= len(gen):
                if tuple(gen[-L:]) == seq:
                    return True
            else:
                need = L - len(gen)
                if si >= need and tuple(r.prompt[-need:]) + tuple(gen) == seq:
                    return True
        return False

    def _fan_out_locked(self, err: BaseException) -> None:
        """Fail every live stream with ``err`` and return all blocks."""
        for r in (*self._waiting, *self._prefilling, *self._running,
                  *self._preempted):
            if not r.done:
                r.done = True
                r.out.put(err)
                r.out.put(_DONE)
        self._waiting.clear()
        self._waiting_blocks = 0
        self._prefilling = []
        self._running = []
        self._preempted = []
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
                    # with parked streams only, keep stepping: their
                    # resume waits on the pool or on the aging clock
                    if not (self._stopped or self._waiting
                            or self._prefilling or self._running
                            or self._preempted):
                        self._work.wait(timeout=0.05)
