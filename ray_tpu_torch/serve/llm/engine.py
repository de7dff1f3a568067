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
family's kv heads (``n_kv_head`` for Llama's grouped-query attention). A
Llama config with ``num_experts > 0`` serves Mixture-of-Experts
(``ops/moe.py``; e.g. ``families.llama_125m_moe()``): every row and
column of a step's bucket is routed, padding included, as the JAX engine
routes it, so a stream depends on what it is batched with (its routes
share the experts' capacity); the decode and verify graphs capture the
routed step. Nothing else in the engine knows of experts.
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

Observability and failure, as the JAX engine's: every metric the
reference registers, by its name, in the port's own registry
(``util/metrics.py``; ``obs.py``'s TTFT, TPOT, queue-wait and host-sync
histograms, sync bytes, compile events, goodput and serving MFU); a
timeline per request (``request_timeline``) whose finished events become
``engine.*`` spans (``util/tracing.py``) when the submitter carried a
trace context; one flight record per work step, with its sync's cost
and lag (``debug_dump``); ``autoscaling_snapshot``; and the fail-closed
paths: a step that raises writes one ``engine_died`` dump and fails
every stream with ``EngineDiedError``, and with ``step_timeout_s`` a
watchdog thread fails every stream of a wedged step and writes a
``watchdog_timeout`` dump without the lock and without touching the
device. Every duration reads ``obs.clock`` and every timestamp
``obs.wall``; nothing of it reads a device tensor. The reference's chaos
points fire at their counterpart sites (``_private/chaos.py``).

What the port's engine leaves out of the JAX engine so far: the
disaggregated handoff (``kv_layout``), sharded executors (and with them
expert parallelism), and graphs for prefill (it runs eagerly).
"""
from __future__ import annotations

import dataclasses
import logging
import math
import queue
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch._private import chaos, event_stats
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
from ray_tpu_torch.serve.llm import obs, structured
from ray_tpu_torch.serve.llm.decode import family, mask_words
from ray_tpu_torch.serve.llm.drafter import build_drafter
from ray_tpu_torch.serve.llm.executor import SingleDeviceExecutor
from ray_tpu_torch.serve.llm.kv_cache import (
    KVCacheConfig,
    PagedKVCache,
    _block_key,
)
from ray_tpu_torch.util import metrics, tracing

logger = logging.getLogger("ray_tpu_torch.serve.llm")

_DONE = object()  # stream sentinel

# block-export syncs (demote, export_prefix) kept for debug_dump()
_EXPORT_RECORDS = 256

# window (obs.clock seconds) over which autoscaling_snapshot() turns
# deadline-miss and rejection times into rates
_SIGNAL_RATE_WINDOW_S = 30.0

# window (obs.clock seconds) of per-step (time, tokens) samples behind the
# llm_goodput_tokens_per_sec and llm_serving_mfu gauges
_GOODPUT_WINDOW_S = 30.0


def _pctile(samples, q: float) -> float:
    """Nearest-rank percentile of a small window; 0.0 when empty."""
    if not samples:
        return 0.0
    xs = sorted(samples)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


class _Window:
    """The (clock, seconds, tokens) samples of one step kind within the
    goodput window (at most 1024), with their running sums."""

    MAX = 1024

    def __init__(self):
        self.samples: deque = deque()
        self.seconds = 0.0
        self.tokens = 0

    def add(self, now: float, seconds: float, tokens: int,
            horizon: float) -> None:
        self.samples.append((now, seconds, tokens))
        self.seconds += seconds
        self.tokens += tokens
        while self.samples and (self.samples[0][0] < horizon
                                or len(self.samples) > self.MAX):
            _, s, t = self.samples.popleft()
            self.seconds -= s
            self.tokens -= t
        if not self.samples:
            self.seconds = 0.0


def _window_rate(clocks: deque, now: float) -> float:
    """Events a second over the trailing window; prunes expired ones."""
    while clocks and now - clocks[0] > _SIGNAL_RATE_WINDOW_S:
        clocks.popleft()
    return len(clocks) / _SIGNAL_RATE_WINDOW_S

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
    step_timeout_s: float | None = None    # watchdog: wedged-step ceiling
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
    # flight recorder: the last N step records, dumped as JSON when the
    # engine dies, on a watchdog timeout and on shutdown(dump=...); dir:
    # None -> $RAY_TPU_FLIGHT_DIR -> <tmp>/ray_tpu_flight (obs.dump_dir)
    flight_recorder_steps: int = 256
    flight_recorder_dir: str | None = None
    # finished-request timelines kept for request_timeline()
    timeline_history: int = 256
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
    claim (reservations included); times are ``obs.clock`` seconds."""

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
        # observability: the phase timeline, the submitter's trace context
        # (spans at finish), token clocks, the terminal reason, and the
        # prompt tokens of this admission served by prefix hits
        "trace_ctx", "timeline", "first_token_clock", "last_token_clock",
        "finish_reason", "cached_tokens",
    )

    def __init__(self, req_id, prompt, sampling: SamplingParams,
                 trace_ctx: dict | None = None):
        self.id = req_id
        self.prompt = list(prompt)
        self.sampling = sampling
        self.trace_ctx = trace_ctx
        # [{"event", "ts" (wall), ...}]: submitted, admitted, prefill
        # chunks, first_token, tokens, preempted/resumed, the terminal one
        self.timeline: list[dict] = []
        self.first_token_clock: float | None = None
        self.last_token_clock: float | None = None
        self.finish_reason: str | None = None
        self.cached_tokens = 0
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
        self.submitted_clock = obs.clock()
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
        if self._drafter is not None:
            self.executor.speculative = {
                "speculative_k": cfg.speculative_k,
                "drafter": (cfg.drafter if isinstance(cfg.drafter, str)
                            else type(cfg.drafter).__name__
                            if cfg.drafter is not None else None),
            }
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
        self._watchdog: threading.Thread | None = None
        self._stopped = False
        # set by _fail_engine or the watchdog; read WITHOUT the lock (the
        # watchdog must survive a step wedged while holding it)
        self._failed: EngineDiedError | None = None
        # obs.clock at step entry, None between steps: a plain attribute
        # the watchdog reads lock-free
        self._step_begin: float | None = None
        self._cancelled_total = 0
        # the one in-flight decode step (None when the lag is collapsed)
        self._pending: _PendingDecode | None = None
        # reusable numpy staging, two buffers per (name, shape) (see
        # _scratch_buf)
        self._scratch: dict[tuple, list] = {}
        self._sync_seconds_total = 0.0
        self._sync_bytes_total = 0
        self._last_sync: dict | None = None  # merged into the flight record
        self._prefill_tokens_total = 0  # prompt tokens computed by prefill
        # block exports (demote captures, export_prefix): a device-to-host
        # sync each, recorded apart from the step ring
        self._export_syncs: deque[dict] = deque(maxlen=_EXPORT_RECORDS)
        # "prefill" | "decode" | None: drives prefill/decode alternation
        self.last_step_kind: str | None = None
        # model calls made, by kind ("prefill" counts whole-prompt and
        # chunked prefill calls alike)
        self.num_prefill_calls = 0
        self.num_decode_steps = 0
        self.num_verify_steps = 0       # speculative verify steps
        # cache-stat values already exported to the monotonic counters
        self._exported = {"hit": 0, "evict": 0, "cow": 0, "prefill": 0,
                          "demote": 0, "promote": 0}
        # ---- observability ----
        self._flight = obs.FlightRecorder(cfg.flight_recorder_steps)
        # finished-request timelines, newest last, bounded
        self._timelines: OrderedDict[Any, dict] = OrderedDict()
        # this step's admissions and expiries, for its flight record
        self._step_admitted = 0
        self._step_expired = 0
        # cache-stat values as of the previous flight record (deltas)
        self._flight_prev = {"cow": 0, "evict": 0, "demote": 0,
                             "promote": 0}
        self._dumped = False  # one post-mortem dump per engine
        # bounded windows behind autoscaling_snapshot()
        self._queue_wait_window: deque[float] = deque(maxlen=256)
        self._decode_step_window: deque[float] = deque(maxlen=256)
        self._reject_clocks: deque[float] = deque(maxlen=512)
        self._deadline_clocks: deque[float] = deque(maxlen=512)
        self._last_snapshot: dict | None = None

        self._m_tokens = metrics.counter(
            "llm_engine_tokens_generated",
            "Tokens generated by the serve/llm engine",
        )
        self._m_queue = metrics.gauge(
            "llm_engine_queue_depth", "Requests waiting for admission"
        )
        self._m_util = metrics.gauge(
            "llm_engine_kv_block_utilization",
            "Fraction of usable KV blocks allocated",
        )
        self._m_latency = metrics.histogram(
            "llm_engine_step_latency_seconds",
            "Engine step latency by kind (prefill/decode)",
            boundaries=(0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0),
            tag_keys=("kind",),
        )
        self._m_rejected = metrics.counter(
            "llm_requests_rejected",
            "Requests rejected by engine admission control (overload)",
        )
        self._m_cancelled = metrics.counter(
            "llm_requests_cancelled",
            "Requests cancelled (client disconnect / explicit cancel)",
        )
        self._m_deadline = metrics.counter(
            "llm_deadline_exceeded",
            "Requests evicted because deadline_s expired mid-generation",
        )
        self._m_finished = metrics.counter(
            "llm_requests_finished",
            "Requests that completed generation normally (availability "
            "SLO denominator)",
        )
        self._m_hit_tokens = metrics.counter(
            "llm_prefix_hit_tokens",
            "Prompt tokens served from the KV prefix cache (zero compute)",
        )
        self._m_evicted = metrics.counter(
            "llm_prefix_evicted_blocks",
            "Cached KV blocks evicted LRU to satisfy new allocations",
        )
        self._m_cow = metrics.counter(
            "llm_cow_blocks",
            "Copy-on-write block copies (writes into shared KV blocks)",
        )
        self._m_prefill_tokens = metrics.counter(
            "llm_prefill_tokens",
            "Prompt tokens actually computed by prefill (cache misses)",
        )
        self._m_spec_drafted = metrics.counter(
            "llm_spec_drafted_tokens",
            "Draft tokens proposed to speculative verify steps",
        )
        self._m_spec_accepted = metrics.counter(
            "llm_spec_accepted_tokens",
            "Draft tokens accepted by speculative verify steps",
        )
        self._m_spec_committed = metrics.counter(
            "llm_spec_committed_tokens",
            "Tokens committed by speculative verify steps (accepted + "
            "corrected/bonus)",
        )
        self._m_demoted = metrics.counter(
            "llm_kv_demoted_blocks",
            "KV blocks demoted from the device pool into the host cache "
            "tier on LRU eviction",
        )
        self._m_promoted = metrics.counter(
            "llm_kv_promoted_blocks",
            "Host-tier KV blocks promoted back into the device pool on "
            "prefix hits",
        )
        self._m_host_blocks = metrics.gauge(
            "llm_host_cache_blocks",
            "Demoted KV blocks resident in the host cache tier",
        )
        self._m_structured = metrics.counter(
            "llm_structured_requests",
            "Requests admitted with a grammar constraint "
            "(response_format / SamplingParams.structured)",
        )
        self._m_masked_frac = metrics.histogram(
            "llm_structured_masked_fraction",
            "Fraction of the vocab banned by the grammar allow-mask at "
            "each constrained decode position",
            boundaries=(0.5, 0.9, 0.99, 0.995, 0.999, 0.9999),
        )
        self._m_ttft = obs.ttft_histogram()
        self._m_tpot = obs.tpot_histogram()
        self._m_queue_wait = obs.queue_wait_histogram()
        self._m_sync = obs.host_sync_histogram()
        self._m_sync_bytes = obs.sync_bytes_counter()
        self._m_compile = obs.compile_counter()
        self._m_devices = metrics.gauge(
            "llm_executor_devices",
            "Devices driven by this engine's model executor",
        )
        self._m_devices.set(self.executor.num_devices)
        # autoscaling signals, refreshed by every snapshot
        self._m_as_queue = metrics.gauge(
            "llm_queue_depth",
            "Admission queue depth as seen by the autoscaler",
        )
        self._m_as_kv_free = metrics.gauge(
            "llm_kv_free_blocks",
            "Truly free (unallocated, uncached) KV blocks in the pool",
        )
        self._m_as_kv_pressure = metrics.gauge(
            "llm_kv_pool_pressure",
            "Fraction of the usable KV pool a new admission cannot claim "
            "(allocations + reservations + quarantine)",
        )
        self._m_preemptions = metrics.counter(
            "llm_preemptions_total",
            "Running streams paused to the host KV tier to make room for "
            "higher-priority work",
        )
        self._m_preempted_streams = metrics.gauge(
            "llm_preempted_streams",
            "Streams currently parked in the preempted state",
        )
        self._m_preempted_wait = metrics.histogram(
            "llm_preempted_wait_seconds",
            "Seconds a preempted stream spent parked before resuming",
            boundaries=(0.01, 0.05, 0.25, 1.0, 5.0, 30.0, 120.0),
        )
        # serving goodput and MFU: 2 FLOPs a weight a token (forward only)
        # over the executor's peak
        self._flops_per_token = 2.0 * self.executor.num_params
        self._peak_flops = self.executor.peak_tflops * 1e12
        # per step kind: a window of (clock, step seconds, tokens) and the
        # last derived rates
        self._goodput_windows: dict[str, _Window] = {}
        self._goodput_last: dict[str, dict] = {}
        self._m_goodput = obs.goodput_gauge()
        self._m_mfu = obs.mfu_gauge()
        # compile events by shape key, at each new signature of DecodeFns
        self.executor.on_new_signature = self._on_new_signature

    # ---------------- public API ----------------

    def submit(
        self,
        prompt: Sequence[int],
        sampling: SamplingParams | None = None,
        *,
        trace_ctx: dict | None = None,
        **sampling_overrides,
    ) -> TokenStream:
        """Enqueue one request; returns a stream of generated token ids.

        ``trace_ctx`` (``tracing.current_context()``'s shape; the
        submitting thread's active span when None) makes the request's
        timeline ``engine.*`` spans on its trace when it finishes. Raises
        ``EngineOverloadedError`` past the admission limits and
        ``EngineDiedError`` once the engine has failed."""
        if trace_ctx is None:
            trace_ctx = tracing.current_context()
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
            self._m_structured.inc()
        if self._failed is not None:
            raise self._failed
        with self._lock:
            if self._stopped:
                raise RuntimeError("engine is shut down")
            if self._failed is not None:  # failed while this waited
                raise self._failed
            if len(self._waiting) >= self.cfg.max_waiting or (
                self.cfg.max_waiting_blocks is not None
                and self._waiting_blocks + need > self.cfg.max_waiting_blocks
            ):
                self._rejected_total += 1
                self._m_rejected.inc()
                self._reject_clocks.append(obs.clock())
                raise EngineOverloadedError(
                    f"admission queue full ({len(self._waiting)} waiting, "
                    f"{self._waiting_blocks} worst-case blocks queued); "
                    "retry later"
                )
            req = _Request(self._next_id, prompt, sampling, trace_ctx)
            req.fsm = fsm
            self._next_id += 1
            self._tl(req, "submitted", prompt_tokens=len(prompt),
                     max_new_tokens=sampling.max_new_tokens)
            self._waiting.append(req)
            self._waiting_blocks += need
            self._m_queue.set(len(self._waiting))
            self._work.notify_all()
        failed = self._failed
        if failed is not None and not req.done:
            # the watchdog fans out without the lock: it set _failed after
            # the check above and may have listed the queue before the
            # append, so this stream is failed here
            req.done = True
            req.out.put(failed)
            req.out.put(_DONE)
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
            self._step_begin = obs.clock()
            try:
                chaos.fire("engine.step")
                self._step_expired = self._expire_deadlines_locked()
                if self._preemption is not None:
                    self._maybe_resume_locked()
                    self._maybe_preempt_locked()
                self._step_admitted = self._admit_locked()
                if self._prefilling and (
                    self.last_step_kind != "prefill"
                    or not self._running
                    or any(not r.started for r in self._prefilling)
                ):
                    self._prefill_chunk_locked()
                    self.last_step_kind = "prefill"
                    return True
                if self._running or self._pending is not None:
                    # a pending step with nothing running still needs a
                    # step: its tokens are reconciled, its blocks freed
                    self._decode_locked()
                    self.last_step_kind = "decode"
                    return True
                return False
            finally:
                self._step_begin = None

    def cancel(self, request_id) -> bool:
        """Evict a waiting/prefilling/running request, fail its stream with
        ``RequestCancelledError`` and return its KV blocks at once. False
        when the request is unknown or already finished."""
        with self._lock:
            req = self._find_locked(request_id)
            if req is None:
                return False
            self._evict_locked(req)
            self._cancelled_total += 1
            self._m_cancelled.inc()
            self._finish_obs_locked(req, "cancelled")
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
                "cancelled_total": self._cancelled_total,
                "deadline_exceeded_total": self._deadline_total,
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
                "host_sync_seconds_total": round(
                    self._sync_seconds_total, 6),
                "host_sync_bytes_total": self._sync_bytes_total,
                "decode_inflight": 1 if self._pending is not None else 0,
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
                "goodput": {k: dict(v)
                            for k, v in self._goodput_last.items()},
                "executor": self.executor.describe(),
                "failed": self._failed is not None,
            }

    @property
    def fns(self):
        """The executor's ``DecodeFns`` (signature accounting, graphs)."""
        return self.executor.fns

    @property
    def num_compiled_shapes(self) -> int:
        return self.fns.num_compiled_shapes

    @property
    def failed(self) -> bool:
        """True once a step raised or the watchdog fired (the Serve
        replica's health check reads it)."""
        return self._failed is not None

    def request_timeline(self, request_id) -> dict | None:
        """One request's phase timeline, live or recently finished:
        ``{"request_id", "trace_id", "finish_reason", "events"}``, each
        event ``{"event", "ts" (wall seconds), ...}``: submitted,
        admitted, prefill / prefill_chunk, first_token, token, preempted,
        resumed and the terminal one (finished, cancelled, expired,
        failed, shutdown). The last ``timeline_history`` finished ones are
        kept; None for an unknown id."""
        with self._lock:
            r = self._find_locked(request_id)
            if r is not None:
                return self._timeline_dict(r)
            return self._timelines.get(request_id)

    def autoscaling_snapshot(self) -> dict:
        """Saturation signals for an autoscaler: queue depth (by priority
        class too) and its wait p95, the pool's pressure and free, cached,
        quarantined and host blocks, deadline-miss and rejection rates
        over a trailing window, the decode-step p50, parked streams and
        the ``preempt_exhausted`` latch. Host state only. Refreshes the
        ``llm_queue_depth``, ``llm_kv_free_blocks`` and
        ``llm_kv_pool_pressure`` gauges and adds a flight record
        (kind ``"autoscale_snapshot"``)."""
        with self._lock:
            return self._autoscaling_snapshot_locked()

    def _autoscaling_snapshot_locked(self, record: bool = True) -> dict:
        now = obs.clock()
        cache = self.cache
        usable = max(1, cache.cfg.usable_blocks)
        snap = cache.debug_snapshot()
        # the number the preemption trigger reads (_kv_pressure_locked)
        pressure = self._kv_pressure_locked()
        # host-resident blocks are cheaper to miss into than recompute:
        # they discount the device pressure, bounded at zero
        pressure_two_tier = max(0.0, pressure - snap["host_blocks"] / usable)
        out = {
            "ts_wall": obs.wall(),
            "clock": now,
            "queue_depth": len(self._waiting),
            "queue_wait_p95_s": round(
                _pctile(self._queue_wait_window, 0.95), 6),
            "decode_step_p50_s": round(
                _pctile(self._decode_step_window, 0.50), 6),
            "kv_free_blocks": snap["free_blocks"],
            "kv_cached_blocks": snap["cached_blocks"],
            "kv_quarantined_blocks": snap["quarantined_blocks"],
            "kv_pool_pressure": round(pressure, 4),
            "kv_host_cached_blocks": snap["host_blocks"],
            "kv_host_cache_bytes": snap["host_bytes"],
            "kv_pressure_two_tier": round(pressure_two_tier, 4),
            "prefix_digests": cache.prefix_digest_summary(),
            "block_size": cache.cfg.block_size,
            "vocab_size": self.model_cfg.vocab_size,
            "deadline_miss_rate": round(
                _window_rate(self._deadline_clocks, now), 4),
            "rejection_rate": round(_window_rate(self._reject_clocks, now), 4),
            "running": len(self._running),
            "prefilling": len(self._prefilling),
            "queue_depth_by_class": {
                p: sum(1 for r in self._waiting if r.sampling.priority == p)
                for p in _PRIORITIES
            },
            "preempted_streams": len(self._preempted),
            "preempt_exhausted": self._preempt_exhausted,
            "failed": self._failed is not None,
        }
        self._m_as_queue.set(out["queue_depth"])
        self._m_as_kv_free.set(out["kv_free_blocks"])
        self._m_as_kv_pressure.set(out["kv_pool_pressure"])
        self._last_snapshot = out
        if record:  # debug_dump() observes without touching the ring
            self._flight.record(dict(out, kind="autoscale_snapshot",
                                     ts=out["ts_wall"]))
        return out

    def debug_dump(self) -> dict:
        """One post-mortem of the engine: the flight ring (``steps``: one
        record a work step, with its sync's ``sync_ms``, ``sync_bytes``
        and ``sync_lag``; compile and snapshot records), ``stats()``,
        ``executor.describe()``, the pool's accounting, a fresh
        autoscaling snapshot, the compiled shapes, the process's event
        stats, the live trace ids and the block-export syncs
        (``export_syncs``: demote captures and ``export_prefix``)."""
        with self._lock:
            return self._flight.dump("debug", extra={
                "stats": self.stats(),
                "executor": self.executor.describe(),
                "cache": self.cache.debug_snapshot(),
                "autoscaling_snapshot": self._autoscaling_snapshot_locked(
                    record=False),
                "compiled_shapes": sorted(
                    obs.shape_key(s) for s in self.fns.shapes),
                "archived_timelines": len(self._timelines),
                "live_trace_ids": self._trace_ids_locked(
                    list(self._waiting) + self._prefilling
                    + self._running + self._preempted),
                "export_syncs": list(self._export_syncs),
            })

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

    def shutdown(self, dump: bool | str | None = None) -> None:
        """Stop stepping, fail every pending stream and return all KV
        blocks to the pool. ``dump=True`` writes a flight-recorder dump to
        the dump dir on the way out; a string is the file's path."""
        with self._lock:
            if self._stopped:
                return
            if dump:
                self._dump("shutdown",
                           path=dump if isinstance(dump, str) else None)
            self._stopped = True
            self._fan_out_locked(RequestCancelledError("engine shut down"),
                                 "shutdown")
            self._m_queue.set(0)
            self._m_util.set(self.cache.utilization)
            self._work.notify_all()
        for t in (self._thread, self._watchdog):
            if t is not None:
                t.join(timeout=5)
        self._thread = None
        self._watchdog = None

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
            self._m_preempted_streams.set(len(self._preempted))
        else:
            self._waiting.remove(r)
            self._waiting_blocks -= self._queued_blocks(r)
        r.done = True  # before release: an in-flight row defers it
        self._release_blocks_locked(r)
        self._m_queue.set(len(self._waiting))
        self._m_util.set(self.cache.utilization)
        self._work.notify_all()

    def _queued_blocks(self, r: _Request) -> int:
        """The worst-case blocks a waiting request counts against
        ``max_waiting_blocks``."""
        return self.cache.cfg.blocks_for(
            len(r.prompt) + r.sampling.max_new_tokens)

    def _expire_deadlines_locked(self) -> int:
        """Evict every request whose deadline passed (blocks back once,
        deferred past an in-flight step as any eviction), fail its stream
        with ``DeadlineExceededError`` and end it. -> how many."""
        now = obs.clock()
        expired = [r for r in (*self._waiting, *self._prefilling,
                               *self._running, *self._preempted)
                   if r.deadline is not None and now >= r.deadline]
        for r in expired:
            self._evict_locked(r)
            self._deadline_total += 1
            self._m_deadline.inc()
            self._deadline_clocks.append(obs.clock())
            self._finish_obs_locked(r, "expired")
            r.out.put(DeadlineExceededError(
                f"request {r.id!r} deadline ({r.sampling.deadline_s}s) "
                f"expired after {len(r.generated)} tokens"))
            r.out.put(_DONE)
        return len(expired)

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
        now = obs.clock()
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
        chaos.fire("llm.preempt", request=r.id, priority=r.sampling.priority)
        if self._pending is not None:
            self._reconcile_locked(self._pending)
        if r.done or r not in self._running:
            return False
        chain = r.prompt + r.generated
        # the last emitted token's K/V lands only when it is fed back
        resident = r.total_len - 1
        if self.cfg.prefix_caching:
            self.cache.register_prefix(r.id, chain, resident)
        demoted = self.cache.demote_chain(chain, resident,
                                          trace_ctx=r.trace_ctx)
        self._running.remove(r)
        self._release_blocks_locked(r)
        r.blocks_released = False
        r.reserved_blocks = 0
        r.drawn_blocks = 0
        r.prefill_done = 0
        r.cached_tokens = 0
        r.started = False
        r.skips = 0
        r.table_np = None
        r.table_key = None
        r.pending_resume = chain
        r.preempted_clock = now
        r.preempt_count += 1
        self._preempted.append(r)
        self._preempted_total += 1
        self._m_preemptions.inc()
        self._m_preempted_streams.set(len(self._preempted))
        self._m_util.set(self.cache.utilization)
        self._tl(r, "preempted", generated=len(r.generated),
                 priority=r.sampling.priority, demoted_blocks=demoted)
        return True

    def _maybe_resume_locked(self) -> None:
        """Re-admit parked streams while pressure is at most
        ``resume_pressure``, or unconditionally once a stream's aging
        floor trips; the highest rank first, the oldest park first within
        it, stopping at the first that does not fit. ``preempted_clock``
        stays set: a resumed stream keeps aging from its park, so it is
        soon no longer preemptible."""
        pc = self._preemption
        now = obs.clock()
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
            parked = now - cand.preempted_clock
            self._m_preempted_wait.observe(parked)
            self._m_preempted_streams.set(len(self._preempted))
            chaos.fire("llm.resume_preempted", request=cand.id,
                       parked_s=parked)
            self._tl(cand, "resumed", parked_ms=round(parked * 1000.0, 3),
                     cached_tokens=cand.cached_tokens)

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
            promoted0 = self.cache.stats.promoted_blocks
            hit_tokens = self.cache.assign_prefix(req.id, toks,
                                                  max_blocks=max_hit_blocks)
            req.drawn_blocks += hit_tokens // bs
            # a full-chain hit still recomputes the LAST token
            req.prefill_done = min(hit_tokens, len(toks) - 1)
            req.cached_tokens = req.prefill_done
            promoted = self.cache.stats.promoted_blocks - promoted0
            if req.trace_ctx and promoted:
                # host-tier promotions for THIS admission, on its trace
                self._tl(req, "kv_promote", blocks=promoted,
                         hit_tokens=hit_tokens)
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
            now = obs.clock()
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
                wait = obs.clock() - req.submitted_clock
                self._m_queue_wait.observe(wait)
                self._queue_wait_window.append(wait)
                self._tl(req, "admitted", cached_tokens=req.cached_tokens,
                         reserved_blocks=req.reserved_blocks)
            elif probed >= probe_budget:
                break
            else:
                probed += 1
        if admitted:
            if head in self._waiting:
                head.skips += 1  # an admission jumped past the head
            self._m_queue.set(len(self._waiting))
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
        chaos.fire("llm.kv.promote", blocks=len(staged))
        ids = [b for b, _, _ in staged]
        self.executor.land_blocks(
            ids,
            stack_blocks([k for _, k, _ in staged], axis=1),
            stack_blocks([v for _, _, v in staged], axis=1),
        )
        self.cache.promotions_landed(ids)

    def _metered_export(self, block_ids: list[int], kind: str):
        """``executor.export_blocks``, a device-to-host sync (it waits for
        every step queued before it), recorded in ``debug_dump()``'s
        ``export_syncs`` as ``kind`` ("demote" or "export"), with its
        blocks, bytes, ms and whether a step was in flight."""
        t0 = obs.clock()
        k, v = self.executor.export_blocks(block_ids)
        self._export_syncs.append({
            "kind": kind, "batch": len(block_ids),
            "sync_bytes": int(kv_ops.planes_nbytes(k, v)),
            "sync_ms": round((obs.clock() - t0) * 1000.0, 3),
            "sync_lag": 0 if self._pending is None else 1})
        return k, v

    def _prefill_chunk_locked(self) -> None:
        """ONE prefill call for up to ``max_prefill_batch`` admitted
        requests, each contributing its next chunk. Whole cold prompts
        take the fresh path (start=None); anything mid-prompt or
        prefix-seeded takes the chunked path at true positions."""
        batch = self._prefilling[: self.cfg.max_prefill_batch]
        chaos.fire("engine.prefill", batch=len(batch))
        if self._failed is not None:
            return  # the watchdog failed the engine during the delay above
        t0 = obs.clock()
        t0_wall = obs.wall()
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
        host = self._sync_tokens_locked(toks_dev, lag=0)
        self.num_prefill_calls += 1
        # one duration for the histogram, the flight record, event stats
        # and the rows' timeline entries: copies, staging, the call and
        # the sync
        dt = obs.clock() - t0
        kind = "prefill" if fresh else "prefill_chunk"
        for i, (r, n) in enumerate(zip(batch, ns)):
            toks = r.prefill_tokens
            r.prefill_done += n
            self._prefill_tokens_total += n
            self._tl(r, kind, ts=t0_wall, dur_ms=round(dt * 1000.0, 3),
                     tokens=n, prefill_done=r.prefill_done)
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
        self._step_done_locked(kind, t0_wall, dt, sum(ns), batch=len(batch),
                               bucket_b=B, bucket_len=S, nb=nb,
                               tokens=int(sum(ns)),
                               trace_ids=self._trace_ids_locked(batch))

    def _decode_locked(self) -> None:
        """One pipelined decode iteration. Steady state (the eligible
        batch is exactly the batch of the step in flight): dispatch step
        N+1 fed from step N's ids on the device, THEN sync N's ids, so the
        host work above the dispatch overlaps N on the device and the
        sync finds N done. Any batch change first collapses the lag:
        reconcile the pending step, rebuild the batch and dispatch from
        host tokens."""
        chaos.fire("engine.decode", batch=len(self._running))
        if self._failed is not None:
            return  # the watchdog failed the engine during the delay above
        t0 = obs.clock()
        t0_wall = obs.wall()
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
        emitted = 0
        # speculative draft-and-verify: drafting needs the rows' committed
        # tokens on the host, so a verify step is never dispatched ahead.
        # When any row drafts, collapse the lag, re-draft on the
        # reconciled state and run ONE synchronous verify step; when no
        # row drafts, the plain lag-1 path below runs untouched
        if self._drafter is not None and batch:
            proposals = self._propose_drafts_locked(batch)
            if proposals is not None:
                if pending is not None:
                    emitted += self._reconcile_locked(pending)
                    pending = None
                    batch = eligible()
                    proposals = (self._propose_drafts_locked(batch)
                                 if batch else None)
                if batch and proposals is not None:
                    self._verify_locked(batch, proposals, t0, t0_wall,
                                        emitted)
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
            emitted += self._reconcile_locked(pending)
            pending = None
            batch = eligible()
        if not batch:
            # a drain step: the reconcile above retired the lag; recorded,
            # so the ring shows the lag collapsing
            self._step_done_locked("decode", t0_wall, obs.clock() - t0,
                                   emitted, batch=0, tokens=emitted)
            return
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
            emitted += self._reconcile_locked(pending)
        dt = obs.clock() - t0
        self._decode_step_window.append(dt)
        self._step_done_locked("decode", t0_wall, dt, emitted,
                               batch=len(batch), bucket_b=B, bucket_len=ctx,
                               nb=nb, tokens=emitted,
                               trace_ids=self._trace_ids_locked(batch))

    def _reconcile_locked(self, pending: _PendingDecode) -> int:
        """Collapse the lag for one in-flight decode step: sync its ids,
        flush the quarantine (the sync proves every earlier dispatch
        executed), then emit per row. Rows that ended after the dispatch
        (EOS raced the lag, cancel) drop their speculative token and
        release their blocks, exactly once. -> tokens emitted."""
        if self._pending is pending:
            self._pending = None
        toks = self._sync_tokens_locked(pending.tokens, lag=1)
        self.cache.flush_quarantine()
        emitted = 0
        for i, r in enumerate(pending.batch):
            r.inflight -= 1
            if r.done:
                self._release_blocks_locked(r)
            else:
                self._emit_token_locked(r, int(toks[i]))
                emitted += 1
        self._running = [r for r in self._running if not r.done]
        return emitted

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

    def _verify_locked(self, batch: list, proposals: list[list[int]],
                       t0: float, t0_wall: float, emitted: int) -> None:
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
            if r.trace_ctx:
                # a traced row's window outcome (one engine.verify span)
                self._tl(r, "verify_window", ts=t0_wall,
                         dur_ms=round((obs.clock() - t0) * 1000.0, 3),
                         drafted=dl, accepted=committed - 1, window=W)
            for j in range(committed):
                self._emit_token_locked(r, int(packed[i, 1 + j]))
                committed_total += 1
                if r.done:
                    break
        self._running = [r for r in self._running if not r.done]
        drafted = sum(draft_lens)
        self.num_verify_steps += 1
        self._spec_drafted_total += drafted
        self._spec_accepted_total += accepted
        self._spec_committed_total += committed_total
        if drafted:
            self._m_spec_drafted.inc(drafted)
        if accepted:
            self._m_spec_accepted.inc(accepted)
        self._m_spec_committed.inc(committed_total)
        dt = obs.clock() - t0
        self._decode_step_window.append(dt)
        self._step_done_locked("verify", t0_wall, dt,
                               emitted + committed_total, batch=len(batch),
                               bucket_b=B, bucket_len=ctx, nb=nb, window=W,
                               drafted=drafted, accepted=accepted,
                               tokens=emitted + committed_total,
                               trace_ids=self._trace_ids_locked(batch))

    def _sync_verify_locked(self, packed_dev, rows: int) -> np.ndarray:
        """The verify step's device->host sync: its packed [B, W + 1] int32
        verdicts (``rows`` of them real), timed and metered at lag 0."""
        t0 = obs.clock()
        packed = self.executor.sync_verify(packed_dev)
        self._metered_sync(obs.clock() - t0, packed.nbytes, lag=0)
        return packed

    def _sync_tokens_locked(self, ids, *, lag: int) -> np.ndarray:
        """THE device->host sync: a step's O(batch) int32 ids, timed and
        metered. ``lag`` is the number of dispatches between the step that
        made them and this sync (0: prefill's immediate sync; 1: the
        pipelined decode); it lands in the step's flight record."""
        t0 = obs.clock()
        toks = self.executor.sync_tokens(ids)
        self._metered_sync(obs.clock() - t0, toks.nbytes, lag=lag)
        return toks

    def _metered_sync(self, dt: float, nbytes: int, *, lag: int) -> None:
        self._m_sync.observe(dt)
        self._m_sync_bytes.inc(nbytes)
        self._sync_seconds_total += dt
        self._sync_bytes_total += nbytes
        self._last_sync = {"sync_ms": round(dt * 1000.0, 3),
                           "sync_bytes": int(nbytes), "sync_lag": lag}

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
                    self._m_masked_frac.observe(r.fsm.masked_fraction())
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
        now = obs.clock()
        index = r.sampling.start_index + len(r.generated) - 1
        if r.first_token_clock is None:
            r.first_token_clock = now
            self._m_ttft.observe(now - r.submitted_clock)
            self._tl(r, "first_token", index=index)
        else:
            self._m_tpot.observe(now - r.last_token_clock)
            self._tl(r, "token", index=index)
        r.last_token_clock = now
        r.out.put(tok)
        self._m_tokens.inc()
        if (
            len(r.generated) >= r.sampling.max_new_tokens
            or is_eos
            or (r.fsm is not None and r.fsm.must_stop)
            or self._hits_stop_locked(r)
        ):
            self._complete_locked(r)

    def _complete_locked(self, r: _Request) -> None:
        r.done = True
        self._finish_obs_locked(r, "finished")
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

    def _sync_cache_counters_locked(self) -> None:
        """Export the cache stats' growth since the last export to the
        monotonic counters (the stats are plain ints)."""
        cs = self.cache.stats
        for key, value, counter in (
            ("hit", cs.prefix_hit_tokens, self._m_hit_tokens),
            ("evict", cs.prefix_evicted_blocks, self._m_evicted),
            ("cow", cs.cow_copies, self._m_cow),
            ("prefill", self._prefill_tokens_total, self._m_prefill_tokens),
            ("demote", cs.demoted_blocks, self._m_demoted),
            ("promote", cs.promoted_blocks, self._m_promoted),
        ):
            delta = value - self._exported[key]
            if delta > 0:
                counter.inc(delta)
                self._exported[key] = value
        tier = self.cache.host_tier
        self._m_host_blocks.set(0 if tier is None else tier.blocks)

    def _step_done_locked(self, kind: str, t_wall: float, dt: float,
                          retired: int, **fields) -> None:
        """A work step's bookkeeping: the utilization gauge, the cache
        counters, the step-latency histogram, goodput (``retired``
        tokens), event stats and one flight record (``fields`` join it)."""
        self._m_util.set(self.cache.utilization)
        self._sync_cache_counters_locked()
        self._m_latency.observe(dt, tags={"kind": kind})
        self._goodput_record_locked(kind, dt, int(retired))
        event_stats.record(f"llm.engine.step.{kind}", dt)
        self._flight_record_locked(kind, t_wall, dt, **fields)

    def _goodput_record_locked(self, kind: str, dt: float,
                               tokens: int) -> None:
        """Fold one step's (seconds, tokens) into the windowed goodput and
        MFU gauges of its kind. ``dt`` is the step's host clock: on the
        lag-1 steady path it approximates one device step (dispatching
        N + 1 overlaps N on the device); on lag-0 paths (prefill, verify,
        a drain) it includes the blocking sync (the reference's "lag-1
        caveat"). MFU: goodput x 2 n_params FLOPs a token over the
        executor's peak. O(1) a step: the window keeps running sums (the
        reference sums its up to 1024 samples every step)."""
        now = obs.clock()
        win = self._goodput_windows.get(kind)
        if win is None:
            win = self._goodput_windows[kind] = _Window()
        win.add(now, float(dt), int(tokens), now - _GOODPUT_WINDOW_S)
        dev_s, toks = win.seconds, win.tokens
        if dev_s <= 0.0 or toks <= 0:
            return
        tps = toks / dev_s
        mfu = (tps * self._flops_per_token / self._peak_flops
               if self._peak_flops > 0.0 else 0.0)
        self._m_goodput.set(tps, tags={"kind": kind})
        self._m_mfu.set(mfu, tags={"kind": kind})
        self._goodput_last[kind] = {
            "tokens_per_sec": round(tps, 3),
            "mfu": round(mfu, 6),
            "window_steps": len(win.samples),
            "window_device_s": round(dev_s, 6),
            "window_tokens": toks,
        }

    # ---------------- observability ----------------

    def _tl(self, r: _Request, event: str, ts: float | None = None,
            **attrs) -> None:
        """Append one phase event to a request's timeline."""
        e = {"event": event, "ts": obs.wall() if ts is None else ts}
        if attrs:
            e.update(attrs)
        r.timeline.append(e)

    def _timeline_dict(self, r: _Request) -> dict:
        return {
            "request_id": r.id,
            "trace_id": r.trace_ctx["trace_id"] if r.trace_ctx else None,
            "finish_reason": r.finish_reason,
            "events": list(r.timeline),
        }

    def _finish_obs_locked(self, r: _Request, reason: str) -> None:
        """A request's terminal bookkeeping, once: the terminal timeline
        event, the archived timeline and, for a traced request, its
        spans."""
        if r.finish_reason is not None:
            return
        r.finish_reason = reason
        if reason == "finished":
            self._m_finished.inc()
        self._tl(r, reason, tokens=len(r.generated))
        self._timelines[r.id] = self._timeline_dict(r)
        while len(self._timelines) > self.cfg.timeline_history:
            self._timelines.popitem(last=False)
        if r.trace_ctx:
            try:
                self._emit_spans(r)
            except Exception as e:  # noqa: BLE001 — spans are best-effort
                logger.warning("span emission failed for %r: %r", r.id, e)

    def _emit_spans(self, r: _Request) -> None:
        """A finished request's timeline as spans: one ``engine.request``
        under the submitter's span, with ``engine.queued``, one
        ``engine.prefill[_chunk]`` a chunk, an ``engine.first_token``
        marker, ``engine.preempted`` a park, ``kv.promote`` markers, one
        ``engine.verify`` over the speculation windows and one
        ``engine.decode`` over the tokens."""
        tid = r.trace_ctx["trace_id"]
        events = r.timeline
        start = events[0]["ts"]
        end = events[-1]["ts"]
        ttft_ts = next(
            (e["ts"] for e in events if e["event"] == "first_token"), None)
        root = tracing.record_span(
            "engine.request", trace_id=tid,
            parent_span_id=r.trace_ctx.get("parent_span_id"),
            start=start, end=end, kind="engine",
            attrs={
                "request_id": str(r.id),
                "finish_reason": r.finish_reason,
                "prompt_tokens": len(r.prompt),
                "cached_tokens": r.cached_tokens,
                "tokens": len(r.generated),
                "preempt_count": r.preempt_count,
                "ttft_s": (round(ttft_ts - start, 6)
                           if ttft_ts is not None else None),
            },
        )
        first_ts = last_ts = None
        decode_tokens = 0
        preempted_at: dict | None = None
        verify_windows = drafted = v_accepted = 0
        v_start = v_end = None
        for e in events:
            ev = e["event"]
            if ev == "admitted":
                tracing.record_span(
                    "engine.queued", trace_id=tid, parent_span_id=root,
                    start=start, end=e["ts"], kind="engine", attrs={})
            elif ev in ("prefill", "prefill_chunk"):
                tracing.record_span(
                    f"engine.{ev}", trace_id=tid, parent_span_id=root,
                    start=e["ts"],
                    end=e["ts"] + e.get("dur_ms", 0.0) / 1000.0,
                    kind="engine",
                    attrs={"tokens": e.get("tokens"),
                           "prefill_done": e.get("prefill_done")})
            elif ev == "first_token":
                first_ts = last_ts = e["ts"]
                tracing.record_span(
                    "engine.first_token", trace_id=tid,
                    parent_span_id=root, start=e["ts"], end=e["ts"],
                    kind="marker", attrs={"index": e.get("index")})
            elif ev == "token":
                last_ts = e["ts"]
                decode_tokens += 1
            elif ev == "preempted":
                preempted_at = e
            elif ev == "resumed" and preempted_at is not None:
                tracing.record_span(
                    "engine.preempted", trace_id=tid, parent_span_id=root,
                    start=preempted_at["ts"], end=e["ts"], kind="engine",
                    attrs={"parked_ms": e.get("parked_ms"),
                           "priority": preempted_at.get("priority"),
                           "demoted_blocks":
                               preempted_at.get("demoted_blocks"),
                           "cached_tokens": e.get("cached_tokens")})
                preempted_at = None
            elif ev == "verify_window":
                verify_windows += 1
                drafted += e.get("drafted", 0)
                v_accepted += e.get("accepted", 0)
                if v_start is None:
                    v_start = e["ts"]
                v_end = e["ts"] + e.get("dur_ms", 0.0) / 1000.0
            elif ev == "kv_promote":
                tracing.record_span(
                    "kv.promote", trace_id=tid, parent_span_id=root,
                    start=e["ts"], end=e["ts"], kind="kv",
                    attrs={"blocks": e.get("blocks"),
                           "hit_tokens": e.get("hit_tokens")})
        if preempted_at is not None:  # still parked at its end
            tracing.record_span(
                "engine.preempted", trace_id=tid, parent_span_id=root,
                start=preempted_at["ts"], end=end, kind="engine",
                attrs={"priority": preempted_at.get("priority"),
                       "resumed": False})
        if verify_windows:
            tracing.record_span(
                "engine.verify", trace_id=tid, parent_span_id=root,
                start=v_start, end=v_end, kind="engine",
                attrs={"windows": verify_windows, "drafted": drafted,
                       "accepted": v_accepted})
        if first_ts is not None and last_ts > first_ts:
            tracing.record_span(
                "engine.decode", trace_id=tid, parent_span_id=root,
                start=first_ts, end=last_ts, kind="engine",
                attrs={"tokens": decode_tokens})

    def _trace_ids_locked(self, batch) -> list[str]:
        """The trace ids of a step's traced rows (at most 8)."""
        out = []
        for r in batch:
            if r.trace_ctx:
                out.append(r.trace_ctx["trace_id"])
                if len(out) >= 8:
                    break
        return out

    def _flight_record_locked(self, kind: str, t_wall: float, dt: float,
                              **fields) -> None:
        """One ring record a work step: a few host ints and one append,
        no device access. The step that paid for a sync carries its cost
        and lag."""
        cs = self.cache.stats
        tier = self.cache.host_tier
        rec = {
            "kind": kind,
            "ts": round(t_wall, 6),
            "dur_ms": round(dt * 1000.0, 3),
            "admitted": self._step_admitted,
            "expired": self._step_expired,
            "cow": cs.cow_copies - self._flight_prev["cow"],
            "evicted_blocks": (cs.prefix_evicted_blocks
                               - self._flight_prev["evict"]),
            "kv_util": round(self.cache.utilization, 4),
            "waiting": len(self._waiting),
            "prefilling": len(self._prefilling),
            "running": len(self._running),
            "host_blocks": 0 if tier is None else tier.blocks,
            "host_bytes": 0 if tier is None else tier.nbytes,
            "demotions": cs.demoted_blocks - self._flight_prev["demote"],
            "promotions": cs.promoted_blocks - self._flight_prev["promote"],
        }
        rec.update(fields)
        if not rec.get("trace_ids"):
            rec.pop("trace_ids", None)  # untraced steps stay compact
        if self._last_sync is not None:
            rec.update(self._last_sync)
            self._last_sync = None
        self._flight_prev["cow"] = cs.cow_copies
        self._flight_prev["evict"] = cs.prefix_evicted_blocks
        self._flight_prev["demote"] = cs.demoted_blocks
        self._flight_prev["promote"] = cs.promoted_blocks
        self._flight.record(rec)

    def _on_new_signature(self, sig: tuple) -> None:
        """``DecodeFns`` hook: a (kind, tokens shape, tables shape) this
        engine has not run before, a compile event; counted by shape key
        and marked in the ring."""
        key = obs.shape_key(sig)
        self._m_compile.inc(tags={"shape": key})
        self._flight.record({"kind": "compile", "ts": obs.wall(),
                             "shape": key})

    def _dump(self, reason: str, *, path: str | None = None,
              lock_free: bool = False) -> str | None:
        """Write the flight recorder to disk. ``lock_free`` (the watchdog,
        whose wedged stepper may hold the lock) writes the ring, the last
        autoscaling snapshot (a plain attribute) and the event stats only:
        no ``stats()``, no cache walk, nothing of the device."""
        extra: dict = {}
        if not lock_free:
            extra["stats"] = self.stats()
            extra["cache"] = self.cache.debug_snapshot()
        if self._last_snapshot is not None:
            extra["autoscaling_snapshot"] = self._last_snapshot
        out = obs.write_dump(self._flight.dump(reason, extra=extra),
                             dir=self.cfg.flight_recorder_dir, path=path)
        if out is not None:
            logger.warning("llm engine flight recorder (%s) dumped to %s",
                           reason, out)
        return out

    # ---------------- failure handling ----------------

    def _fail_engine(self, e: BaseException) -> None:
        """A step raised: fail closed. One ``engine_died`` dump, then every
        live stream gets an ``EngineDiedError`` and the pool is reset."""
        if isinstance(e, EngineDiedError):
            err = e
        else:
            err = EngineDiedError(f"engine step failed: {e!r}")
            err.__cause__ = e
        with self._lock:
            self._failed = err
            if not self._dumped:
                self._dumped = True
                self._dump("engine_died")
            self._fan_out_locked(err, "failed")

    def _fan_out_locked(self, err: BaseException, reason: str) -> None:
        """Fail every live stream with ``err`` (terminal event ``reason``)
        and return all blocks."""
        for r in (*self._waiting, *self._prefilling, *self._running,
                  *self._preempted):
            if not r.done:
                r.done = True
                self._finish_obs_locked(r, reason)
                r.out.put(err)
                r.out.put(_DONE)
        self._waiting.clear()
        self._waiting_blocks = 0
        self._prefilling = []
        self._running = []
        self._preempted = []
        self._m_preempted_streams.set(0)
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
            if self._watchdog is None and self.cfg.step_timeout_s:
                self._watchdog = threading.Thread(
                    target=self._watchdog_loop, name="llm-engine-watchdog",
                    daemon=True,
                )
                self._watchdog.start()

    def _loop(self) -> None:
        while True:
            with self._lock:
                if self._stopped:
                    return
            if self._failed is not None:
                return
            try:
                progressed = self.step()
            except Exception as e:  # noqa: BLE001 — fail closed, fan out
                self._fail_engine(e)
                return
            if self._failed is not None:
                # the watchdog failed every stream while this step was
                # wedged; the step stopped before dispatching, and the
                # pool goes back here, under the lock
                with self._lock:
                    self._fan_out_locked(self._failed, "failed")
                return
            if not progressed:
                with self._work:
                    # with parked streams only, keep stepping: their
                    # resume waits on the pool or on the aging clock
                    if not (self._stopped or self._waiting
                            or self._prefilling or self._running
                            or self._preempted):
                        self._work.wait(timeout=0.05)

    def _watchdog_loop(self) -> None:
        """Detect a wedged step, LOCK-FREE: the stepper may be stuck in a
        device sync while holding the scheduler lock. Reads
        ``_step_begin`` as a plain attribute, fails every stream through
        its (thread-safe) queue and writes a ``watchdog_timeout`` dump of
        the ring alone. Touches no tensor and no CUDA call."""
        timeout = self.cfg.step_timeout_s
        poll = max(0.005, min(0.05, timeout / 10.0))
        while not self._stopped and self._failed is None:
            begin = self._step_begin
            if begin is not None and obs.clock() - begin > timeout:
                err = EngineDiedError(
                    f"engine step wedged for > {timeout}s; "
                    "failing all in-flight streams"
                )
                self._failed = err
                if not self._dumped:
                    self._dumped = True
                    self._dump("watchdog_timeout", lock_free=True)
                for r in (list(self._waiting) + self._prefilling
                          + self._running + self._preempted):
                    if not r.done:
                        r.done = True
                        r.out.put(err)
                        r.out.put(_DONE)
                return
            time.sleep(poll)
