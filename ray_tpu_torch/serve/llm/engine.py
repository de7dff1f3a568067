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
model step sees a closed set of shapes. Sampling runs on the device
inside the model step, keyed by (request seed, absolute position)
(``ops/sampling.py``), so a request's stream is the same solo or batched
and the same as the JAX engine's on the same weights.

``EngineConfig.quantization`` ("int8" | "fp8") serves from quantized
weights and a quantized pool (``ops/quantization.py``).

What this slice leaves out of the JAX engine: prefix caching and
copy-on-write, the host KV tier, preemption, speculative decoding,
structured output, stop sequences, deadlines, admission-queue limits,
sharded executors, observability, and the dispatch-ahead decode pipeline
— decode here is synchronous (lag 0): each step syncs its own ids. The
head of the admission queue blocks the requests behind it until it fits.
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
from ray_tpu_torch.models.gpt import GPTConfig
from ray_tpu_torch.ops.paged_attention import resolve_backend
from ray_tpu_torch.ops.quantization import resolve_quantization
from ray_tpu_torch.serve._shapes import pad_to_bucket, pow2_buckets
from ray_tpu_torch.serve.llm.executor import SingleDeviceExecutor
from ray_tpu_torch.serve.llm.kv_cache import KVCacheConfig, PagedKVCache

_DONE = object()  # stream sentinel

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
    model: str = "gpt"            # only the GPT family is ported
    model_config: Any = None      # GPTConfig; None -> GPTConfig.tiny()
    block_size: int = 16
    num_blocks: int = 64
    max_batch_size: int = 8       # max concurrently-running sequences
    max_prefill_batch: int = 4    # max requests coalesced into one prefill
    batch_buckets: tuple[int, ...] | None = None   # None -> pow2 ladder
    length_buckets: tuple[int, ...] | None = None  # None -> pow2 ladder
    eos_id: int | None = None
    seed: int = 0                 # weight init seed (when params not given)
    # prefill one prompt in slices of at most this many tokens, alternating
    # with decode steps; None -> the whole prompt in one call
    prefill_chunk_tokens: int | None = None
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
        "done", "blocks_released",
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
        self.blocks_released = False

    @property
    def total_len(self) -> int:
        return len(self.prompt) + len(self.generated)


class LLMEngine:
    """Continuous-batching inference engine over a paged KV cache.

    ``auto_step=True`` runs the scheduler on a background thread;
    ``auto_step=False`` lets the caller drive ``step()``. All scheduler
    and cache state is guarded by one lock. ``params`` is a state dict of
    GPT weights (``convert.gpt_params_from_numpy``); None draws seeded
    random weights on the device."""

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
        if cfg.model != "gpt":
            raise ValueError(
                f"model {cfg.model!r} is not ported yet; only 'gpt' is"
            )
        device = resolve_device(cfg.device)
        model_cfg = cfg.model_config or GPTConfig.tiny()
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
                n_kv_head=model_cfg.n_head,
                head_dim=model_cfg.head_dim,
                num_blocks=cfg.num_blocks,
                block_size=cfg.block_size,
                dtype=model_cfg.dtype,
                device=device,
                quantization=quant,
            )
        )
        self.executor = SingleDeviceExecutor(
            model_cfg, self.cache, params=params, seed=cfg.seed
        )
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
        self._scratch: dict[tuple, np.ndarray] = {}
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
        prefill call OR one batched decode step. Returns False when idle."""
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
            if self._running:
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
        the pool, exactly once."""
        if r.blocks_released or r.reserved_blocks == 0:
            return
        r.blocks_released = True
        self.cache.free(r.id)
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
        r.done = True
        self._release_blocks_locked(r)

    def _try_admit_one_locked(self, req: _Request) -> bool:
        """Reserve the request's worst-case blocks (prompt +
        max_new_tokens) and give it an empty table; False when they do not
        fit right now."""
        need = self.cache.cfg.blocks_for(
            len(req.prompt) + req.sampling.max_new_tokens
        )
        if not self.cache.can_reserve(need):
            return False
        self.cache.reserve(need)
        req.reserved_blocks = need
        self.cache.allocate(req.id)
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

    def _prefill_chunk_locked(self) -> None:
        """ONE prefill call for up to ``max_prefill_batch`` admitted
        requests, each contributing its next chunk. Whole cold prompts
        take the fresh path (start=None); anything mid-prompt takes the
        chunked path at true positions."""
        batch = self._prefilling[: self.cfg.max_prefill_batch]
        bs = self.cfg.block_size
        cap = self.cfg.prefill_chunk_tokens
        ns = []
        for r in batch:
            r.started = True
            remaining = len(r.prompt) - r.prefill_done
            ns.append(remaining if cap is None else min(remaining, cap))
        for r, n in zip(batch, ns):
            r.drawn_blocks += self.cache.ensure_capacity(
                r.id, r.prefill_done + n
            )
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
        host = self.executor.sync_tokens(toks_dev)
        self.num_prefill_calls += 1
        for i, (r, n) in enumerate(zip(batch, ns)):
            r.prefill_done += n
            if r.prefill_done >= len(r.prompt):
                # the final chunk's last-token logits give the first token
                self._prefilling.remove(r)
                self._emit_token_locked(r, int(host[i]))
                if not r.done:
                    self._running.append(r)

    def _decode_locked(self) -> None:
        """One batched decode step over every running sequence, synced at
        once (lag 0)."""
        bs = self.cfg.block_size
        batch = list(self._running)
        for r in batch:
            # the newest token's K/V lands at position total_len - 1
            r.drawn_blocks += self.cache.ensure_capacity(r.id, r.total_len)
        B = pad_to_bucket(len(batch), self._batch_buckets)
        ctx = pad_to_bucket(
            max(max(r.total_len, self.cache.num_allocated(r.id) * bs)
                for r in batch),
            self._length_buckets,
        )
        nb = ctx // bs
        tokens = self._scratch_buf("dec_tokens", (B,), np.int32)
        positions = self._scratch_buf("dec_positions", (B,), np.int32)
        tables = self._scratch_buf("dec_tables", (B, nb), np.int32)
        tokens[:] = 0
        positions[:] = 0
        tables[:] = 0
        for i, r in enumerate(batch):
            tokens[i] = r.generated[-1]
            positions[i] = r.total_len - 1
            tables[i] = self._table_for(r, nb)
        toks_dev = self.executor.decode_step(
            tokens, positions, tables,
            sample=self._sample_args_locked(batch, B),
        )
        host = self.executor.sync_tokens(toks_dev)
        self.num_decode_steps += 1
        for i, r in enumerate(batch):
            self._emit_token_locked(r, int(host[i]))
        self._running = [r for r in self._running if not r.done]

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
        """Reusable host staging buffer per (name, shape). One buffer is
        enough: every step syncs before the next one restages it."""
        key = (name, shape)
        buf = self._scratch.get(key)
        if buf is None:
            buf = self._scratch[key] = np.zeros(shape, dtype)
        return buf

    def _emit_token_locked(self, r: _Request, tok: int) -> None:
        r.generated.append(tok)
        r.out.put(tok)
        if (
            len(r.generated) >= r.sampling.max_new_tokens
            or (self.cfg.eos_id is not None and tok == self.cfg.eos_id)
        ):
            r.done = True
            r.out.put(_DONE)
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
