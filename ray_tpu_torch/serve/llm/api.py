"""LLMDeployment — the engine wrapped as a streaming Serve deployment (the
port's copy of ``ray_tpu/serve/llm/api.py``).

One engine per replica; each HTTP or handle call becomes one engine
request, and because the replica runs up to max_ongoing_requests method
threads concurrently (serve/replica.py), concurrent callers' sequences
CONTINUOUSLY BATCH inside the shared engine — the scheduler interleaves
them at the decode-step level, not the request level. Tokens stream out
through the DeploymentHandle generator path and HTTP server-sent events.

Prompts are token-id lists, or strings encoded with the built-in
byte-level tokenizer (token = UTF-8 byte value; any vocab >= 256 works) —
a real BPE vocabulary plugs in by passing token ids directly.

Failure semantics: every chunk carries ``(request_id, index)`` where
``index`` is the ABSOLUTE token position, so a client (``stream_tokens``
/ ``DeploymentHandle.stream_with_failover``) can resume a stream on a
surviving replica after this one dies: it re-submits ``prompt`` plus
``prior_tokens`` (the tokens it already has) and the engine re-prefills;
sampling is keyed per (seed, absolute position) on the device, so the
resumed stream is the uninterrupted one by construction — no RNG state
to replay.

The one addition to the reference: ``params=`` (on ``LLMDeployment`` and
``build_llm_app``) carries the port's weights — a state dict, or an
``ObjectRef`` of one that the replica reads from the object store — into
the replica's engine; None draws the engine's seeded weights. ``serve.run``
holds such a ref for as long as the app is deployed (until
``serve.delete`` or ``serve.shutdown``), so a replica restarted after the
caller dropped its own ref still reads the weights; the object still
fate-shares with the driver that put it, as in the reference. Not here
yet (ROADMAP A9): a sharded replica (``mesh``, ``tp``, ``fsdp``) and the
disaggregated prefill/decode handoff (``prefill=``, ``prefill_export``,
``kv_handoff`` payloads, ``stream_tokens(prefill_handle=)``,
``build_llm_app(prefill_replicas=)``); each raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import logging
import uuid
from collections import OrderedDict
from typing import Any

from ray_tpu_torch._private import chaos
from ray_tpu_torch.exceptions import EngineOverloadedError
from ray_tpu_torch.serve.deployment import Application, deployment
from ray_tpu_torch.serve.llm import obs
from ray_tpu_torch.serve.llm.engine import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.util import metrics, tracing

logger = logging.getLogger("ray_tpu_torch.serve.llm")

# external request ids whose engine-internal id we remember after the
# stream finished, so request_timeline() works post-hoc
_RECENT_REQUESTS = 512

_NO_SHARDING = ("sharded replicas (mesh / tp / fsdp) are not ported yet "
                "(ROADMAP A9): the port's replica serves on one card")
_NO_HANDOFF = ("the disaggregated prefill/decode handoff is not ported yet "
               "(ROADMAP A9: two pools need two cards)")


def encode_text(prompt: str, vocab_size: int) -> list[int]:
    """Byte-level encoding: one token per UTF-8 byte (folded into the
    vocab for the tiny test configs)."""
    return [b % vocab_size for b in prompt.encode("utf-8")]


def decode_token(token: int) -> str:
    """Inverse of encode_text for printable bytes; empty otherwise."""
    return chr(token) if 32 <= token < 127 else ""


def _resolve_params(params):
    """The weights ``params=`` names: a state dict as given, or the value
    of an ``ObjectRef`` read from the store (zero-copy CPU tensors, which
    the engine moves to its device)."""
    from ray_tpu_torch._private.object_ref import ObjectRef

    if isinstance(params, ObjectRef):
        import ray_tpu_torch

        return ray_tpu_torch.get(params, timeout=300)
    return params


@deployment(max_ongoing_requests=8)
class LLMDeployment:
    """Streaming LLM deployment. Bind with an EngineConfig (or dict of its
    fields) and, optionally, ``params=`` (a state dict or an ObjectRef of
    one): ``serve.run(LLMDeployment.bind(EngineConfig(...)))``."""

    def __init__(
        self,
        engine_config: EngineConfig | dict | None = None,
        mesh: Any = None,
        prefill: Any = None,
        params: Any = None,
    ):
        if mesh is not None:
            raise NotImplementedError(_NO_SHARDING)
        if prefill is not None:
            raise NotImplementedError(_NO_HANDOFF)
        if isinstance(engine_config, dict):
            engine_config = EngineConfig(**engine_config)
        t0 = obs.clock()
        params = _resolve_params(params)
        t1 = obs.clock()
        self.engine = LLMEngine(engine_config, params=params)
        if self.engine.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.engine.device)
        # this replica's start by part (seconds), read through debug_dump
        self._start_s = {"get_weights": t1 - t0,
                         "engine_build": obs.clock() - t1}
        # external request_id -> engine-internal id, for cancel()
        self._active: dict[str, Any] = {}
        # same mapping, kept (bounded) after completion for
        # request_timeline() lookups on finished streams
        self._recent: OrderedDict[str, Any] = OrderedDict()
        self._resumed_total = 0
        self._m_resumed = metrics.counter(
            "llm_requests_resumed",
            "Streams resumed on this replica after another replica died",
        )
        # graceful-drain latch (controller-driven scale-down): a draining
        # replica admits nothing new; in-flight streams finish or hand off
        self._draining = False

    def __call__(self, payload: dict | None):
        """Generator: one chunk per generated token.

        payload: {"prompt": str | [int], "max_new_tokens"?, "temperature"?,
        "top_k"?, "top_p"?, "seed"?, "request_id"?, "deadline_s"?,
        "prior_tokens"?, "response_format"?, "stop"?, "priority"?}.
        ``priority`` is the scheduling class ("interactive" | "default" |
        "batch"); the proxy injects it from the ``x-ray-tpu-priority``
        header. It orders preemption and class-aware shedding and never
        changes tokens.
        ``response_format`` selects grammar-constrained decoding
        (serve/llm/structured.py): ``"json"``/``"json_object"`` or an
        OpenAI-shaped dict ({"type": "json_schema", "schema": ...} /
        {"type": "regex", "pattern": ...}); invalid or unsatisfiable
        grammars fail the request with a ``ValueError`` (HTTP 400 at the
        proxy). ``stop`` is a list of
        stop sequences — strings (byte-level encoded like the prompt)
        or token-id lists — that terminate the stream once emitted.
        Chunks: {"request_id": str, "token": id, "index": i, "text": str}
        where ``index`` is absolute — a resumed stream continues the
        numbering of the stream it replaces.
        """
        if self._draining:
            # Scale-down marked this replica draining; the routing table
            # already excludes it, so only a dispatch racing the table
            # refresh lands here. EngineOverloadedError is the retryable
            # "go elsewhere" signal: failover resumes re-dispatch to a
            # survivor, fresh requests get 503 + Retry-After.
            raise EngineOverloadedError(
                "replica is draining for scale-down; retry another replica"
            )
        payload = payload or {}
        prompt = payload.get("prompt", "")
        if isinstance(prompt, str):
            prompt = encode_text(prompt, self.engine.model_cfg.vocab_size)
        prompt = [int(t) for t in prompt]
        request_id = str(payload.get("request_id") or uuid.uuid4().hex)
        prior = [int(t) for t in payload.get("prior_tokens") or ()]
        max_new = int(payload.get("max_new_tokens", 16))
        if prior:
            self._resumed_total += 1
            self._m_resumed.inc()
            if len(prior) >= max_new:
                return  # the dead replica already delivered everything
        handoff = payload.get("kv_handoff")
        if handoff:
            self._land_handoff(  # raises: the handoff is not ported
                prompt, handoff, tag=payload.get("chaos_tag")
            )
        deadline_s = payload.get("deadline_s")
        stop = []
        for seq in payload.get("stop") or ():
            if isinstance(seq, str):
                seq = encode_text(seq, self.engine.model_cfg.vocab_size)
            stop.append(tuple(int(t) for t in seq))
        sampling = SamplingParams(
            max_new_tokens=max_new - len(prior),
            temperature=float(payload.get("temperature", 0.0)),
            top_k=int(payload.get("top_k", 0)),
            top_p=float(payload.get("top_p", 1.0)),
            seed=int(payload.get("seed", 0)),
            deadline_s=float(deadline_s) if deadline_s is not None else None,
            start_index=len(prior),
            structured=payload.get("response_format"),
            stop=tuple(stop),
            priority=str(payload.get("priority", "default")),
        )
        # the replica method runs inside a task_span when the caller was
        # traced — hand that context to the engine so its phase spans join
        # the same trace, and stamp the trace id on every chunk so a
        # resumed stream can assert trace continuity across replicas
        trace_ctx = tracing.current_context()
        trace_id = trace_ctx["trace_id"] if trace_ctx else None
        stream = self.engine.submit(
            prompt + prior, sampling, trace_ctx=trace_ctx
        )
        self._active[request_id] = stream.request_id
        self._recent[request_id] = stream.request_id
        while len(self._recent) > _RECENT_REQUESTS:
            self._recent.popitem(last=False)
        try:
            for i, tok in enumerate(stream):
                index = len(prior) + i
                chunk = {
                    "request_id": request_id,
                    "token": int(tok),
                    "index": index,
                    "text": decode_token(tok),
                }
                if trace_id is not None:
                    chunk["trace_id"] = trace_id
                yield chunk
                chaos.fire(
                    "llm.token",
                    index=index,
                    resumed=bool(prior),
                    tag=payload.get("chaos_tag"),
                )
        finally:
            self._active.pop(request_id, None)

    def cancel(self, request_id: str) -> bool:
        """Evict ``request_id`` and free its KV blocks now. Idempotent and
        safe to broadcast: replicas not serving the stream return False."""
        internal = self._active.get(str(request_id))
        if internal is None:
            return False
        return self.engine.cancel(internal)

    def check_health(self) -> None:
        """Controller health-check hook: a failed engine (step raised or
        watchdog fired) reports unhealthy so the replica gets replaced."""
        if self.engine.failed:
            raise RuntimeError("llm engine failed; replica must be replaced")

    def stats(self) -> dict:
        """Engine introspection (unary method — callable via handle)."""
        out = self.engine.stats()
        out["requests_resumed"] = self._resumed_total
        return out

    def request_timeline(self, request_id: str) -> dict | None:
        """Phase timeline of one EXTERNAL request id — live or recently
        finished on this replica; None if this replica never served it
        (broadcast to find the owner, like cancel)."""
        internal = self._active.get(str(request_id))
        if internal is None:
            internal = self._recent.get(str(request_id))
        if internal is None:
            return None
        return self.engine.request_timeline(internal)

    def debug_dump(self) -> dict:
        """Flight-recorder ring + engine/cache stats (the payload behind
        the proxy's /debug/llm endpoint), and this replica's start by part
        (``start_s``: reading the weights, building the engine, and the
        decode graphs' capture so far)."""
        out = self.engine.debug_dump()
        out["requests_resumed"] = self._resumed_total
        out["draining"] = self._draining
        out["start_s"] = dict(self._start_s,
                              graph_capture=self.engine.fns.capture_seconds)
        return out

    # ---------------- autoscaling & graceful drain ----------------

    def autoscaling_snapshot(self) -> dict:
        """Engine saturation signals for the controller's autoscaler. The
        ``llm.snapshot`` chaos point sits here so the load harness can
        delay/jitter snapshot reporting deterministically."""
        chaos.fire("llm.snapshot")
        out = self.engine.autoscaling_snapshot()
        out["draining"] = self._draining
        out["active_streams"] = len(self._active)
        return out

    def prepare_drain(self) -> dict:
        """Controller scale-down hook: stop admitting, keep serving.

        After this returns, new ``__call__`` dispatches are refused with
        ``EngineOverloadedError`` while every in-flight stream keeps
        decoding; the controller polls ``drain_status`` and finishes (or
        kills — the failover path hands the streams to survivors
        byte-identically) once the replica is idle or the drain deadline
        expires. Idempotent."""
        self._draining = True
        chaos.fire("replica_drain", active=len(self._active))
        return self.drain_status()

    def drain_status(self) -> dict:
        return {
            "draining": self._draining,
            "active_streams": len(self._active),
        }

    def finish_drain(self) -> dict:
        """Terminal drain step, called by the controller once no streams
        are active: returns every KV block (allocations, reservations,
        quarantine, prefix cache) to the pool via the engine's
        ``release_all`` shutdown path and reports the final accounting so
        the caller can assert the pool is leak-free before the actor is
        killed."""
        self.engine.shutdown()
        snap = self.engine.cache.debug_snapshot()
        return {
            "released": True,
            "leaked_blocks": snap["used_blocks"],
            "cache": snap,
        }

    # ---------------- disaggregated prefill/decode handoff ----------------

    def prefill_export(self, payload: dict | None) -> dict | None:
        """The prefill pool's entry point of the reference; not ported."""
        raise NotImplementedError(_NO_HANDOFF)

    def _land_handoff(self, prompt, manifest: dict, tag=None) -> int:
        raise NotImplementedError(_NO_HANDOFF)


def stream_tokens(handle, payload: dict, *, max_failovers: int = 2,
                  prefill_handle=None, handoff_retries: int = 2):
    """Stream token chunks from an LLMDeployment handle with automatic
    mid-stream failover: if the serving replica dies, re-submit to a
    survivor with ``prior_tokens`` set to everything already received.
    Deterministic sampling makes the joined stream identical to an
    uninterrupted run. Returns an iterator of chunk dicts.
    ``prefill_handle`` (the disaggregated handoff) raises
    ``NotImplementedError`` (ROADMAP A9)."""
    if prefill_handle is not None:
        raise NotImplementedError(_NO_HANDOFF)
    payload = dict(payload)
    payload.setdefault("request_id", uuid.uuid4().hex)

    def resume(chunks):
        resumed = dict(payload)
        resumed["prior_tokens"] = [c["token"] for c in chunks]
        return resumed

    return handle.stream_with_failover(
        payload, resume=resume, max_failovers=max_failovers
    )


def build_llm_app(
    engine_config: EngineConfig | dict | None = None,
    *,
    params: Any = None,
    mesh: Any = None,
    tp: int = 1,
    fsdp: int = 1,
    speculative_k: int | None = None,
    drafter: Any = None,
    prefill_replicas: int = 0,
    prefill_options: dict | None = None,
    **deployment_options: Any,
) -> Application:
    """Convenience: ``serve.run(build_llm_app(EngineConfig(...)))``.
    ``params`` are the replica's weights (a state dict or an ObjectRef of
    one; None draws the engine's seeded weights). ``deployment_options``
    forward to ``.options(...)`` (num_replicas, ``ray_actor_options=
    {"num_gpus": 1}`` for a card, ...). ``speculative_k`` / ``drafter``
    override the engine's speculative-decoding knobs. ``mesh`` / ``tp`` /
    ``fsdp`` and ``prefill_replicas > 0`` raise ``NotImplementedError``
    (ROADMAP A9)."""
    if mesh is not None or tp != 1 or fsdp != 1:
        raise NotImplementedError(_NO_SHARDING)
    if prefill_replicas > 0 or prefill_options is not None:
        raise NotImplementedError(_NO_HANDOFF)
    overrides: dict = {}
    if speculative_k is not None:
        overrides["speculative_k"] = int(speculative_k)
    if drafter is not None:
        overrides["drafter"] = drafter
    if overrides:
        if isinstance(engine_config, dict):
            engine_config = EngineConfig(**engine_config)
        engine_config = dataclasses.replace(
            engine_config or EngineConfig(), **overrides
        )
    dep = LLMDeployment
    if deployment_options:
        dep = dep.options(**deployment_options)
    if params is None:
        return dep.bind(engine_config)
    return dep.bind(engine_config, params=params)
