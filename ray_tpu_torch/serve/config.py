"""Serve configuration dataclasses (the port's copy of
``ray_tpu/serve/config.py``: the same fields, defaults and checks).

Equivalent of the reference's Serve config surface
(reference: python/ray/serve/config.py — DeploymentConfig/AutoscalingConfig;
python/ray/serve/schema.py pydantic schemas). Plain dataclasses here: the
validation surface is small and pydantic is not load-bearing for behavior.

``ModelParallelConfig`` and ``GrpcOptions`` are kept as data only: the
port's replica serves on one card (a mesh, ``tp`` or ``fsdp`` raises
``NotImplementedError``, ROADMAP A9) and has no gRPC ingress
(``serve.start(grpc_options=...)`` raises).
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class AutoscalingConfig:
    """Replica autoscaling targets
    (reference: serve/config.py AutoscalingConfig; policy math in
    serve/_private/autoscaling_policy.py:12 calculate_desired_num_replicas).
    """

    min_replicas: int = 1
    max_replicas: int = 1
    target_ongoing_requests: float = 2.0
    upscale_smoothing_factor: float = 1.0
    downscale_smoothing_factor: float = 0.5
    # consecutive decisions required before acting (reference: upscale_delay_s/
    # downscale_delay_s expressed in loop periods)
    upscale_delay_periods: int = 1
    downscale_delay_periods: int = 3

    # --- engine-signal thresholds (serve.llm AutoscalingSnapshot) ---
    # A replica is HOT (scale up) when any of these trip; the fleet scales
    # DOWN only when every replica is cold (no queued or running work and
    # KV pressure below the downscale bound). Pressures are fractions of
    # the usable KV pool in [0, 1].
    upscale_queue_wait_p95_s: float = 0.25
    upscale_kv_pressure: float = 0.85
    # deadline misses per second above which a replica counts as hot; the
    # default 0.0 means "any miss is a saturation signal"
    upscale_deadline_miss_rate: float = 0.0
    downscale_kv_pressure: float = 0.5
    # snapshots older than this (on obs.clock) are ignored by aggregation
    signal_ttl_s: float = 5.0
    # Which saturation signals count toward HOT (disaggregated
    # prefill/decode pools scale on disjoint signals):
    #   "all"     — every threshold (the default, single-pool behavior)
    #   "prefill" — admission-side only: queue-wait p95 + rejections
    #               (the prefill pool's TTFT story)
    #   "decode"  — generation-side only: KV pressure + deadline misses
    #               + optionally decode-step p50 (the TPOT story)
    # Coldness (scale-down) is mode-independent: idle is idle.
    signal_mode: str = "all"
    # decode-step p50 (seconds) above which a "decode"/"all"-mode replica
    # counts as hot; None disables the check (pressure/misses only)
    upscale_decode_step_p50_s: float | None = None

    def __post_init__(self):
        if self.min_replicas < 0 or self.max_replicas < self.min_replicas:
            raise ValueError(
                f"need 0 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}/{self.max_replicas}"
            )
        for name in ("upscale_kv_pressure", "downscale_kv_pressure"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.upscale_queue_wait_p95_s < 0 or self.upscale_deadline_miss_rate < 0:
            raise ValueError("signal thresholds must be >= 0")
        if self.signal_mode not in ("all", "prefill", "decode"):
            raise ValueError(
                "signal_mode must be 'all', 'prefill', or 'decode', got "
                f"{self.signal_mode!r}"
            )
        if (self.upscale_decode_step_p50_s is not None
                and self.upscale_decode_step_p50_s <= 0):
            raise ValueError(
                "upscale_decode_step_p50_s must be positive or None, got "
                f"{self.upscale_decode_step_p50_s}"
            )


@dataclass
class BatchConfig:
    """Router-side dynamic batching for one replica method.

    Deviation from the reference: the reference batches inside the
    replica's asyncio loop (serve/batching.py:337) with arbitrary resulting
    batch sizes; here batches can pad to fixed bucket sizes so a model step
    sees a closed set of shapes (one CUDA graph a shape).
    """

    max_batch_size: int = 8
    batch_wait_timeout_s: float = 0.01
    # optional ascending bucket sizes; router pads submitted batch lists to
    # the next bucket with `None` entries which the replica wrapper strips
    # after the model call (shape-stable submission)
    size_buckets: tuple[int, ...] | None = None


@dataclass(frozen=True)
class ModelParallelConfig:
    """Per-replica model-parallel layout for LLM serving
    (serve/llm/executor.py ShardedExecutor).

    ``tp`` shards attention/KV heads, MLP hidden, and the vocab
    projection Megatron-style — including the paged KV pool, which
    splits along its head axis (so ``n_kv_head % tp == 0`` is required);
    ``fsdp`` shards the embed axis of every weight (ZeRO-3). One replica
    occupies ``tp * fsdp`` chips; the default (1, 1) keeps the
    single-device executor and changes nothing. Passed as the ``mesh``
    field of ``EngineConfig`` (or via ``LLMDeployment`` /
    ``build_llm_app`` plumbing).

    ``attention_backend`` selects the decode attention kernel for the
    replica (None -> the engine/model default; "auto" | "xla" |
    "pallas" — ops/paged_attention.py). The Pallas kernel is
    head-count-agnostic, so it runs per tp shard over the pool's local
    KV heads with no extra collective.
    """

    tp: int = 1
    fsdp: int = 1
    attention_backend: str | None = None

    def __post_init__(self):
        if self.tp < 1 or self.fsdp < 1:
            raise ValueError(
                f"tp and fsdp must be >= 1, got tp={self.tp} "
                f"fsdp={self.fsdp}"
            )
        if self.attention_backend not in (None, "auto", "xla", "pallas"):
            raise ValueError(
                "attention_backend must be None, 'auto', 'xla', or "
                f"'pallas', got {self.attention_backend!r}"
            )

    @property
    def n_devices(self) -> int:
        return self.tp * self.fsdp


@dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_ongoing_requests: int = 8
    autoscaling_config: AutoscalingConfig | None = None
    # actor resources per replica (whole cards ride here: {"num_gpus": 1})
    ray_actor_options: dict = field(default_factory=dict)
    health_check_period_s: float = 1.0
    graceful_shutdown_timeout_s: float = 5.0
    user_config: dict | None = None
    # Disaggregated serving role tag ("prefill" | "decode" | None). The
    # port has one pool only: a role raises until the prefill/decode
    # handoff is ported (ROADMAP A9), so no deployment claims a pool that
    # does not run.
    pool_role: str | None = None

    def __post_init__(self):
        if self.pool_role not in (None, "prefill", "decode"):
            raise ValueError(
                "pool_role must be None, 'prefill', or 'decode', got "
                f"{self.pool_role!r}"
            )
        if self.pool_role is not None:
            raise NotImplementedError(
                "disaggregated prefill/decode pools are not ported yet "
                "(ROADMAP A9): the port serves from a single pool"
            )

    @property
    def target_num_replicas(self) -> int:
        if self.autoscaling_config is not None:
            return self.autoscaling_config.min_replicas
        return self.num_replicas


@dataclass
class HTTPOptions:
    """HTTP ingress options (reference: serve/config.py HTTPOptions —
    including request_timeout_s). port=0 binds an ephemeral port (exposed
    as HTTPProxy.port / serve.proxy_addresses())."""

    host: str = "127.0.0.1"
    port: int = 8000
    # end-to-end budget for a unary result and the per-chunk budget for
    # streamed responses; None waits forever
    request_timeout_s: float | None = 120.0
    # head sampling for the fleet trace plane: fraction of UNTAGGED
    # requests (no x-ray-tpu-trace header) the proxy traces anyway, so
    # production traffic feeds the TraceStore without client opt-in.
    # Sampled per request from the proxy's seeded RNG; 0.0 = header-only.
    trace_sample_rate: float = 0.0


@dataclass
class GrpcOptions:
    """gRPC ingress (reference: serve gRPCOptions — grpc_servicer_functions
    replaced by the generic byte-payload ServeAPI service, grpc_proxy.py).
    port=0 binds an ephemeral port (exposed as GrpcProxy.port)."""

    host: str = "127.0.0.1"
    port: int = 9000
    request_timeout_s: float | None = 120.0
    # head sampling, same semantics as HTTPOptions.trace_sample_rate
    trace_sample_rate: float = 0.0
