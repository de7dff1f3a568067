"""Replica autoscaling policy — pure math, unit-testable (the port's copy
of ``ray_tpu/serve/autoscaling_policy.py``).

Equivalent of the reference's serve autoscaling policy
(reference: python/ray/serve/_private/autoscaling_policy.py:12
calculate_desired_num_replicas, :78 smoothing/bounds), extended with a
signal-driven policy over `serve.llm` AutoscalingSnapshot dicts: the
controller feeds per-replica engine saturation (queue-wait p95, KV-pool
pressure, deadline-miss / rejection rates) instead of raw HTTP
concurrency, which is what the SLO-aware serving literature asks for —
model saturation, not request counts.

One-clock rule: any time read in this module or in the
controller's aggregation path uses obs.clock/obs.wall — snapshot
freshness is judged on the same monotonic clock the engine stamps.
"""
from __future__ import annotations

import math
from typing import Mapping, Sequence

from ray_tpu_torch.serve.config import AutoscalingConfig


def calculate_desired_num_replicas(
    config: AutoscalingConfig,
    total_ongoing_requests: float,
    current_num_replicas: int,
) -> int:
    """Desired replicas from aggregate in-flight load.

    desired = current * (per-replica load / target), smoothed separately for
    up- and down-scaling, clamped to [min, max].
    """
    if current_num_replicas <= 0:
        # scale-from-zero: enough replicas to cover the queue at target load
        raw = total_ongoing_requests / max(config.target_ongoing_requests, 1e-9)
        desired = math.ceil(raw)
    else:
        per_replica = total_ongoing_requests / current_num_replicas
        error_ratio = per_replica / max(config.target_ongoing_requests, 1e-9)
        smoothing = (
            config.upscale_smoothing_factor
            if error_ratio >= 1.0
            else config.downscale_smoothing_factor
        )
        # move a `smoothing` fraction of the way toward the raw target
        raw = current_num_replicas * (1.0 + (error_ratio - 1.0) * smoothing)
        desired = math.ceil(raw) if error_ratio >= 1.0 else math.floor(raw)
    return max(config.min_replicas, min(config.max_replicas, desired))


def snapshot_is_hot(config: AutoscalingConfig, snap: Mapping) -> bool:
    """One replica's engine snapshot trips a scale-up threshold.

    Hot means the engine itself is saturating: requests wait too long at
    admission, the paged KV pool is nearly spent, deadlines are being
    missed, or admission control is already rejecting.

    ``config.signal_mode`` scopes which signals count — disaggregated
    prefill/decode pools scale on DISJOINT signals (ROADMAP item 1), so
    a burst of long cold prompts grows only the prefill pool while KV
    pressure from long generations grows only the decode pool:

      "prefill": admission-side — queue-wait p95 and rejections (TTFT).
      "decode":  generation-side — KV pressure, deadline misses, and
                 (when configured) decode-step p50 (TPOT).
      "all":     every signal (single-pool serving, the default).
    """
    mode = getattr(config, "signal_mode", "all")
    if mode in ("all", "prefill"):
        if (snap.get("queue_wait_p95_s", 0.0)
                >= config.upscale_queue_wait_p95_s):
            return True
        if snap.get("rejection_rate", 0.0) > 0.0:
            return True
    if mode in ("all", "decode"):
        # KV pressure sees both cache tiers: kv_pressure_two_tier
        # discounts device pressure by host-resident (cheaply promotable)
        # blocks, so a replica whose misses are host-tier promotes
        # doesn't demand a new replica the way a recompute-bound one
        # does. Engines without the host tier — and pre-tier snapshots —
        # report the two values equal, so behavior is unchanged there.
        pressure = snap.get(
            "kv_pressure_two_tier", snap.get("kv_pool_pressure", 0.0)
        )
        if pressure >= config.upscale_kv_pressure:
            return True
        if (snap.get("deadline_miss_rate", 0.0)
                > config.upscale_deadline_miss_rate):
            return True
        p50_bound = getattr(config, "upscale_decode_step_p50_s", None)
        if (p50_bound is not None
                and snap.get("decode_step_p50_s", 0.0) >= p50_bound):
            return True
    return False


def snapshot_is_cold(config: AutoscalingConfig, snap: Mapping) -> bool:
    """One replica is fully idle: nothing queued, nothing decoding, no
    stream parked in ``preempted`` (a parked stream holds no blocks but IS
    pending work — draining the replica would orphan it), and the KV pool
    below the downscale pressure bound (LRU-cached prefix blocks are
    reclaimable, so they don't count against coldness)."""
    return (
        snap.get("queue_depth", 0) == 0
        and snap.get("running", 0) == 0
        and snap.get("prefilling", 0) == 0
        and snap.get("preempted_streams", 0) == 0
        and snap.get("kv_pool_pressure", 0.0) <= config.downscale_kv_pressure
    )


def desired_from_signals(
    config: AutoscalingConfig,
    snapshots: Sequence[Mapping],
    current_num_replicas: int,
) -> int:
    """Desired replicas from per-replica engine snapshots.

    Any hot replica asks for one more; down only when *all* replicas are
    cold. One step per decided period is deliberate: the decider's
    delay-periods debounce sets the ramp rate, and asymmetric up/down
    thresholds (hot is not the complement of cold) give hysteresis so a
    bursty trace can't flap the fleet.
    """
    if not snapshots:
        desired = current_num_replicas
    elif any(snapshot_is_hot(config, s) for s in snapshots):
        desired = current_num_replicas + 1
    elif all(snapshot_is_cold(config, s) for s in snapshots):
        desired = current_num_replicas - 1
    else:
        desired = current_num_replicas
    return max(config.min_replicas, min(config.max_replicas, desired))


def fleet_saturated(
    config: AutoscalingConfig,
    snapshots: Sequence[Mapping],
    current_num_replicas: int,
) -> bool:
    """Cluster-wide admission: shed new work at the router when scaling
    can't help — the fleet is at max_replicas and every replica is both
    hot and already queueing. Requests admitted past this point would sit
    in a waiting queue until the engine's own backpressure (or their
    deadline) killed them; a 503 + Retry-After now is strictly kinder.
    """
    if current_num_replicas < config.max_replicas or not snapshots:
        return False
    return all(
        snapshot_is_hot(config, s) and s.get("queue_depth", 0) > 0
        for s in snapshots
    )


def shed_classes(
    config: AutoscalingConfig,
    snapshots: Sequence[Mapping],
    current_num_replicas: int,
) -> tuple:
    """Which priority classes to reject at admission, batch-first.

    Graduated degradation between "serve everything" and the binary
    fleet_saturated shed: once the fleet is at max_replicas and every
    replica reports ``preempt_exhausted`` (pressure holds but no running
    stream is outranked by a waiter — preemption has no more room to
    make), new low-priority work is doomed to park or starve, so reject
    it at the router instead. The preemption thresholds sit BELOW the
    upscale/hot thresholds, so this fires in the band before
    fleet_saturated does — batch sheds first; the default class joins
    only when every replica also shows default-class backlog
    (``queue_depth_by_class``); interactive is only ever shed by the
    full fleet_saturated signal, which supersedes this one.
    """
    if fleet_saturated(config, snapshots, current_num_replicas):
        return ("batch", "default", "interactive")
    if current_num_replicas < config.max_replicas or not snapshots:
        return ()
    exhausted = all(s.get("preempt_exhausted", False) for s in snapshots)
    if not exhausted:
        return ()
    default_backlogged = all(
        (s.get("queue_depth_by_class") or {}).get("default", 0) > 0
        for s in snapshots
    )
    return ("batch", "default") if default_backlogged else ("batch",)


class AutoscalingDecider:
    """Debounces policy output: act only after N consecutive periods agree
    (reference: upscale_delay_s/downscale_delay_s)."""

    def __init__(self, config: AutoscalingConfig):
        self.config = config
        self._pending_direction = 0
        self._streak = 0

    def decide(self, total_ongoing: float, current: int) -> int:
        """Request-count policy (generic deployments)."""
        desired = calculate_desired_num_replicas(self.config, total_ongoing, current)
        return self._debounce(desired, current)

    def decide_from_signals(self, snapshots: Sequence[Mapping], current: int) -> int:
        """Engine-signal policy (serve.llm deployments)."""
        desired = desired_from_signals(self.config, snapshots, current)
        return self._debounce(desired, current)

    def _debounce(self, desired: int, current: int) -> int:
        direction = (desired > current) - (desired < current)
        if direction == 0:
            # A settled period breaks any pending streak entirely: clearing
            # only _streak (and not _pending_direction) would let a later
            # tick in the same direction inherit the stale direction state.
            self._streak = 0
            self._pending_direction = 0
            return current
        if direction != self._pending_direction:
            self._pending_direction = direction
            self._streak = 1
        else:
            self._streak += 1
        needed = (
            self.config.upscale_delay_periods
            if direction > 0
            else self.config.downscale_delay_periods
        )
        if self._streak >= needed:
            self._streak = 0
            self._pending_direction = 0
            return desired
        return current
