"""Flag table for the runtime (the port's copy of
``ray_tpu/_private/config.py``, without the TPU topology flags).

Equivalent of the reference's RAY_CONFIG macro table
(reference: src/ray/common/ray_config_def.h — 209 flags, overridable via
RAY_<name> env vars and a `_system_config` dict passed at init). Here every
flag is declared once below, overridable via ``RAY_TPU_<NAME>`` env vars or
the ``_system_config`` dict argument to :func:`ray_tpu_torch.init`.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, fields
from typing import Any

_ENV_PREFIX = "RAY_TPU_"


@dataclass
class Config:
    # --- core worker / scheduling ---
    task_retry_delay_ms: int = 100  # backoff before re-running a crashed task
    # --- object store ---
    object_store_memory_bytes: int = 512 * 1024 * 1024
    object_spilling_dir: str = ""  # default: <store socket>.spill
    # per-pass spill batch floor: under pressure the store spills LRU
    # objects until at least this many bytes moved, amortizing disk IO
    # (reference: min_spilling_size, local_object_manager.cc)
    min_spilling_size: int = 8 * 1024 * 1024
    object_pull_chunk_bytes: int = 8 * 1024 * 1024  # inter-node transfer chunk
    # --- raylet ---
    num_workers_soft_limit: int = -1  # default: num_cpus
    # generous: several python workers cold-spawning serially on a loaded
    # single-CPU host can take 5-10s each
    worker_register_timeout_s: int = 60
    # idle task workers beyond this age are reaped down to one warm worker
    # (reference: worker_pool idle killing); generous default — cold spawn
    # costs seconds on a busy host
    kill_idle_workers_interval_ms: int = 5_000
    idle_worker_killing_time_threshold_ms: int = 300_000
    # OOM protection (reference: memory_monitor.h + worker_killing_policy):
    # above the usage threshold the raylet kills task workers, retriable
    # and newest first. 0 disables the monitor.
    memory_usage_threshold: float = 0.95
    memory_monitor_refresh_ms: int = 250
    # above this disk-used fraction on the session filesystem the raylet
    # stops starting new tasks (reference: local_fs_capacity_threshold,
    # file_system_monitor.h). 0 disables the check.
    local_fs_capacity_threshold: float = 0.98
    # --- GCS ---
    gcs_heartbeat_interval_ms: int = 1000
    health_check_failure_threshold: int = 5
    # --- actors ---
    actor_creation_timeout_s: int = 60
    # default restart budget for actors created without max_restarts=
    # (actor.py ActorMethod creation spec)
    max_actor_restarts_default: int = 0
    # --- observability ---
    task_events_buffer_size: int = 10_000
    # raylet node-gauge refresh cadence (raylet.py _metrics_report_loop)
    metrics_report_interval_ms: int = 2000

    def apply_overrides(self, system_config: dict[str, Any] | None = None) -> None:
        for f in fields(self):
            env_key = _ENV_PREFIX + f.name.upper()
            if env_key in os.environ:
                setattr(self, f.name, _parse(os.environ[env_key], f.type))
        if system_config:
            for key, value in system_config.items():
                if not any(f.name == key for f in fields(self)):
                    raise ValueError(f"Unknown system config key: {key}")
                setattr(self, key, value)


def _parse(raw: str, ftype: Any) -> Any:
    ftype = str(ftype)
    if "int" in ftype:
        return int(raw)
    if "float" in ftype:
        return float(raw)
    if "bool" in ftype:
        return raw.lower() in ("1", "true", "yes")
    try:
        return json.loads(raw)
    except (ValueError, TypeError):
        return raw


_config: Config | None = None


def global_config() -> Config:
    global _config
    if _config is None:
        _config = Config()
        _config.apply_overrides()
    return _config


def reset_config(system_config: dict[str, Any] | None = None) -> Config:
    global _config
    _config = Config()
    _config.apply_overrides(system_config)
    return _config
