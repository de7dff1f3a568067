"""Dynamic batching — marker decorator + shape-bucket padding helpers
(the port's copy of ``ray_tpu/serve/batching.py``).

Equivalent of the reference's @serve.batch (reference: python/ray/serve/
batching.py:337 _BatchQueue coalescing). Coalescing itself happens
REPLICA-side in replica.py's _ReplicaBatchQueue — all callers of a replica
(every driver/proxy process) share one queue, as in the reference — on the
actor's max_ongoing_requests method pool. TPU-first addition kept from the
earlier router design: batches pad to fixed size BUCKETS so a jitted model
sees a closed set of batch shapes (no XLA recompiles — SURVEY.md §7 hard
parts: shape-aware batching).
"""
from __future__ import annotations

from typing import Callable

from ray_tpu_torch.serve._shapes import pad_to_bucket  # noqa: F401 — re-export;
# the one shared padding rule (also used by serve/llm/engine.py)
from ray_tpu_torch.serve.config import BatchConfig

_BATCH_ATTR = "__rt_serve_batch__"


def batch(
    _func: Callable | None = None,
    *,
    max_batch_size: int = 8,
    batch_wait_timeout_s: float = 0.01,
    size_buckets: tuple[int, ...] | None = None,
):
    """Mark a deployment method as batched: the router coalesces up to
    ``max_batch_size`` concurrent calls (waiting at most
    ``batch_wait_timeout_s``) and the method receives a LIST of the single
    call payloads, returning a list of results in order.
    """

    def wrap(func):
        setattr(
            func,
            _BATCH_ATTR,
            BatchConfig(
                max_batch_size=max_batch_size,
                batch_wait_timeout_s=batch_wait_timeout_s,
                size_buckets=size_buckets,
            ),
        )
        return func

    return wrap if _func is None else wrap(_func)


def get_batch_config(func) -> BatchConfig | None:
    return getattr(func, _BATCH_ATTR, None)
