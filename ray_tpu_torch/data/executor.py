"""Streaming block executor (the port's copy of
``ray_tpu/data/executor.py``, on the port's core: its remote functions,
actors, ``get`` / ``put`` / ``wait`` and the by-value pickler of
``_private/task_spec.dumps_function``; blocks are numpy dicts,
``data/block.py``).

All heavy lifting runs as ray_tpu_torch tasks over object-store blocks —
the same division of labor as the reference, where Ray Data is a
pure-Python library whose operators execute as tasks/actors over plasma
blocks (reference:
python/ray/data/_internal/execution/streaming_executor.py:49, operators under
_internal/execution/operators/).

Design differences, core-native:
- consecutive one-to-one ops (read/map/filter/flat_map/map_batches/limit)
  are FUSED into a single task per block (reference fuses via
  logical/rules/operator_fusion.py); all-to-all ops (shuffle, sort,
  repartition) are stage barriers built from num_returns=N map tasks and
  N reduce tasks (reference: _internal/push_based_shuffle.py).
- the one-to-one pipeline is a generator: blocks stream out as their tasks
  finish (bounded in-flight window for backpressure), so iter_batches
  consumes while upstream tasks still run.
"""
from __future__ import annotations

import hashlib
import threading
from typing import Any, Callable, Iterator, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch._private import task_spec as ts
from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.context import DataContext


class BlockMeta:
    __slots__ = ("num_rows", "size_bytes")

    def __init__(self, num_rows: int, size_bytes: int):
        self.num_rows = num_rows
        self.size_bytes = size_bytes

    def __repr__(self):
        return f"BlockMeta(rows={self.num_rows}, bytes={self.size_bytes})"


# (block_ref, BlockMeta) — the executor's currency
RefBundle = Tuple["ray_tpu_torch.ObjectRef", BlockMeta]

# ---------------------------------------------------------------------------
# worker-side stage runner: deserialize the fused fn chain once per blob
# ---------------------------------------------------------------------------

_STAGE_CACHE: dict = {}
_STAGE_CACHE_LOCK = threading.Lock()


def _load_stage(blob: bytes) -> Callable:
    key = hashlib.sha1(blob).digest()
    with _STAGE_CACHE_LOCK:
        fn = _STAGE_CACHE.get(key)
        if fn is None:
            fn = ts.loads_function(blob)
            if len(_STAGE_CACHE) > 256:
                _STAGE_CACHE.clear()
            _STAGE_CACHE[key] = fn
    return fn


def _meta_of(block: Block) -> BlockMeta:
    acc = BlockAccessor(block)
    return BlockMeta(acc.num_rows(), acc.size_bytes())


@ray_tpu_torch.remote
def _exec_block(stage_blob: bytes, source: Any):
    """Run a fused one-to-one chain. `source` is an upstream block (a
    numpy dict) or a read-task argument; the chain's first fn knows which."""
    fn = _load_stage(stage_blob)
    block = fn(source)
    return block, _meta_of(block)


@ray_tpu_torch.remote
def _exec_shuffle_map(stage_blob: bytes, n: int, idx: int, source: Any):
    """Partition one block into n pieces; returned as n separate objects so
    each reducer fetches only its shard (push-based shuffle, reference:
    data/_internal/push_based_shuffle.py)."""
    fn = _load_stage(stage_blob)
    parts = fn(source, n, idx)
    assert len(parts) == n
    if n == 1:
        return parts[0]
    return tuple(parts)


@ray_tpu_torch.remote
def _exec_reduce(stage_blob: bytes, *parts):
    fn = _load_stage(stage_blob)
    block = fn(list(parts))
    return block, _meta_of(block)


# ---------------------------------------------------------------------------
# driver-side streaming pipeline
# ---------------------------------------------------------------------------


def _window_size(ctx: DataContext) -> int:
    if ctx.max_in_flight_tasks:
        return ctx.max_in_flight_tasks
    try:
        cpus = ray_tpu_torch.cluster_resources().get("CPU", 4)
    except Exception:
        cpus = 4
    return max(2, int(cpus) * 2)


def run_oneone_stage(
    sources: Iterator[Any],
    stage_blob: bytes,
    ctx: DataContext,
    limit_rows: Optional[int] = None,
) -> Iterator[RefBundle]:
    """Stream `sources` (read args or block refs) through one fused task per
    source. Yields bundles as tasks complete (in completion order); keeps at
    most `window` tasks in flight; stops submitting once `limit_rows` rows
    have already been yielded."""
    window = _window_size(ctx)
    inflight: dict = {}  # meta_ref -> (seq, block_ref)
    done: dict = {}  # seq -> RefBundle, completed but not yet yielded
    sources = iter(sources)
    exhausted = False
    submitted = 0
    next_seq = 0  # output preserves submission (plan) order
    yielded_rows = 0

    def submit_one() -> bool:
        nonlocal exhausted, submitted
        try:
            src = next(sources)
        except StopIteration:
            exhausted = True
            return False
        block_ref, meta_ref = _exec_block.options(num_returns=2).remote(
            stage_blob, src
        )
        inflight[meta_ref] = (submitted, block_ref)
        submitted += 1
        return True

    while True:
        while (not exhausted and len(inflight) < window
               and (limit_rows is None or yielded_rows < limit_rows)):
            if not submit_one():
                break
        if not inflight and not done:
            return
        if inflight:
            ready, _ = ray_tpu_torch.wait(list(inflight.keys()),
                                          num_returns=1, timeout=600)
            for meta_ref in ready:
                seq, block_ref = inflight.pop(meta_ref)
                meta: BlockMeta = ray_tpu_torch.get(meta_ref, timeout=600)
                done[seq] = (block_ref, meta)
        while next_seq in done:
            block_ref, meta = done.pop(next_seq)
            next_seq += 1
            if meta.num_rows == 0:
                continue
            yielded_rows += meta.num_rows
            yield block_ref, meta


class _PoolWorker:
    """Stateful block-transform actor: the factory blob is deserialized and
    CALLED once at construction (instantiating the user's callable class
    there), then every block reuses the instance (reference:
    actor_pool_map_operator.py — _MapWorker)."""

    def __init__(self, factory_blob: bytes):
        self._fn = ts.loads_function(factory_blob)()

    def run(self, source: Any):
        block = self._fn(source)
        # put the block from the actor so only (ref, meta) crosses back to
        # the driver — the block itself stays in the object store
        return ray_tpu_torch.put(block), _meta_of(block)

    def ping(self):
        return True


def run_actor_stage(
    sources: Iterator[Any],
    factory_blob: bytes,
    strategy,
    ctx: DataContext,
    limit_rows: Optional[int] = None,
    upstream_live: bool = True,
) -> Iterator[RefBundle]:
    """Stream blocks through an autoscaling pool of `_PoolWorker` actors.

    Scale-up rule: if every live actor is saturated (max_tasks_in_flight
    queued) and input remains, add an actor, up to strategy.max_size.
    Output preserves submission order, same as run_oneone_stage.

    Resource-aware admission (reference: streaming executor resource
    budgets, _internal/execution/resource_manager.py): when the input is a
    LIVE task stage (`upstream_live`), the pool may never occupy every CPU
    — at least one is reserved so upstream tasks keep producing. A pool
    whose configured minimum wouldn't fit that budget falls back to
    materializing the upstream FIRST (barrier), then running at full
    width: slower than pipelining, but it completes instead of
    deadlocking pool-vs-upstream.
    """
    opts = dict(num_cpus=strategy.num_cpus)
    if strategy.resources:
        opts["resources"] = strategy.resources
    Worker = ray_tpu_torch.remote(**opts)(_PoolWorker)

    per_actor = max(float(strategy.num_cpus), 1e-9)
    try:
        total_cpus = float(ray_tpu_torch.cluster_resources().get("CPU", 4.0))
    except Exception:
        total_cpus = 4.0
    pool_cap = max(1, int(total_cpus // per_actor))
    if upstream_live:
        live_cap = int((total_cpus - 1.0) // per_actor)
        if live_cap < max(1, strategy.min_size):
            # pool (at its configured minimum) + one upstream task slot
            # don't fit: run upstream to completion first, then pool at
            # full width — the barrier removes the CPU contention
            sources = iter(list(sources))
        else:
            pool_cap = live_cap
    max_pool = max(1, min(strategy.max_size, pool_cap))
    min_pool = max(1, min(strategy.min_size, max_pool))

    pool = [Worker.remote(factory_blob) for _ in range(min_pool)]
    load = {id(a): 0 for a in pool}  # actor -> queued block count
    by_id = {id(a): a for a in pool}
    inflight: dict = {}  # result_ref -> (seq, actor_id)
    done: dict = {}  # seq -> RefBundle
    sources = iter(sources)
    exhausted = False
    submitted = 0
    next_seq = 0
    yielded_rows = 0
    cap = strategy.max_tasks_in_flight_per_actor

    def pick_actor():
        aid = min(load, key=lambda k: load[k])
        if load[aid] >= cap:
            if len(pool) < max_pool:
                a = Worker.remote(factory_blob)
                pool.append(a)
                load[id(a)] = 0
                by_id[id(a)] = a
                return id(a)
            return None
        return aid

    def submit_one() -> bool:
        nonlocal exhausted, submitted
        aid = pick_actor()
        if aid is None:
            return False
        try:
            src = next(sources)
        except StopIteration:
            exhausted = True
            return False
        ref = by_id[aid].run.remote(src)
        inflight[ref] = (submitted, aid)
        load[aid] += 1
        submitted += 1
        return True

    try:
        while True:
            while (not exhausted
                   and (limit_rows is None or yielded_rows < limit_rows)):
                if not submit_one():
                    break
            if not inflight and not done:
                return
            if inflight:
                ready, _ = ray_tpu_torch.wait(list(inflight.keys()),
                                              num_returns=1, timeout=600)
                for ref in ready:
                    seq, aid = inflight.pop(ref)
                    load[aid] -= 1
                    block_ref, meta = ray_tpu_torch.get(ref, timeout=600)
                    done[seq] = (block_ref, meta)
            while next_seq in done:
                block_ref, meta = done.pop(next_seq)
                next_seq += 1
                if meta.num_rows == 0:
                    continue
                yielded_rows += meta.num_rows
                yield block_ref, meta
    finally:
        for a in pool:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass


def run_all_to_all_pipelined(
    bundles: Iterator[RefBundle],
    map_blob: bytes,
    reduce_blob: bytes,
    n_out: int,
    ctx: DataContext,
    keep_empty: bool = False,
) -> Iterator[RefBundle]:
    """Pipelined exchange: shuffle-map tasks launch as upstream bundles
    ARRIVE (overlapping the map phase with whatever still runs upstream),
    and reduce outputs stream to the consumer in completion order. Usable
    whenever n_out and map_fn don't depend on the materialized input set
    (reference: streaming_executor.py — all-to-all operators participate in
    the pipelined topology instead of acting as global barriers). The
    reduce phase still requires every map output for its shard — that
    barrier is inherent to the exchange, not the executor."""
    window = _window_size(ctx)
    map_out: List[List] = []  # [map_i][part_j] -> ref
    inflight: list = []  # completion markers (part-0 refs) for backpressure
    for i, (block_ref, _meta) in enumerate(bundles):
        refs = _exec_shuffle_map.options(num_returns=n_out).remote(
            map_blob, n_out, i, block_ref
        )
        if n_out == 1:
            refs = [refs]
        map_out.append(list(refs))
        inflight.append(refs[0])
        while len(inflight) >= window:
            # bounded in-flight maps: wait for any to land before pulling
            # more input (backpressure against a fast upstream). Loop so a
            # timeout can't silently grow the window; zero progress raises
            # like the reduce phase below.
            ready, inflight = ray_tpu_torch.wait(inflight, num_returns=1,
                                           timeout=600)
            if not ready:
                raise TimeoutError(
                    "all-to-all map phase made no progress for 600s "
                    f"({len(inflight)} shuffle maps outstanding)")
    n_in = len(map_out)
    if n_in == 0:
        return
    pending: dict = {}  # meta_ref -> (j, block_ref)
    for j in range(n_out):
        parts = [map_out[i][j] for i in range(n_in)]
        block_ref, meta_ref = _exec_reduce.options(num_returns=2).remote(
            reduce_blob, *parts
        )
        pending[meta_ref] = (j, block_ref)
    while pending:
        ready, _ = ray_tpu_torch.wait(list(pending.keys()), num_returns=1,
                                timeout=600)
        if not ready:
            raise TimeoutError(
                "all-to-all made no progress for 600s "
                f"({len(pending)} reducers outstanding)")
        for meta_ref in ready:
            j, block_ref = pending.pop(meta_ref)
            meta = ray_tpu_torch.get(meta_ref, timeout=600)
            if keep_empty or meta.num_rows > 0:
                yield block_ref, meta


def run_all_to_all(
    bundles: List[RefBundle],
    map_blob: bytes,
    reduce_blob: bytes,
    n_out: int,
    ctx: DataContext,
    keep_empty: bool = False,
) -> List[RefBundle]:
    """Two-stage exchange: every input block is partitioned into n_out pieces
    (num_returns=n_out), then reducer j combines piece j of every map output."""
    n_in = len(bundles)
    if n_in == 0:
        return []
    map_out: List[List] = []  # [map_i][part_j] -> ref
    for i, (block_ref, _) in enumerate(bundles):
        refs = _exec_shuffle_map.options(num_returns=n_out).remote(
            map_blob, n_out, i, block_ref
        )
        if n_out == 1:
            refs = [refs]
        map_out.append(list(refs))
    out: List[Optional[RefBundle]] = [None] * n_out
    pending: dict = {}  # meta_ref -> (j, block_ref)
    for j in range(n_out):
        parts = [map_out[i][j] for i in range(n_in)]
        block_ref, meta_ref = _exec_reduce.options(num_returns=2).remote(
            reduce_blob, *parts
        )
        pending[meta_ref] = (j, block_ref)
    # drain reducers in completion order; the 600s window is a
    # NO-PROGRESS timeout (it resets whenever any reducer finishes), so
    # long serial makespans on small clusters still complete
    while pending:
        ready, _ = ray_tpu_torch.wait(list(pending.keys()), num_returns=1,
                                timeout=600)
        if not ready:
            raise TimeoutError(
                "all-to-all made no progress for 600s "
                f"({len(pending)} reducers outstanding)")
        for meta_ref in ready:
            j, block_ref = pending.pop(meta_ref)
            out[j] = (block_ref, ray_tpu_torch.get(meta_ref, timeout=600))
    if keep_empty:
        # repartition(n)/split(n) promise exactly n output blocks even when
        # some are empty
        return out
    return [b for b in out if b[1].num_rows > 0]


def put_block(block: Block) -> RefBundle:
    return ray_tpu_torch.put(block), _meta_of(block)


def fetch_block(bundle: RefBundle) -> Block:
    return ray_tpu_torch.get(bundle[0], timeout=600)
