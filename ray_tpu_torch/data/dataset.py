"""Dataset: lazy, distributed, numpy-blocked data pipelines (the port's
counterpart of ``ray_tpu/data/dataset.py``, on the port's core).

Equivalent of the reference Dataset (reference: python/ray/data/dataset.py:178
— map_batches :397, iter_batches :3499, streaming_split :1149). The plan is
a list of logical ops; consecutive one-to-one ops fuse into single tasks per
block; all-to-all ops (repartition / random_shuffle / sort) run as two-stage
num_returns=N exchanges (reference: _internal/push_based_shuffle.py).

Blocks are dicts of numpy columns (``data/block.py``). Seeded shuffles,
samples and sorts make the JAX package's numpy calls in the same order, so
a seeded pipeline gives the same rows in the same order on both packages.
A dataset built on a materialized one starts from its blocks (the
reference's behaviour); the JAX package runs the whole plan again.

Not ported yet (ROADMAP A10; each raises ``NotImplementedError``):
``groupby`` / ``GroupedData``, ``to_pandas`` / ``to_arrow`` /
``to_arrow_refs``, ``write_parquet`` / ``write_csv`` /
``write_webdataset`` / ``write_mongo`` / ``write_sql``. The JAX package's
``iter_jax_batches`` has no counterpart: ``iter_torch_batches`` feeds a
card.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch._private import task_spec as ts
from ray_tpu_torch.data import executor as ex
from ray_tpu_torch.data.block import (
    Block,
    BlockAccessor,
    Schema,
    _as_column,
    _rows_to_block,
    batch_to_block,
    format_batch,
    not_ported,
)
from ray_tpu_torch.data.compute import ActorPoolStrategy, TaskPoolStrategy
from ray_tpu_torch.data.context import DataContext

# ---------------------------------------------------------------------------
# logical ops
# ---------------------------------------------------------------------------


class _Op:
    pass


class _Read(_Op):
    def __init__(self, sources: List[Any], read_fn: Callable[[Any], Block]):
        self.sources = sources
        self.read_fn = read_fn


class _FromBundles(_Op):
    def __init__(self, bundles: List[ex.RefBundle]):
        self.bundles = bundles


class _MapBlock(_Op):
    """Any one-to-one block transform (map/filter/flat_map/map_batches/
    project); fusable. With `compute` set (an ActorPoolStrategy), `fn` is a
    FACTORY returning the block transform — instantiated once per pool actor
    — and the op forms its own (non-fused) stage."""

    def __init__(self, fn: Callable[[Block], Block], name: str,
                 compute=None):
        self.fn = fn
        self.name = name
        self.compute = compute


class _Limit(_Op):
    def __init__(self, n: int):
        self.n = n


class _AllToAll(_Op):
    """Two-stage exchange. map_fn(block, n, idx) -> n blocks;
    reduce_fn(list) -> block; both and n_out are built at execution."""

    def __init__(self, name: str, prepare=None, keep_empty: bool = False,
                 prepare_streaming=None):
        self.name = name
        # prepare(bundles) -> (map_fn, reduce_fn, n_out): built once metas
        # of the input bundles are known (sort boundaries, repartition ranges)
        self.prepare = prepare
        self.keep_empty = keep_empty  # exact-n ops keep empty output blocks
        # prepare_streaming() -> (map_fn, reduce_fn, n_out): available when
        # the op needs NOTHING from the materialized input set — the
        # executor then pipelines shuffle-maps against the live upstream
        # instead of inserting a barrier (executor.run_all_to_all_pipelined)
        self.prepare_streaming = prepare_streaming


class _Union(_Op):
    def __init__(self, others: List["Dataset"]):
        self.others = others


class _Zip(_Op):
    def __init__(self, other: "Dataset"):
        self.other = other


# ---------------------------------------------------------------------------


def _chain(fns: List[Callable]) -> Callable:
    if len(fns) == 1:
        return fns[0]

    def chained(x):
        for f in fns:
            x = f(x)
        return x

    return chained


class Dataset:
    """Lazy dataset. All transforms return a new Dataset sharing upstream
    plan; execution happens on consumption (iter/take/count/write/...)."""

    def __init__(self, plan: List[_Op], ctx: Optional[DataContext] = None,
                 parent: Optional["Dataset"] = None):
        self._plan = plan
        self._ctx = ctx or DataContext.get_current()
        self._cached: Optional[List[ex.RefBundle]] = None
        self._schema: Optional[Schema] = None
        # the dataset this one extends: once it is materialized, this one
        # runs from its blocks instead of from the start of the plan
        self._parent = parent

    # -- plan building ------------------------------------------------------

    def _with(self, op: _Op) -> "Dataset":
        return Dataset(self._plan + [op], self._ctx, parent=self)

    def _map_op(self, fn, name) -> "Dataset":
        return self._with(_MapBlock(fn, name))

    def _effective_plan(self) -> List[_Op]:
        ds = self._parent
        while ds is not None:
            if ds._cached is not None:
                return ([_FromBundles(list(ds._cached))]
                        + self._plan[len(ds._plan):])
            ds = ds._parent
        return self._plan

    # -- transforms (one-to-one, fused) ------------------------------------

    def map(self, fn: Callable[[dict], dict]) -> "Dataset":
        def do(block: Block) -> Block:
            acc = BlockAccessor(block)
            rows = [fn(r) for r in acc.iter_rows()]
            return _rows_to_block(rows) if rows else acc.slice(0, 0)

        return self._map_op(do, "map")

    def filter(self, fn: Callable[[dict], bool]) -> "Dataset":
        def do(block: Block) -> Block:
            acc = BlockAccessor(block)
            return acc.filter([bool(fn(r)) for r in acc.iter_rows()])

        return self._map_op(do, "filter")

    def flat_map(self, fn: Callable[[dict], List[dict]]) -> "Dataset":
        def do(block: Block) -> Block:
            acc = BlockAccessor(block)
            rows: List[dict] = []
            for r in acc.iter_rows():
                rows.extend(fn(r))
            return _rows_to_block(rows) if rows else acc.slice(0, 0)

        return self._map_op(do, "flat_map")

    def map_batches(
        self,
        fn: Callable,
        *,
        batch_size: Optional[int] = None,
        batch_format: Optional[str] = None,
        fn_kwargs: Optional[dict] = None,
        fn_constructor_args: Optional[tuple] = None,
        fn_constructor_kwargs: Optional[dict] = None,
        compute=None,
        concurrency=None,
        **_ignored,
    ) -> "Dataset":
        """Apply fn to batches (reference: dataset.py:397). fn receives the
        batch as a dict of numpy columns (the only format the port has) and
        returns same-ish; batch_size splits within a block.

        A CLASS `fn` is stateful: it runs on an autoscaling actor pool
        (default ActorPoolStrategy(1, 1); pass `compute=` or `concurrency=`
        to size it), constructed once per actor with fn_constructor_args —
        the reference's ActorPoolMapOperator path (compute.py:71)."""
        fmt = batch_format or self._ctx.default_batch_format
        format_batch({}, fmt)  # refuse a format the port lacks right here
        kwargs = fn_kwargs or {}
        is_class = isinstance(fn, type)

        if concurrency is not None and compute is None:
            if isinstance(concurrency, (tuple, list)):
                compute = ActorPoolStrategy(int(concurrency[0]),
                                            int(concurrency[1]))
            else:
                compute = ActorPoolStrategy(int(concurrency), int(concurrency))
        if is_class and compute is None:
            compute = ActorPoolStrategy()
        if compute is not None and not isinstance(compute, ActorPoolStrategy):
            if isinstance(compute, TaskPoolStrategy):
                compute = None
            else:
                raise TypeError(f"unsupported compute strategy: {compute!r}")
        if is_class and compute is None:
            raise ValueError("a callable class requires an ActorPoolStrategy")
        if compute is not None and not is_class and fn_constructor_args:
            raise ValueError("fn_constructor_args requires a class fn")

        def apply_batches(callable_fn, block: Block) -> Block:
            acc = BlockAccessor(block)
            n = acc.num_rows()
            if n == 0:
                return block
            size = batch_size or n
            outs = []
            for start in range(0, n, size):
                piece = acc.slice(start, min(start + size, n))
                out = callable_fn(format_batch(piece, fmt), **kwargs)
                outs.append(batch_to_block(out))
            return BlockAccessor.concat(outs)

        if compute is None:
            return self._map_op(lambda b: apply_batches(fn, b), "map_batches")

        ctor_args = fn_constructor_args or ()
        ctor_kwargs = fn_constructor_kwargs or {}

        def make_fn():
            inst = fn(*ctor_args, **ctor_kwargs) if is_class else fn
            return lambda b: apply_batches(inst, b)

        return self._with(_MapBlock(make_fn, "map_batches", compute=compute))

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        def do(block: Block) -> Block:
            col = _as_column(fn(BlockAccessor(block).to_numpy()))
            return {**block, name: col}

        return self._map_op(do, "add_column")

    def drop_columns(self, cols: List[str]) -> "Dataset":
        def do(block: Block) -> Block:
            missing = [c for c in cols if c not in block]
            if missing:
                raise KeyError(f"no such columns: {missing}")
            return {k: v for k, v in block.items() if k not in cols}

        return self._map_op(do, "drop_columns")

    def select_columns(self, cols: List[str]) -> "Dataset":
        return self._map_op(lambda b: BlockAccessor(b).select(cols),
                            "select_columns")

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        def do(block: Block) -> Block:
            return {mapping.get(k, k): v for k, v in block.items()}

        return self._map_op(do, "rename_columns")

    def limit(self, n: int) -> "Dataset":
        return self._with(_Limit(n))

    # -- transforms (all-to-all) -------------------------------------------

    def repartition(self, num_blocks: int) -> "Dataset":
        """Exact re-split into num_blocks, preserving global row order
        (reference: dataset.py repartition shuffle=False path)."""

        def prepare(bundles):
            rows = [m.num_rows for _, m in bundles]
            offsets = np.concatenate([[0], np.cumsum(rows)])
            total = int(offsets[-1])
            # target global row ranges per output block
            bounds = [round(total * j / num_blocks)
                      for j in range(num_blocks + 1)]

            def map_fn(block, n, idx):
                acc = BlockAccessor(block)
                lo = int(offsets[idx])
                out = []
                for j in range(n):
                    s = max(bounds[j] - lo, 0)
                    e = min(bounds[j + 1] - lo, acc.num_rows())
                    out.append(acc.slice(s, max(e, s)))
                return out

            def reduce_fn(parts):
                return BlockAccessor.concat(parts)

            return map_fn, reduce_fn, num_blocks

        return self._with(_AllToAll("repartition", prepare=prepare,
                                    keep_empty=True))

    def random_shuffle(self, *, seed: Optional[int] = None,
                       num_blocks: Optional[int] = None) -> "Dataset":
        """Global row shuffle as a 2-stage exchange (reference:
        dataset.py random_shuffle → push_based_shuffle). With an explicit
        `num_blocks` the exchange PIPELINES against upstream (shuffle-map
        tasks start while earlier stages still stream); otherwise the
        output block count matches the input, which requires a barrier to
        count the inputs first."""
        def build(n_out):
            # seed drawn at EXECUTION (build runs once per plan execution),
            # so re-iterating an unseeded shuffle re-randomizes
            base = seed if seed is not None else np.random.randint(0, 2**31)

            def map_fn(block, n, idx):
                acc = BlockAccessor(block)
                rng = np.random.default_rng(base * 100003 + idx)
                assign = rng.integers(0, n, acc.num_rows())
                return [acc.filter(assign == j) for j in range(n)]

            def reduce_fn(parts):
                b = BlockAccessor.concat(parts)
                acc = BlockAccessor(b)
                if acc.num_rows() == 0:
                    return b
                rng = np.random.default_rng(base + 17)
                return acc.take_rows(rng.permutation(acc.num_rows()))

            return map_fn, reduce_fn, n_out

        if num_blocks is not None:
            return self._with(_AllToAll(
                "random_shuffle", prepare_streaming=lambda: build(num_blocks)))
        return self._with(_AllToAll(
            "random_shuffle",
            prepare=lambda bundles: build(max(1, len(bundles)))))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        """Sample-partitioned distributed sort (reference: dataset.py sort →
        _internal/planner/exchange/sort_task_spec.py boundary sampling)."""

        def prepare(bundles):
            n_out = max(1, len(bundles))
            # boundary sampling: fetch a small sample of the key column from
            # each block, pick n_out-1 quantile boundaries
            sample_refs = [
                ex._exec_block.options(num_returns=2).remote(
                    ts.dumps_function(
                        lambda b, k=key: BlockAccessor(
                            BlockAccessor(b).sample(20, seed=0)).select([k])
                    ),
                    ref,
                )
                for ref, _ in bundles
            ]
            samples = [ray_tpu_torch.get(block_ref, timeout=600)[key]
                       for block_ref, _meta in sample_refs]
            allv = np.sort(np.concatenate(samples))
            qs = [allv[int(len(allv) * j / n_out)] for j in range(1, n_out)]

            def map_fn(block, n, idx):
                acc = BlockAccessor(block)
                part = np.searchsorted(np.asarray(qs), block[key],
                                       side="right")
                if descending:
                    part = (n - 1) - part
                return [acc.filter(part == j) for j in range(n)]

            def reduce_fn(parts):
                b = BlockAccessor.concat(parts)
                if BlockAccessor(b).num_rows() == 0:
                    return b
                return BlockAccessor(b).sort(key, descending)

            return map_fn, reduce_fn, n_out

        return self._with(_AllToAll("sort", prepare=prepare))

    def groupby(self, key: str):
        raise not_ported("groupby (GroupedData)")

    def union(self, *others: "Dataset") -> "Dataset":
        return self._with(_Union(list(others)))

    def zip(self, other: "Dataset") -> "Dataset":
        return self._with(_Zip(other))

    def random_sample(self, fraction: float, *, seed=None) -> "Dataset":
        def do(block: Block) -> Block:
            acc = BlockAccessor(block)
            rng = np.random.default_rng(seed)
            return acc.filter(rng.random(acc.num_rows()) < fraction)

        return self._map_op(do, "random_sample")

    # -- execution ----------------------------------------------------------

    def _stream(self) -> Iterator[ex.RefBundle]:
        """Execute the plan, yielding output bundles as they materialize."""
        if self._cached is not None:
            yield from self._cached
            return

        ctx = self._ctx
        stream: Optional[Iterator[ex.RefBundle]] = None
        sources: Optional[List[Any]] = None
        read_fn: Optional[Callable] = None
        fns: List[Callable] = []
        limit: Optional[int] = None

        def flush() -> Iterator[ex.RefBundle]:
            nonlocal stream, sources, read_fn, fns, limit
            if sources is not None:
                chain = _chain([read_fn] + fns) if fns else read_fn
                out = ex.run_oneone_stage(iter(sources),
                                          ts.dumps_function(chain), ctx,
                                          limit_rows=limit)
            elif fns:
                chain = _chain(fns)
                upstream = stream

                def srcs():
                    for ref, _m in upstream:
                        yield ref

                out = ex.run_oneone_stage(srcs(), ts.dumps_function(chain),
                                          ctx, limit_rows=limit)
            else:
                out = stream if stream is not None else iter(())
            if limit is not None:
                out = _truncate(out, limit)
            sources, read_fn, fns, limit = None, None, [], None
            return out

        def barrier() -> List[ex.RefBundle]:
            return list(flush())

        for op in self._effective_plan():
            if isinstance(op, _Read):
                sources, read_fn = list(op.sources), op.read_fn
            elif isinstance(op, _FromBundles):
                stream = iter(op.bundles)
            elif isinstance(op, _MapBlock):
                if op.compute is not None:
                    # actor stage: own (non-fused) stage over an actor pool
                    upstream = flush()

                    def srcs(u=upstream):
                        for ref, _m in u:
                            yield ref

                    stream = ex.run_actor_stage(
                        srcs(), ts.dumps_function(op.fn), op.compute, ctx,
                        upstream_live=True)
                    continue
                if limit is not None:
                    # a map after a limit must see only the limited rows —
                    # flush so the truncation happens before this fn
                    stream = flush()
                fns.append(op.fn)
            elif isinstance(op, _Limit):
                limit = op.n if limit is None else min(limit, op.n)
            elif isinstance(op, _AllToAll):
                if op.prepare_streaming is not None:
                    # no barrier: shuffle-maps launch while upstream streams
                    map_fn, reduce_fn, n_out = op.prepare_streaming()
                    stream = ex.run_all_to_all_pipelined(
                        flush(), ts.dumps_function(map_fn),
                        ts.dumps_function(reduce_fn), n_out, ctx,
                        keep_empty=op.keep_empty)
                    continue
                bundles = barrier()
                map_fn, reduce_fn, n_out = op.prepare(bundles)
                stream = iter(ex.run_all_to_all(
                    bundles, ts.dumps_function(map_fn),
                    ts.dumps_function(reduce_fn), n_out, ctx,
                    keep_empty=op.keep_empty))
            elif isinstance(op, _Union):
                bundles = barrier()
                tail = [iter(o._stream()) for o in op.others]

                def chained(b=bundles, t=tail):
                    yield from b
                    for it in t:
                        yield from it

                stream = chained()
            elif isinstance(op, _Zip):
                left = barrier()
                right = list(op.other._stream())
                stream = iter(_zip_bundles(left, right, ctx))
            else:
                raise AssertionError(op)

        yield from flush()

    def materialize(self) -> "Dataset":
        """Execute fully and pin blocks (reference: dataset.py materialize)."""
        if self._cached is None:
            self._cached = list(self._stream())
        return self

    # -- consumption --------------------------------------------------------

    def count(self) -> int:
        self.materialize()
        return sum(m.num_rows for _, m in self._cached)

    def num_blocks(self) -> int:
        self.materialize()
        return len(self._cached)

    def size_bytes(self) -> int:
        self.materialize()
        return sum(m.size_bytes for _, m in self._cached)

    def schema(self) -> Optional[Schema]:
        """Column names with their numpy dtypes and row shapes, from the
        first block."""
        if self._schema is None:
            for ref, _m in self._stream():
                self._schema = Schema(ray_tpu_torch.get(ref, timeout=600))
                break
        return self._schema

    def columns(self) -> List[str]:
        s = self.schema()
        return list(s.names) if s else []

    def take(self, n: int = 20) -> List[dict]:
        out: List[dict] = []
        for ref, _m in self._stream():
            b = ray_tpu_torch.get(ref, timeout=600)
            for row in BlockAccessor(b).iter_rows():
                out.append(row)
                if len(out) >= n:
                    return out
        return out

    def take_all(self) -> List[dict]:
        out: List[dict] = []
        for ref, _m in self._stream():
            out.extend(BlockAccessor(
                ray_tpu_torch.get(ref, timeout=600)).to_pylist())
        return out

    def show(self, n: int = 20) -> None:
        for row in self.take(n):
            print(row)

    def iter_rows(self) -> Iterator[dict]:
        for ref, _m in self._stream():
            yield from BlockAccessor(
                ray_tpu_torch.get(ref, timeout=600)).iter_rows()

    def to_pandas(self):
        raise not_ported("to_pandas")

    def to_arrow(self):
        raise not_ported("to_arrow")

    def to_arrow_refs(self):
        raise not_ported("to_arrow_refs")

    def to_numpy(self) -> Dict[str, np.ndarray]:
        blocks = [ray_tpu_torch.get(r, timeout=600) for r, _ in self._stream()]
        return BlockAccessor(BlockAccessor.concat(blocks)).to_numpy()

    # -- iteration (the Train ingestion path) -------------------------------

    def iterator(self) -> "DataIterator":
        from ray_tpu_torch.data.iterator import DataIterator

        return DataIterator(self)

    def iter_batches(self, **kw) -> Iterator:
        return self.iterator().iter_batches(**kw)

    def iter_torch_batches(self, **kw) -> Iterator:
        return self.iterator().iter_torch_batches(**kw)

    # -- splits -------------------------------------------------------------

    def split(self, n: int, *, equal: bool = False) -> List["Dataset"]:
        """Split into n datasets at block granularity; equal=True rebalances
        to exactly-equal row counts via the repartition exchange (reference:
        dataset.py split/split_proportionately)."""
        src = self
        if equal:
            total = self.count()  # materializes: the rebalance reads its blocks
            per = total // n
            src = self.limit(per * n).repartition(n)
        src.materialize()
        bundles = src._cached
        if equal:
            parts = [[b] for b in bundles]
        else:
            parts = [bundles[i::n] for i in range(n)]
        return [Dataset([_FromBundles(p)], self._ctx) for p in parts]

    def streaming_split(self, n: int, *, equal: bool = True,
                        locality_hints=None) -> List["DataIterator"]:
        """Per-consumer iterators for train workers (reference:
        dataset.py:1149). Shards are fixed up front; each DataIterator is
        picklable (holds block refs) so it ships to worker actors."""
        return [d.iterator() for d in self.split(n, equal=equal)]

    def train_test_split(self, test_size: float, *, shuffle: bool = False,
                         seed=None):
        ds = self.random_shuffle(seed=seed) if shuffle else self
        # materialize ONCE and split the pinned blocks — limit/_drop_first on
        # the raw plan would each re-execute it (a fresh unseeded shuffle per
        # branch would leak rows between the splits)
        ds.materialize()
        base = Dataset([_FromBundles(list(ds._cached))], self._ctx)
        total = ds.count()
        n_test = int(total * test_size) if test_size < 1 else int(test_size)
        return base._drop_first(n_test), base.limit(n_test)

    def _drop_first(self, n: int) -> "Dataset":
        # keep per-input-block outputs: n_out = len(bundles), identity routing
        def prepare2(bundles):
            rows = [m.num_rows for _, m in bundles]
            offsets = np.concatenate([[0], np.cumsum(rows)])
            n_out = max(1, len(bundles))

            def map_fn(block, nn, idx):
                acc = BlockAccessor(block)
                lo = int(offsets[idx])
                s = min(max(n - lo, 0), acc.num_rows())
                out = [acc.slice(0, 0)] * nn
                out[idx % nn] = acc.slice(s, acc.num_rows())
                return out

            return map_fn, BlockAccessor.concat, n_out

        return self._with(_AllToAll("drop_first", prepare=prepare2))

    # -- writes -------------------------------------------------------------

    def _write(self, path: str, writer: Callable[[Block, str], None],
               ext: str) -> List[str]:
        import os

        os.makedirs(path, exist_ok=True)
        self.materialize()
        paths = []
        for i, (ref, _m) in enumerate(self._cached):
            b = ray_tpu_torch.get(ref, timeout=600)
            p = os.path.join(path, f"part-{i:05d}.{ext}")
            writer(b, p)
            paths.append(p)
        return paths

    def write_parquet(self, path: str) -> List[str]:
        raise not_ported("write_parquet")

    def write_csv(self, path: str) -> List[str]:
        raise not_ported("write_csv")

    def write_json(self, path: str) -> List[str]:
        def w(b, p):
            import json

            with open(p, "w") as f:
                for row in BlockAccessor(b).iter_rows():
                    f.write(json.dumps(row, default=_json_default) + "\n")

        return self._write(path, w, "json")

    def write_tfrecords(self, path: str) -> List[str]:
        """Rows -> tf.train.Example TFRecord files (reference:
        dataset.py write_tfrecords), via the in-tree tf-free codec."""
        def w(b, p):
            from ray_tpu_torch.data.tfrecord import (encode_example,
                                                     write_records)

            write_records(p, (encode_example(row)
                              for row in BlockAccessor(b).iter_rows()))

        return self._write(path, w, "tfrecords")

    def write_webdataset(self, path: str) -> List[str]:
        raise not_ported("write_webdataset")

    def write_mongo(self, uri: str, database: str, collection: str, *,
                    client_factory=None) -> int:
        raise not_ported("write_mongo")

    def write_sql(self, sql: str, connection_factory) -> int:
        raise not_ported("write_sql")

    # -- misc ---------------------------------------------------------------

    def stats(self) -> str:
        self.materialize()
        return (f"Dataset(blocks={len(self._cached)}, "
                f"rows={sum(m.num_rows for _, m in self._cached)}, "
                f"bytes={sum(m.size_bytes for _, m in self._cached)})")

    def __repr__(self) -> str:
        names = [getattr(op, "name", type(op).__name__.strip("_"))
                 for op in self._plan]
        return f"Dataset({' -> '.join(names)})"


def _json_default(value):
    """A tensor column's row and numpy scalars, as JSON lists and
    numbers (the JAX package's rows hold lists there)."""
    if isinstance(value, (np.ndarray, np.generic)):
        return value.tolist()
    raise TypeError(f"{type(value).__name__} is not JSON serializable")


def _truncate(stream: Iterator[ex.RefBundle],
              n: int) -> Iterator[ex.RefBundle]:
    """Cap a bundle stream at n rows, slicing the boundary block."""
    seen = 0
    for ref, meta in stream:
        if seen + meta.num_rows <= n:
            seen += meta.num_rows
            yield ref, meta
        else:
            keep = n - seen
            if keep > 0:
                b = ray_tpu_torch.get(ref, timeout=600)
                yield ex.put_block(BlockAccessor(b).slice(0, keep))
            seen = n
        if seen >= n:
            return


def _zip_bundles(left: List[ex.RefBundle], right: List[ex.RefBundle],
                 ctx) -> List[ex.RefBundle]:
    """Row-align right blocks to left block boundaries, then column-concat
    blockwise (reference: dataset.py zip)."""
    lrows = [m.num_rows for _, m in left]
    # realign right side to left's row ranges
    rblocks = [ray_tpu_torch.get(r, timeout=600) for r, _ in right]
    rall = BlockAccessor(BlockAccessor.concat(rblocks))
    total_l = sum(lrows)
    if rall.num_rows() != total_l:
        raise ValueError(
            f"zip requires equal row counts: {total_l} vs {rall.num_rows()}")
    out: List[ex.RefBundle] = []
    off = 0
    for (lref, lmeta) in left:
        merged = dict(ray_tpu_torch.get(lref, timeout=600))
        rb = rall.slice(off, off + lmeta.num_rows)
        off += lmeta.num_rows
        for name, col in rb.items():
            if name in merged:
                name = name + "_1"
            merged[name] = col
        out.append(ex.put_block(merged))
    return out


class GroupedData:
    """Not ported yet: the JAX package's groupby runs on pandas, which the
    card's machine does not have (ROADMAP A10: a numpy ``GroupedData``)."""

    def __init__(self, *args, **kwargs):
        raise not_ported("GroupedData")
