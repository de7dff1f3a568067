"""The port's Data (``ray_tpu_torch.data``: numpy blocks, the streaming
executor on the port's tasks and actors, ``Dataset``, ``DataIterator``)
against the JAX package's ``ray_tpu.data``, one cluster per package for
the module.

- Each case builds the same seeded pipeline on both packages and must
  give equal rows, block by block where JAX defines the boundaries:
  the sources, ``map`` / ``filter`` / ``flat_map``, ``map_batches`` on
  tasks and on an actor pool, the column ops and ``limit``,
  ``repartition``, a seeded ``random_shuffle`` (with ``num_blocks`` its
  blocks arrive in completion order, so they are compared as a set),
  ``sort`` with ties both ways, ``union``, ``zip``, ``random_sample``,
  ``split``, ``streaming_split``, ``train_test_split``, ``iter_batches``
  across blocks with ``drop_last`` and a seeded local shuffle buffer,
  ``take`` / ``count`` / ``columns``.
- The block (no cluster): the port's numpy ``BlockAccessor`` against the
  JAX package's Arrow one: a stable sort both ways, an empty concat that
  keeps its columns, rows with missing keys, list and tensor columns,
  ``sample``.
- The port alone: what needs pandas or pyarrow raises naming ROADMAP A10,
  and ``iter_torch_batches(device="cuda")`` without a card raises.

Pipeline functions are defined inside the case functions and reach only
modules, so both picklers carry them by value."""
from __future__ import annotations

import contextlib
import gc

import numpy as np
import pytest


@pytest.fixture(scope="module")
def torch_rt():
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def jax_rt():
    pytest.importorskip("jax")
    import ray_tpu

    if ray_tpu.is_initialized():  # left by a file run before in this process
        ray_tpu.shutdown()
    with _collector_off():
        ray_tpu.init(num_cpus=4)
    yield ray_tpu
    with _collector_off():
        ray_tpu.shutdown()


@contextlib.contextmanager
def _collector_off():
    """For calls into the JAX package's cluster: its RpcClient guards
    call_async with a plain Lock that an ObjectRef's __del__ re-enters
    when the collector runs inside it (``tests/test_torch_core.py``)."""
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.collect()


def _plain(x):
    """Numpy values as Python ones, so both packages' results compare."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return [_plain(v) for v in x] if x.dtype == object else x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def _blocks(ds):
    """The dataset's blocks, in order, each as its numpy batch."""
    return [_plain(b) for b in ds.iter_batches(batch_size=None)]


# ---------------------------------------------------------------- cases


def case_range(d):
    return _blocks(d.range(25, parallelism=4))


def case_range_tensor(d):
    return _blocks(d.range_tensor(6, shape=(2, 3), parallelism=2))


def case_from_items_rows(d):
    items = [{"a": i, "b": str(i), "c": i / 2} for i in range(7)]
    return _blocks(d.from_items(items, parallelism=3))


def case_from_items_scalars(d):
    return _blocks(d.from_items(list(range(10)), parallelism=4))


def case_from_numpy(d):
    # 1-D arrays here: 2-D ones are the tensor path that range_tensor
    # covers against JAX; the port's 2-D from_numpy has a test of its own
    arrs = [np.arange(6), np.arange(6, 10) * 0.5]
    return _blocks(d.from_numpy(arrs)), _blocks(d.from_numpy(arrs[0], "x"))


def case_map_filter_flat_map(d):
    ds = (d.range(12, parallelism=3)
          .map(lambda r: {"id": r["id"], "sq": r["id"] * r["id"]})
          .filter(lambda r: r["id"] % 3 != 0)
          .flat_map(lambda r: [r, {"id": -r["id"], "sq": 0}]))
    return _blocks(ds)


def case_map_batches_tasks(d):
    def fn(b):
        n = len(b["id"])
        return {"id": b["id"], "twice": b["id"] * 2, "n": np.full(n, n)}

    return _blocks(d.range(10, parallelism=2).map_batches(fn, batch_size=3))


def case_map_batches_actor_pool(d):
    class Scale:
        def __init__(self, k):
            self.k = k

        def __call__(self, b):
            return {"id": b["id"] * self.k}

    ds = d.range(16, parallelism=4).map_batches(
        Scale, fn_constructor_args=(3,), concurrency=2, batch_size=2)
    return _blocks(ds)


def case_column_ops_and_limit(d):
    ds = (d.range(10, parallelism=3)
          .add_column("x", lambda b: b["id"] * 1.5)
          .add_column("s", lambda b: [str(v) for v in b["id"]])
          .rename_columns({"x": "y"})
          .drop_columns(["id"])
          .select_columns(["s", "y"])
          .limit(7))
    return _blocks(ds), ds.columns(), ds.count()


def case_repartition(d):
    return (_blocks(d.range(23, parallelism=3).repartition(5)),
            _blocks(d.range(3, parallelism=1).repartition(5)))


def case_shuffle_seeded(d):
    return _blocks(d.range(40, parallelism=4).random_shuffle(seed=11))


def case_shuffle_num_blocks(d):
    ds = d.range(40, parallelism=4).random_shuffle(seed=5, num_blocks=3)
    return sorted(b["id"] for b in _blocks(ds))


def case_sort_ties(d):
    keys = [3, 1, 2, 3, 1, 2, 0, 3, 1, 0, 2, 2]
    ds = d.from_items([{"k": k, "i": i} for i, k in enumerate(keys)],
                      parallelism=3)
    return _blocks(ds.sort("k")), _blocks(ds.sort("k", descending=True))


def case_sort_strings(d):
    words = ["pear", "fig", "apple", "fig", "kiwi", "apple", "date", "fig"]
    ds = d.from_items([{"w": w, "i": i} for i, w in enumerate(words)],
                      parallelism=2)
    return _blocks(ds.sort("w")), _blocks(ds.sort("w", descending=True))


def case_union_zip(d):
    a = d.range(6, parallelism=2)
    b = d.range(6, parallelism=3).map(
        lambda r: {"id": r["id"] * 10, "z": -r["id"]})
    return _blocks(a.union(d.range(3, parallelism=1))), _blocks(a.zip(b))


def case_random_sample(d):
    return _blocks(d.range(30, parallelism=3).random_sample(0.4, seed=9))


def case_split(d):
    ds = d.range(23, parallelism=4)
    return [[_blocks(s) for s in ds.split(3, equal=equal)]
            for equal in (False, True)]


def case_streaming_split(d):
    its = d.range(21, parallelism=4).random_shuffle(seed=2).streaming_split(2)
    return [[_plain(b) for b in it.iter_batches(batch_size=4)] for it in its]


def case_train_test_split(d):
    train, test = d.range(20, parallelism=3).train_test_split(
        0.25, shuffle=True, seed=4)
    return _blocks(train), _blocks(test)


def case_iter_batches(d):
    ds = d.range(20, parallelism=3)
    return [[_plain(b) for b in ds.iter_batches(batch_size=6,
                                                drop_last=drop)]
            for drop in (False, True)]


def case_local_shuffle(d):
    ds = d.range(30, parallelism=3)
    return [_plain(b) for b in ds.iter_batches(
        batch_size=7, local_shuffle_buffer_size=10, local_shuffle_seed=1)]


def case_take_count_columns(d):
    ds = d.range(15, parallelism=2).map(
        lambda r: {"id": r["id"], "t": "x" * r["id"]})
    return ds.take(4), ds.count(), ds.columns(), ds.take_all()[-1]


CASES = [f for name, f in sorted(globals().items())
         if name.startswith("case_")]


# no timeout marker: it would run each case on a thread of its own
# (tests/conftest.py), and Arrow's reads in the JAX package segfaulted
# there about one run in three (ROADMAP C 6), never on the main thread
@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__[5:])
def test_pipeline_equals_jax(torch_rt, jax_rt, case):
    import ray_tpu.data as jd

    import ray_tpu_torch.data as td

    mine = case(td)
    with _collector_off():
        theirs = case(jd)
    assert mine == theirs


# ---------------------------------------------------------------- blocks


def _jax_block(data):
    from ray_tpu.data.block import _to_table

    return _to_table(data)


def _rows_both(fn):
    from ray_tpu.data.block import BlockAccessor as JaxAccessor

    from ray_tpu_torch.data.block import BlockAccessor, _to_block

    return (fn(BlockAccessor, _to_block), fn(JaxAccessor, _jax_block))


def block_sort(acc, make):
    b = make({"k": [2, 1, 2, 0, 1, 2], "i": list(range(6))})
    return [acc(acc(b).sort("k", desc)).to_pylist() for desc in (False, True)]


def block_empty_concat(acc, make):
    b = acc(make({"a": [1, 2], "s": ["x", "y"]})).slice(0, 0)
    out = acc(acc.concat([b, b]))
    return out.num_rows(), list(out.to_numpy())


def block_concat_promotes(acc, make):
    a, b = make({"v": [1, 2]}), make({"v": [0.5]})
    return acc(acc.concat([a, b])).to_pylist()


def block_missing_keys(acc, make):
    rows = [{"a": 1, "b": "x"}, {"a": 2.5, "c": 3}, {"b": "z"}]
    return acc(make(rows)).to_pylist()


def block_list_column(acc, make):
    col = acc(make([{"l": [1, 2]}, {"l": [3]}])).to_numpy()["l"]
    return str(col.dtype), [list(v) for v in col]


def block_tensor_column(acc, make):
    arr = np.arange(24, dtype=np.int32).reshape(4, 3, 2)
    out = acc(make({"t": arr})).to_numpy()["t"]
    return out.shape, str(out.dtype), out.tolist()


def block_sample(acc, make):
    return acc(acc(make({"i": list(range(50))})).sample(7, seed=3)).to_pylist()


def block_scalar_items(acc, make):
    return acc(make([1, 2.5, 3])).to_pylist(), acc(make(["a", "b"])).to_pylist()


BLOCK_CASES = [f for name, f in sorted(globals().items())
               if name.startswith("block_")]


@pytest.mark.parametrize("case", BLOCK_CASES, ids=lambda f: f.__name__[6:])
def test_block_equals_arrow_block(case):
    pytest.importorskip("pyarrow")
    mine, theirs = _rows_both(case)
    assert _plain(mine) == _plain(theirs)


# ---------------------------------------------------------------- the port


def test_what_needs_pandas_or_arrow_raises():
    import ray_tpu_torch.data as td
    from ray_tpu_torch.data.block import format_batch

    for fmt in ("pandas", "pyarrow"):
        with pytest.raises(NotImplementedError, match="A10"):
            format_batch({"a": np.arange(2)}, fmt)
    for name in ("from_pandas", "from_arrow", "read_parquet", "read_csv",
                 "read_images", "from_huggingface", "read_huggingface",
                 "read_sql", "read_webdataset", "read_mongo"):
        with pytest.raises(NotImplementedError, match="A10"):
            getattr(td, name)("x")
    with pytest.raises(NotImplementedError, match="A10"):
        td.GroupedData()
    ds = td.range(4)  # lazy: nothing runs, no cluster needed
    with pytest.raises(NotImplementedError, match="A10"):
        ds.groupby("id")
    with pytest.raises(NotImplementedError, match="A10"):
        ds.map_batches(lambda b: b, batch_format="pandas")
    for name in ("to_pandas", "to_arrow", "to_arrow_refs"):
        with pytest.raises(NotImplementedError, match="A10"):
            getattr(ds, name)()
    with pytest.raises(NotImplementedError, match="A10"):
        ds.write_parquet("x")


def test_to_numpy_concatenates_the_blocks(torch_rt):
    import ray_tpu_torch.data as td

    arrs = [np.arange(6).reshape(3, 2), np.arange(6, 10).reshape(2, 2)]
    ds = td.from_numpy(arrs)
    out = ds.to_numpy()
    assert list(out) == ["data"] and out["data"].shape == (5, 2)
    assert out["data"].tolist() == np.concatenate(arrs).tolist()
    assert [b["data"].tolist() for b in ds.iter_batches(batch_size=None)] \
        == [a.tolist() for a in arrs]
    rows = td.from_items([{"a": 1, "s": "x"}, {"a": 2, "s": "y"}],
                         parallelism=2).to_numpy()
    assert rows["a"].dtype == np.int64 and rows["s"].dtype == object
    assert _plain(rows) == {"a": [1, 2], "s": ["x", "y"]}


def test_cuda_batches_without_a_card_raise(torch_rt, monkeypatch):
    import torch

    import ray_tpu_torch.data as td

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    it = td.range(8, parallelism=2).iterator()
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        next(it.iter_torch_batches(batch_size=4, device="cuda"))
    cpu = list(it.iter_torch_batches(batch_size=4, device="cpu",
                                     dtypes=torch.float32))
    assert [b["id"].tolist() for b in cpu] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert {b["id"].dtype for b in cpu} == {torch.float32}
