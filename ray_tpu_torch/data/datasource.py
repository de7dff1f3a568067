"""Datasources: creation + file reads (the port's counterpart of
``ray_tpu/data/datasource.py``; reference: python/ray/data/read_api.py and
datasource/ — json/text/numpy/binary/tfrecords/range/items). Each read op
is (sources, read_fn): one fused task per source, with the JAX package's
block boundaries.

Not ported yet (ROADMAP A10; each raises ``NotImplementedError``): the
readers and constructors that need pyarrow or pandas, or a package the
card's machine does not have: ``read_parquet``, ``read_csv``,
``from_pandas``, ``from_arrow``, ``read_images``, ``from_huggingface`` /
``read_huggingface``, ``read_sql``, ``read_webdataset``, ``read_mongo``.
"""
from __future__ import annotations

import builtins
import glob as globmod
import math
import os
from typing import Any, List

import numpy as np

from ray_tpu_torch.data.block import (ITEM_COL, Block, _column,
                                      _object_column, _rows_to_block,
                                      batch_to_block, not_ported)
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.dataset import Dataset, _Read


def _resolve_paths(paths) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if not f.startswith(".")))
        elif any(c in p for c in "*?["):
            out.extend(sorted(globmod.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files match {paths}")
    return out


def _spans(n: int, parallelism: int) -> List[tuple]:
    ctx = DataContext.get_current()
    p = parallelism if parallelism > 0 else min(ctx.read_parallelism, max(1, n))
    bounds = [round(n * i / p) for i in builtins.range(p + 1)]
    return [(bounds[i], bounds[i + 1]) for i in builtins.range(p)]


def range(n: int, *, parallelism: int = -1) -> Dataset:
    """Integers [0, n) in `parallelism` blocks (reference: read_api.py
    range — column name 'id')."""

    def read(span) -> Block:
        lo, hi = span
        return {"id": np.arange(lo, hi, dtype=np.int64)}

    return Dataset([_Read(_spans(n, parallelism), read)])


def range_tensor(n: int, *, shape=(1,), parallelism: int = -1) -> Dataset:
    def read(span) -> Block:
        lo, hi = span
        base = np.arange(lo, hi, dtype=np.int64).reshape(
            (-1,) + (1,) * len(shape))
        return {"data": np.broadcast_to(
            base, (hi - lo,) + tuple(shape)).copy()}

    return Dataset([_Read(_spans(n, parallelism), read)])


def from_items(items: List[Any], *, parallelism: int = -1) -> Dataset:
    ctx = DataContext.get_current()
    p = parallelism if parallelism > 0 else min(ctx.read_parallelism,
                                                max(1, len(items)))
    chunk = math.ceil(len(items) / p) if items else 1
    sources = [items[i:i + chunk] for i in builtins.range(0, len(items), chunk)]

    def read(chunk_items) -> Block:
        if chunk_items and isinstance(chunk_items[0], dict):
            return _rows_to_block(chunk_items)
        return {ITEM_COL: _column(chunk_items)}

    return Dataset([_Read(sources or [[]], read)])


def from_numpy(arrs, column: str = "data") -> Dataset:
    if isinstance(arrs, np.ndarray):
        arrs = [arrs]
    sources = list(arrs)

    def read(arr) -> Block:
        return batch_to_block({column: arr})

    return Dataset([_Read(sources, read)])


def read_json(paths, *, parallelism: int = -1) -> Dataset:
    """JSONL files (reference: read_api.py read_json)."""
    files = _resolve_paths(paths)

    def read(path) -> Block:
        import json

        rows = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    rows.append(json.loads(line))
        return _rows_to_block(rows)

    return Dataset([_Read(files, read)])


def read_text(paths, *, parallelism: int = -1) -> Dataset:
    files = _resolve_paths(paths)

    def read(path) -> Block:
        with open(path) as f:
            lines = [ln.rstrip("\n") for ln in f]
        return {"text": _object_column(lines)}

    return Dataset([_Read(files, read)])


def read_numpy(paths, *, parallelism: int = -1) -> Dataset:
    files = _resolve_paths(paths)

    def read(path) -> Block:
        return batch_to_block({"data": np.load(path)})

    return Dataset([_Read(files, read)])


def read_tfrecords(paths, *, verify_crc: bool = True,
                   parallelism: int = -1) -> Dataset:
    """TFRecord files of tf.train.Example records (reference:
    datasource/tfrecords_datasource.py). No TensorFlow dependency: framing
    and Example protobufs are decoded in-tree (data/tfrecord.py).
    Single-element lists unwrap to scalars, matching the reference's read
    behavior; bytes stay bytes."""
    files = _resolve_paths(paths)

    def read(path) -> Block:
        from ray_tpu_torch.data.tfrecord import decode_example, read_records

        rows = []
        for payload in read_records(path, verify_crc=verify_crc):
            row = {}
            for key, values in decode_example(payload).items():
                row[key] = values[0] if len(values) == 1 else values
            rows.append(row)
        return _rows_to_block(rows)

    return Dataset([_Read(files, read)])


def read_binary_files(paths, *, include_paths: bool = False,
                      parallelism: int = -1) -> Dataset:
    """One row per file with its raw bytes (reference:
    python/ray/data/read_api.py read_binary_files) — the generic ingest for
    audio/archives/protos that downstream map_batches decode."""
    files = _resolve_paths(paths)

    def read(path) -> Block:
        with open(path, "rb") as f:
            data = f.read()
        cols = {"bytes": _object_column([data])}
        if include_paths:
            cols["path"] = _object_column([path])
        return cols

    return Dataset([_Read(files, read)])


def _not_ported(name: str):
    def refuse(*args, **kwargs):
        raise not_ported(name)

    refuse.__name__ = refuse.__qualname__ = name
    refuse.__doc__ = "Not ported yet (ROADMAP A10): raises."
    return refuse


from_pandas = _not_ported("from_pandas")
from_arrow = _not_ported("from_arrow")
read_parquet = _not_ported("read_parquet")
read_csv = _not_ported("read_csv")
read_images = _not_ported("read_images")
from_huggingface = _not_ported("from_huggingface")
read_huggingface = _not_ported("read_huggingface")
read_sql = _not_ported("read_sql")
read_webdataset = _not_ported("read_webdataset")
read_mongo = _not_ported("read_mongo")
