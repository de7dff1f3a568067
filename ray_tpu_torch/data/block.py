"""Blocks: the unit of data the executor moves through the object store
(the port's counterpart of ``ray_tpu/data/block.py``).

The JAX package's block is a ``pyarrow.Table``. The card's machine has
neither pyarrow nor pandas, so the port's block is a dict of column name
-> ``np.ndarray`` of N rows, in column order. The object store carries
numeric columns out of band (``_private/serialization.py``), so a block a
task reads aliases the store's read-only mapping, as Arrow's zero-copy
``to_numpy`` does.

Arrow's behaviour is kept where a user sees it:

- ints, floats and bools give int64, float64 and bool columns (ints and
  floats mixed: float64); strings, bytes, lists, dicts and any column
  with a missing value (None) give object columns, which is what the JAX
  package's ``to_numpy`` hands a user for them;
- a list of row dicts takes the first row's keys (``pa.Table.from_pylist``),
  a missing key reads None;
- (N, *shape) ndarray columns (tensor columns) keep their shape;
- ``sort`` is stable ascending and descending (``pc.sort_indices``);
- ``concat`` of empty blocks keeps the first block's columns;
- rows (``iter_rows``, ``to_pylist``) hold Python scalars.

One difference: a tensor column's row is its ndarray of the row's shape
(the reference's behaviour), where Arrow's row is a flat list.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import numpy as np

# Column name used when the user data is a bare sequence of scalars/arrays
# (reference uses the same convention, data/_internal/util.py "item").
ITEM_COL = "item"

Block = Dict[str, np.ndarray]

_NOT_PORTED = ("{what} needs pandas or pyarrow, which the card's machine does "
               "not have: the port's Data (ray_tpu_torch.data) keeps numpy "
               "blocks, and {what} is not ported yet (ROADMAP A10)")


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(_NOT_PORTED.format(what=what))


def _object_column(values: list) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def _column(values: list) -> np.ndarray:
    """One column from a list of row values, typed as Arrow would type it
    (see the module docstring)."""
    if values and all(isinstance(v, np.ndarray) for v in values):
        shape, dtype = values[0].shape, values[0].dtype
        if dtype != object and all(v.shape == shape for v in values):
            return np.stack(values)  # a tensor column
    kinds = set()
    for v in values:
        if v is None:
            kinds.add("null")
        elif isinstance(v, (bool, np.bool_)):
            kinds.add("b")
        elif isinstance(v, (int, np.integer)):
            kinds.add("i")
        elif isinstance(v, (float, np.floating)):
            kinds.add("f")
        else:
            kinds.add("o")
    typed = kinds - {"null"}
    if typed == {"b"}:
        kind = bool
    elif typed == {"i"}:
        kind = np.int64
    elif typed and typed <= {"i", "f"}:
        kind = np.float64
    else:
        return _object_column(values)
    if "null" not in kinds:
        return np.array(values, dtype=kind)
    # a numeric column with missing values: objects, each value of the
    # column's type (Arrow's null in a typed column)
    cast = {bool: bool, np.int64: int, np.float64: float}[kind]
    return _object_column([None if v is None else cast(v) for v in values])


def _as_column(v: Any) -> np.ndarray:
    """A column of a dict batch: an ndarray stays as it is (strings and
    bytes become objects), anything else goes through ``np.asarray`` as
    in the JAX package's ``_to_table``."""
    if not isinstance(v, np.ndarray):
        try:
            v = np.asarray(v)
        except ValueError:  # ragged rows
            return _column(list(v))
        if v.dtype == object:
            return _column(list(v))
    if v.ndim == 0:
        raise TypeError(f"a block column needs one value a row, got a "
                        f"0-d {v.dtype} array")
    if v.dtype.kind in "US":
        return v.astype(object)
    return v


def _rows_to_block(rows: List[dict]) -> Block:
    if not rows:
        return {}
    for r in rows:
        if not isinstance(r, dict):
            raise TypeError(f"a row must be a dict, got {type(r).__name__}")
    names = list(rows[0])
    return {k: _column([r.get(k) for r in rows]) for k in names}


def _to_block(data: Any) -> Block:
    """Normalize user data (dict of columns / list of rows / list of
    scalars) into a block."""
    if isinstance(data, dict):
        block = {k: _as_column(v) for k, v in data.items()}
        lengths = {len(v) for v in block.values()}
        if len(lengths) > 1:
            raise ValueError(f"block columns of unequal lengths: "
                             f"{ {k: len(v) for k, v in block.items()} }")
        return block
    if isinstance(data, list):
        if data and isinstance(data[0], dict):
            return _rows_to_block(data)
        return {ITEM_COL: _column(data)}
    if type(data).__module__.split(".")[0] in ("pandas", "pyarrow"):
        raise not_ported(f"a {type(data).__name__} batch")
    raise TypeError(f"cannot convert {type(data)} to a Block")


def _concat_columns(parts: List[np.ndarray]) -> np.ndarray:
    if len({p.shape[1:] for p in parts}) > 1:
        # tensor columns of other row shapes: one object per row
        parts = [p if p.ndim == 1 else _object_column(list(p)) for p in parts]
    return np.concatenate(parts)


class Schema:
    """Column names with each column's numpy dtype and row shape (the
    port's counterpart of the ``pa.Schema`` of the JAX package's
    ``Dataset.schema()``)."""

    def __init__(self, block: Block):
        self.names = list(block)
        self.types = [block[n].dtype for n in self.names]
        self.shapes = [tuple(block[n].shape[1:]) for n in self.names]

    def __eq__(self, other):
        return (isinstance(other, Schema) and self.names == other.names
                and self.types == other.types and self.shapes == other.shapes)

    def __repr__(self):
        cols = ", ".join(f"{n}: {t}{list(s) if s else ''}"
                         for n, t, s in zip(self.names, self.types,
                                            self.shapes))
        return f"Schema({cols})"


class BlockAccessor:
    """Format-agnostic view over one block (reference: data/block.py
    BlockAccessor)."""

    def __init__(self, block: Block):
        self._b = block

    @staticmethod
    def for_block(block: Any) -> "BlockAccessor":
        return BlockAccessor(_to_block(block))

    @property
    def block(self) -> Block:
        return self._b

    def num_rows(self) -> int:
        for col in self._b.values():
            return len(col)
        return 0

    def size_bytes(self) -> int:
        return sum(col.nbytes for col in self._b.values())

    def schema(self) -> Schema:
        return Schema(self._b)

    def slice(self, start: int, end: int) -> Block:
        return {k: v[start:end] for k, v in self._b.items()}

    def select(self, columns: List[str]) -> Block:
        return {c: self._b[c] for c in columns}

    def take_rows(self, indices) -> Block:
        idx = np.asarray(indices, dtype=np.int64)
        return {k: v[idx] for k, v in self._b.items()}

    def filter(self, mask) -> Block:
        mask = np.asarray(mask, dtype=bool)
        return {k: v[mask] for k, v in self._b.items()}

    def to_pandas(self):
        raise not_ported("to_pandas")

    def to_numpy(self, columns: Optional[List[str]] = None
                 ) -> Dict[str, np.ndarray]:
        return {c: self._b[c] for c in (columns or list(self._b))}

    def to_pylist(self) -> List[dict]:
        return list(self.iter_rows())

    def iter_rows(self) -> Iterable[dict]:
        names = list(self._b)
        cols = [v.tolist() if v.ndim == 1 else list(v)
                for v in self._b.values()]
        for values in zip(*cols):
            yield dict(zip(names, values))

    def sample(self, n: int, seed: Optional[int] = None) -> Block:
        rng = np.random.default_rng(seed)
        rows = self.num_rows()
        n = min(n, rows)
        idx = rng.choice(rows, size=n, replace=False)
        return self.take_rows(idx)

    def sort(self, key: str, descending: bool = False) -> Block:
        """Stable in both orders: ties keep their order (Arrow's
        ``sort_indices``)."""
        col = self._b[key]
        if descending:
            # a stable ascending sort of the reversed column, reversed,
            # keeps ties in their original order
            rev = np.argsort(col[::-1], kind="stable")
            idx = (len(col) - 1 - rev)[::-1]
        else:
            idx = np.argsort(col, kind="stable")
        return self.take_rows(idx)

    @staticmethod
    def concat(blocks: List[Block]) -> Block:
        nonempty = [b for b in blocks if BlockAccessor(b).num_rows() > 0]
        if not nonempty:
            # preserve the columns of all-empty inputs (repartition edge
            # blocks)
            for b in blocks:
                if b:
                    return {k: v[:0] for k, v in b.items()}
            return {}
        if len(nonempty) == 1:
            return nonempty[0]
        names: List[str] = []
        for b in nonempty:
            names += [k for k in b if k not in names]
        out = {}
        for k in names:
            # a column some block lacks reads None there, as Arrow's
            # permissive concat gives nulls
            out[k] = _concat_columns([
                b[k] if k in b else _object_column(
                    [None] * BlockAccessor(b).num_rows())
                for b in nonempty])
        return out


def format_batch(block: Block, batch_format: Optional[str]):
    """Materialize a block slice in the format map_batches/iter_batches
    asked for: numpy only (reference: data/_internal/batcher + block
    accessor to_batch_format)."""
    if batch_format in ("numpy", "default", None):
        return BlockAccessor(block).to_numpy()
    if batch_format in ("pandas", "pyarrow", "arrow"):
        raise not_ported(f"batch_format={batch_format!r}")
    raise ValueError(f"unknown batch_format {batch_format!r}")


def batch_to_block(batch: Any) -> Block:
    return _to_block(batch)


batch_to_table = batch_to_block  # the JAX module's name
