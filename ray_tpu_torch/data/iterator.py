"""DataIterator: batched, prefetched consumption of a Dataset (the port's
counterpart of ``ray_tpu/data/iterator.py``).

Equivalent of the reference DataIterator (reference: python/ray/data/
iterator.py:103 iter_batches, :288 iter_torch_batches). On a CUDA device
``iter_torch_batches`` does what the JAX package's ``iter_jax_batches``
does for its chips: it stages each batch in pinned host memory and
issues its copy to the card ``prefetch`` batches ahead
(``non_blocking=True``), so the copy overlaps the step; a pinned buffer is
written again only after its copy has finished (one CUDA event a buffer).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, BlockAccessor, format_batch


class DataIterator:
    """Picklable batch iterator over a dataset's blocks. Created driver-side
    (materializes the shard's block refs) and shipped to train workers."""

    def __init__(self, dataset=None, bundles=None):
        if bundles is None:
            dataset.materialize()
            bundles = list(dataset._cached)
        # hold (ref, num_rows); refs are picklable so the iterator ships
        self._bundles = [(ref, meta.num_rows) for ref, meta in bundles]

    def __getstate__(self):
        return {"bundles": self._bundles}

    def __setstate__(self, state):
        self._bundles = state["bundles"]

    def count(self) -> int:
        return sum(n for _, n in self._bundles)

    # -- core batch loop ----------------------------------------------------

    def _iter_blocks(self, prefetch: int) -> Iterator[Block]:
        """Fetch blocks with a background prefetch thread."""
        refs = [r for r, _ in self._bundles]
        if not refs:
            return
        q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        stop = threading.Event()

        def offer(item) -> bool:
            # bounded put that aborts when the consumer abandoned the
            # iterator (early break from a training loop) — a plain q.put
            # would block this thread forever holding a fetched block
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def feeder():
            try:
                for r in refs:
                    if stop.is_set():
                        return
                    if not offer(("ok", ray_tpu_torch.get(r, timeout=600))):
                        return
                offer(("done", None))
            except BaseException as e:  # surfaced on the consumer side
                offer(("err", e))

        t = threading.Thread(target=feeder, daemon=True,
                             name="ray_tpu_torch-data-feeder")
        t.start()
        try:
            while True:
                kind, val = q.get()
                if kind == "done":
                    return
                if kind == "err":
                    raise val
                yield val
        finally:
            stop.set()

    def iter_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        batch_format: str = "numpy",
        drop_last: bool = False,
        local_shuffle_buffer_size: Optional[int] = None,
        local_shuffle_seed: Optional[int] = None,
        prefetch_batches: int = 1,
    ) -> Iterator[Any]:
        """Yield batches of exactly batch_size rows (coalescing across block
        boundaries). With local_shuffle_buffer_size, rows are drawn uniformly
        at random from a sliding buffer of at least that many rows, so rows DO
        cross batch boundaries (reference: iterator.py local shuffle buffer)."""
        format_batch({}, batch_format)  # refuse a format the port lacks now
        carry: Optional[Block] = None
        rng = (np.random.default_rng(local_shuffle_seed)
               if local_shuffle_buffer_size else None)

        def rows(b: Optional[Block]) -> int:
            return 0 if b is None else BlockAccessor(b).num_rows()

        def draw(block: Block, k: int):
            """Randomly sample k rows out of `block`; return (batch, rest)."""
            acc = BlockAccessor(block)
            idx = rng.permutation(acc.num_rows())
            return acc.take_rows(idx[:k]), acc.take_rows(np.sort(idx[k:]))

        def cut(block: Block, k: int):
            acc = BlockAccessor(block)
            return acc.slice(0, k), acc.slice(k, acc.num_rows())

        take = cut if rng is None else draw
        min_hold = (local_shuffle_buffer_size or 0)
        for b in self._iter_blocks(prefetch_batches):
            carry = b if carry is None else BlockAccessor.concat([carry, b])
            if batch_size is None:
                yield format_batch(carry, batch_format)
                carry = None
                continue
            while carry is not None and rows(carry) - min_hold >= batch_size:
                batch, carry = take(carry, batch_size)
                yield format_batch(batch, batch_format)
        if batch_size is None:
            return
        # drain the shuffle hold-back + remainder
        while carry is not None and rows(carry) >= batch_size:
            batch, carry = take(carry, batch_size)
            yield format_batch(batch, batch_format)
        if rows(carry) and not drop_last:
            if rng is not None:
                carry = BlockAccessor(carry).take_rows(
                    rng.permutation(rows(carry)))
            yield format_batch(carry, batch_format)

    def iter_rows(self) -> Iterator[dict]:
        for b in self._iter_blocks(1):
            yield from BlockAccessor(b).iter_rows()

    # -- framework sink -----------------------------------------------------

    def iter_torch_batches(self, *, dtypes=None, device=None,
                           prefetch: int = 2,
                           **kw) -> Iterator[Dict[str, Any]]:
        """Yield batches as dicts of torch tensors, cast to ``dtypes`` (one
        dtype, or a dict by column) on ``device``. On a CUDA device each batch
        is staged in pinned memory and copied with ``non_blocking=True``,
        ``prefetch`` batches ahead of the one yielded (reference:
        iterator.py:288; the JAX package's iter_jax_batches). A CUDA device
        with no card raises: nothing falls back to the CPU."""
        import torch

        dev = torch.device(device) if device is not None else None
        batches = self.iter_batches(batch_format="numpy", **kw)
        if dev is None or dev.type != "cuda":
            for batch in batches:
                out = {}
                for k, v in batch.items():
                    t = torch.as_tensor(v if v.flags.writeable else v.copy())
                    out[k] = _cast(t, k, dtypes)
                    if dev is not None:
                        out[k] = out[k].to(dev)
                yield out
            return
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"iter_torch_batches(device={device!r}) needs a CUDA device, "
                "and this process sees none; pass device='cpu' to read the "
                "batches on the host")
        yield from _PinnedFeed(torch, dev, max(0, prefetch)).feed(batches,
                                                                  dtypes)

    def materialize(self):
        from ray_tpu_torch.data.dataset import Dataset, _FromBundles
        from ray_tpu_torch.data.executor import BlockMeta

        bundles = [(r, BlockMeta(n, 0)) for r, n in self._bundles]
        ds = Dataset([_FromBundles(bundles)])
        return ds


def _cast(t, name: str, dtypes):
    """``t`` in ``dtypes`` (one dtype, or a dict by column: a column it
    does not name keeps its dtype)."""
    dtype = dtypes.get(name) if isinstance(dtypes, dict) else dtypes
    return t if dtype is None else t.to(dtype)


class _PinnedFeed:
    """Host batches to one card through ``prefetch + 1`` sets of pinned
    buffers, used in turn. A set's event is recorded after the copies out
    of it; the set is written again only after that event."""

    def __init__(self, torch, device, prefetch: int):
        self.torch = torch
        self.device = device
        self.prefetch = prefetch
        self.slots: List[dict] = [{} for _ in range(prefetch + 1)]
        self.events: List[Optional[Any]] = [None] * (prefetch + 1)

    def _stage(self, slot: int, name: str, v: np.ndarray):
        """``v`` in slot ``slot``'s pinned buffer for column ``name``."""
        torch = self.torch
        buf = self.slots[slot].get(name)
        want = torch.from_numpy(np.empty(0, dtype=v.dtype)).dtype
        if buf is None or buf.dtype != want or tuple(buf.shape) != v.shape:
            buf = torch.empty(v.shape, dtype=want, pin_memory=True)
            self.slots[slot][name] = buf
        np.copyto(buf.numpy(), v, casting="no")
        return buf

    def feed(self, batches, dtypes) -> Iterator[Dict[str, Any]]:
        torch = self.torch
        pending: List[dict] = []
        for i, batch in enumerate(batches):
            slot = i % len(self.slots)
            if self.events[slot] is not None:
                # the copies out of this set may still be running
                self.events[slot].synchronize()
            out = {}
            for k, v in batch.items():
                if v.dtype == object:
                    raise TypeError(f"column {k!r} holds Python objects; "
                                    "a tensor needs a numeric column")
                host = self._stage(slot, k, v)
                out[k] = _cast(host.to(self.device, non_blocking=True), k,
                               dtypes)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            self.events[slot] = event
            pending.append(out)
            if len(pending) > self.prefetch:
                yield pending.pop(0)
        yield from pending
