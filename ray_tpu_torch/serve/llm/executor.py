"""The device side of the engine (counterpart of
``ray_tpu/serve/llm/executor.py``'s ``SingleDeviceExecutor``).

The engine stages every input as numpy; the executor owns the weights
(the model of its family in ``decode.FAMILIES``, ``GPT`` or ``Llama``),
the paged pool tensors (``cache.k`` / ``cache.v``,
written in place by the model), the model steps (``decode.DecodeFns``:
one CUDA graph per decode signature on a card) and the one device-to-host
copy per step: the step's sampled ids, O(batch) int32, never logits.

Staging. A step's inputs (tokens, positions, tables; for a step that
samples, the controls and the keyed draws, computed here from the host's
seeds and positions) are packed into a pinned host buffer and copied to
the device in one ``non_blocking`` copy: for a decode step into its
graph's static input buffer, for a prefill into a fresh device buffer.
Two pinned buffers per (name, size) alternate: a buffer is written again
only two dispatches later, after the engine's lag-1 sync has proven that
the copy reading it executed. A decode step fed from the previous step's
ids (the steady state of the pipeline) copies them device to device into
its static tokens after that upload, so the feed never visits the host.

A verify step (speculative decoding) stages its [B, W] window, starts,
draft lengths and tables, the sampling controls tiled to [B, W] with a
keyed draw per column (positions starts + 1 + s) and, for a batch with a
grammar-constrained row, a [B, W, words] allow-mask, the same way: one
pinned buffer and one H2D into its signature's static buffer; a decode
or prefill step of such a batch adds the [B, words] mask.

The sync. Right after each step, a ``non_blocking`` copy of its [B] ids
into a pinned slot is queued and a CUDA event recorded behind it
(``StepIds``). ``sync_tokens`` waits on that event, never on the stream,
so syncing step N waits for step N only, not for step N+1 dispatched
after it. Decode slots alternate two per batch size, so step N's slot
survives the dispatch of N+1; prefill has its own pair (it syncs at once),
and so does a verify step, whose packed [B, W + 1] verdicts come back the
same way (``sync_verify``, at once).

Block moves. The prefix cache's copy-on-write (``copy_blocks``) runs on
the device; the host tier's demote capture and ``export_prefix``
(``export_blocks``) gather the blocks on the device into one byte buffer
and copy it to a pinned host buffer, then wait for that copy (a sync:
inside the lag-1 pipeline it also waits for the step in flight, and the
engine records it); promotions and adopted handoffs (``land_blocks``) go
up in one staged host-to-device copy. Block id lists pad to a power of
two with the garbage block 0, as in the JAX executor. Every write to the
pool is in place: the decode graphs captured its addresses.

Under ``model_cfg.quantization`` the executor quantizes the weights when
it is built (JAX ``_maybe_quantize_params``), from f32 values: a state
dict as given, or for random weights an f32 init from the seed, never the
bf16 serving copy (its rounding would change the scales). Weights that
arrive quantized (``convert.gpt_params_from_numpy`` of a quantized JAX
tree) are not quantized again.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ray_tpu_torch.ops import kv_cache as kv_ops
from ray_tpu_torch.ops.quantization import (
    QuantizedKV,
    QuantizedTensor,
    quantize_params,
)
from ray_tpu_torch.ops.sampling import greedy_rows, keyed_uniform
from ray_tpu_torch.serve.llm.decode import (
    DecodeFns,
    Layout,
    family,
    family_of,
    model_sample,
    sample_fields,
)
from ray_tpu_torch.serve.llm.kv_transfer import dtype_name, storage_dtype


@dataclass
class StepIds:
    """A dispatched step's [B] int32 ids: ``dev`` on the device (for a
    decode step on a card, its graph's static output, valid only until
    the next replay of any graph of the engine: they share one memory
    pool), and on a card the pinned ``host`` slot its copy lands in and
    the ``event`` recorded behind that copy."""

    dev: torch.Tensor
    host: torch.Tensor | None = None
    event: torch.cuda.Event | None = None


def _all_greedy(sample: dict) -> bool:
    return bool(greedy_rows(sample).all())  # on the host's arrays


def _pow2_ids(ids) -> np.ndarray:
    """``ids`` as int32, padded to a power of two with the garbage block 0."""
    out = np.zeros(1 << (len(ids) - 1).bit_length(), np.int32)
    out[:len(ids)] = ids
    return out


def _align(n: int) -> int:
    return -(-n // 16) * 16


def _wire_dtypes(pool_dtype) -> tuple:
    """The numpy dtypes of a payload's planes (``ops.kv_cache.
    block_planes``) for a pool of ``pool_dtype``: the data plane's bytes
    as the pool holds them, then the f32 scale plane."""
    return storage_dtype(dtype_name(pool_dtype)), np.dtype(np.float32)


def _payload_planes(payload, pool_dtype) -> list:
    """The numpy planes of one side's payload, data first: bytes as the
    pool holds them. A float payload of another dtype (an f32 record
    for a bf16 pool) is cast, as the JAX ``astype``."""
    out = []
    for i, (a, want) in enumerate(zip(kv_ops.block_planes(payload),
                                      _wire_dtypes(pool_dtype))):
        a = np.ascontiguousarray(a)
        if a.dtype != want and a.dtype.kind == "f" and i == 0:
            t = torch.from_numpy(a).to(pool_dtype)
            a = t.view(torch.uint8).numpy().view(want)
        if a.dtype.itemsize != want.itemsize:
            raise TypeError(f"payload of {a.dtype} for a pool of {pool_dtype}")
        out.append(a.view(want))
    return out


class SingleDeviceExecutor:
    """One device: unsharded weights and pool, for the model family whose
    config ``model_cfg`` is (``decode.FAMILIES``). ``params`` is a state
    dict (``convert.gpt_params_from_numpy`` / ``llama_params_from_numpy``);
    None draws seeded random weights on the device."""

    kind = "single"
    # set by the engine when speculation is on ({"speculative_k",
    # "drafter"}); reported by describe()
    speculative: dict | None = None

    def __init__(self, model_cfg, cache, *, params: dict | None = None,
                 seed: int = 0):
        self.family = family_of(model_cfg)
        fam = family(self.family)
        self.model_cfg = model_cfg
        self.quantization = model_cfg.quantization
        self.cache = cache
        self.device = cache.k.device
        if params is None and self.quantization is None:
            self.model = fam.init(model_cfg, seed, self.device)
        else:
            if params is None:
                f32 = dataclasses.replace(model_cfg, dtype=torch.float32,
                                          quantization=None)
                params = fam.init(f32, seed, self.device).weights()
            if self.quantization is not None:
                params = quantize_params(params, fam.quant_axes(model_cfg),
                                         self.quantization)
            self.model = fam.model(model_cfg, self.device).load_weights(params)
        self.fns = DecodeFns(self.model, cache)
        self._on_card = self.device.type == "cuda"
        # read once here: describe() runs on other threads (a Serve
        # replica's debug_dump) while the step thread may be capturing a
        # CUDA graph, so it touches no CUDA API
        self._device_name = (torch.cuda.get_device_name(self.device)
                             if self._on_card else str(self.device))
        # (name, size) -> [buffer 0, buffer 1, index of the last one used]
        self._staging: dict[tuple, list] = {}
        # (name, B) -> [(pinned ids, event) 0, ... 1, index of the last]
        self._slots: dict[tuple, list] = {}
        # the ids of the last decode step dispatched: the only ones a
        # decode step may be fed from on the device
        self._last_decode: StepIds | None = None
        # a landing's staging buffer (by address) -> the event recorded
        # behind the copy that reads it
        self._landed: dict[int, torch.cuda.Event] = {}

    # ---------------- description ----------------

    @property
    def on_new_signature(self):
        """The engine's compile-event hook, forwarded to ``DecodeFns``."""
        return self.fns.on_new_signature

    @on_new_signature.setter
    def on_new_signature(self, hook) -> None:
        self.fns.on_new_signature = hook

    @property
    def num_devices(self) -> int:
        return 1

    @property
    def num_params(self) -> int:
        """Elements of the served weights (a quantized weight counts its
        data, not its scales), from shapes alone: serving MFU's 2 *
        n_params FLOPs a token."""
        if getattr(self, "_num_params", None) is None:
            self._num_params = sum(
                w.data.numel() if isinstance(w, QuantizedTensor)
                else w.numel() for w in self.model.weights().values())
        return self._num_params

    @property
    def peak_tflops(self) -> float:
        """The MFU denominator: the card's dense bf16 peak
        (``benchmarks/gpt_mfu.card_peak_tflops``; 0.0 for a card the table
        does not know, which reports MFU 0), off the card the reference's
        nominal 0.5 TFLOP/s, so the ratio stays defined."""
        if getattr(self, "_peak_tflops", None) is None:
            from ray_tpu_torch.benchmarks.gpt_mfu import card_peak_tflops

            if self._on_card:
                self._peak_tflops = card_peak_tflops(self.device) or 0.0
            else:
                self._peak_tflops = 0.5
        return self._peak_tflops

    def describe(self) -> dict:
        """Which executor serves, on which device and attention backend,
        quantized how, speculating how, and its step graphs by kind (host
        state only: safe to call while a step is in flight)."""
        return {
            "executor": self.kind, "devices": self.num_devices, "mesh": None,
            "device": self._device_name,
            "attention_backend": self.model_cfg.attention_backend,
            "quantization": self.quantization,
            "speculative": self.speculative,
            "graphs": self.fns.graphs_by_kind(),
        }

    # ---------------- staging ----------------

    def _pinned(self, name: str, size: int,
                dtype: torch.dtype = torch.int32) -> torch.Tensor:
        """The next of two alternating host buffers for (name, size,
        dtype), pinned on a card."""
        key = (name, size, dtype)
        pair = self._staging.get(key)
        if pair is None:
            pair = self._staging[key] = [
                torch.zeros(size, dtype=dtype, pin_memory=self._on_card)
                for _ in range(2)
            ] + [1]
        pair[2] ^= 1
        return pair[pair[2]]

    def _upload(self, name: str, layout: Layout, values: dict,
                dst: torch.Tensor) -> None:
        """Pack ``values`` into a pinned buffer and copy it to the device
        buffer ``dst`` in one non-blocking copy."""
        host = self._pinned(name, layout.size)
        for field, view in layout.numpy_views(host.numpy()).items():
            view[...] = values[field]
        dst.copy_(host, non_blocking=True)

    def _sample_values(self, sample: dict, positions: np.ndarray) -> dict:
        """The staged sampling inputs of a step that samples: controls and
        the keyed draws of the tokens at ``positions``, made for the rows
        that sample (a greedy row's draw is never read; it stays 0).
        ``positions`` [B], or [B, W] for a verify window: each row's
        controls are then tiled across its W columns."""
        rows = ~greedy_rows(sample)
        shape = positions.shape
        out = {n: np.broadcast_to(
                   np.asarray(sample[n]).reshape(-1, *([1] * (len(shape) - 1))),
                   shape)
               for n in ("temperature", "top_k", "top_p")}
        uniform = np.zeros(shape, np.float32)
        if rows.any():
            at = positions[rows]
            seeds = np.broadcast_to(
                np.asarray(sample["seeds"])[rows].reshape(
                    -1, *([1] * (len(shape) - 1))), at.shape)
            uniform[rows] = keyed_uniform(seeds.reshape(-1),
                                          at.reshape(-1)).numpy().reshape(
                                              at.shape)
        out["uniform"] = uniform
        return out

    @staticmethod
    def _mask(sample) -> np.ndarray | None:
        """The grammar allow-mask of ``sample`` as int32 words (uint32 bit
        patterns), or None for an unconstrained step."""
        mask = None if sample is None else sample.get("mask")
        return None if mask is None else np.asarray(mask).view(np.int32)

    def _ids(self, name: str, dev: torch.Tensor) -> StepIds:
        """Queue the copy of a step's int32 output ([B] ids, or a verify
        step's [B, W + 1] verdicts) to the host behind the step."""
        if not self._on_card:
            return StepIds(dev)
        key = (name, tuple(dev.shape))
        pair = self._slots.get(key)
        if pair is None:
            pair = self._slots[key] = [
                (torch.empty(dev.shape, dtype=torch.int32,
                             pin_memory=True), torch.cuda.Event())
                for _ in range(2)
            ] + [1]
        pair[2] ^= 1
        host, event = pair[pair[2]]
        host.copy_(dev, non_blocking=True)
        event.record()
        return StepIds(dev, host, event)

    # ---------------- model steps ----------------

    def _prefill(self, tokens, lengths, starts, tables, sample):
        B, S = tokens.shape
        fields = [("tokens", (B, S), np.int32), ("lengths", (B,), np.int32),
                  ("tables", tables.shape, np.int32)]
        values = {"tokens": tokens, "lengths": lengths, "tables": tables}
        if starts is not None:
            fields.append(("starts", (B,), np.int32))
            values["starts"] = starts
        greedy = sample is None or _all_greedy(sample)
        if not greedy:
            fields += sample_fields(B)
            at = lengths if starts is None else starts + lengths
            values.update(self._sample_values(sample, at))
        mask = self._mask(sample)
        if mask is not None:
            fields.append(("mask", mask.shape, np.int32))
            values["mask"] = mask
        layout = Layout(fields)
        buf = torch.empty(layout.size, dtype=torch.int32, device=self.device)
        self._upload("prefill", layout, values, buf)
        dev = layout.views(buf)
        ids = self.fns.prefill(dev["tokens"], dev["lengths"], dev["tables"],
                               start=dev.get("starts"),
                               sample=model_sample(dev, not greedy,
                                                   mask is not None))
        return self._ids("prefill", ids)

    def prefill(self, tokens, lengths, tables, sample=None) -> StepIds:
        """Whole prompts from position 0; host arrays in, ids out."""
        return self._prefill(tokens, lengths, None, tables, sample)

    def prefill_chunk(self, tokens, lengths, starts, tables,
                      sample=None) -> StepIds:
        """The next chunk of each prompt at true positions ``starts``."""
        return self._prefill(tokens, lengths, starts, tables, sample)

    def stage_decode(self, tokens, positions, tables, sample=None):
        """Copy one decode step's inputs into its signature's static
        buffer (``decode.DecodeGraph``, made at first use) and return the
        graph, ready to ``run``. ``tokens`` is a [B] host array, or the
        ``StepIds`` of the decode step dispatched last (the steady feed:
        its ids never leave the device; any older step's ``dev`` may
        already be overwritten by a later replay, and is refused)."""
        fed = isinstance(tokens, StepIds)
        if fed and tokens is not self._last_decode:
            raise RuntimeError(
                "a decode step is fed on the device only from the decode "
                "step dispatched last")
        B, nb = tables.shape
        greedy = sample is None or _all_greedy(sample)
        mask = self._mask(sample)
        g = self.fns.decode_graph(B, nb, not greedy, mask is not None)
        values = {"positions": positions, "tables": tables, "mask": mask}
        values["tokens"] = 0 if fed else tokens
        if not greedy:
            values.update(self._sample_values(sample, positions + 1))
        self._upload("decode", g.layout, values, g.packed)
        if fed:
            g.inputs["tokens"].copy_(tokens.dev, non_blocking=True)
        return g

    def decode_step(self, tokens, positions, tables, sample=None) -> StepIds:
        """One decode step (see ``stage_decode``): the signature's graph
        replayed on a card, the eager step on the CPU."""
        g = self.stage_decode(tokens, positions, tables, sample)
        self._last_decode = self._ids("decode", g.run())
        return self._last_decode

    def stage_verify(self, tokens, starts, draft_len, tables, sample=None):
        """Copy one verify step's inputs (the [B, W] window, starts, draft
        lengths, tables; the sampling controls tiled to [B, W] with the
        keyed draws of positions starts + 1 + s; a [B, W, words] mask)
        into its signature's static buffer in one pinned upload, and
        return the graph, ready to ``run``."""
        B, W = tokens.shape
        nb = tables.shape[1]
        greedy = sample is None or _all_greedy(sample)
        mask = self._mask(sample)
        g = self.fns.verify_graph(B, nb, W, not greedy, mask is not None)
        values = {"tokens": tokens, "starts": starts, "draft_len": draft_len,
                  "tables": tables, "mask": mask}
        if not greedy:
            at = starts[:, None] + 1 + np.arange(W, dtype=starts.dtype)
            values.update(self._sample_values(sample, at))
        self._upload("verify", g.layout, values, g.packed)
        return g

    def verify_step(self, tokens, starts, draft_len, tables,
                    sample=None) -> StepIds:
        """One speculative verify step (see ``stage_verify``): the
        signature's graph replayed on a card, the eager step on the CPU;
        its packed [B, W + 1] verdicts come back through ``sync_verify``."""
        g = self.stage_verify(tokens, starts, draft_len, tables, sample)
        return self._ids("verify", g.run())

    # ---------------- block moves ----------------

    def _dev_ids(self, name: str, ids: np.ndarray) -> torch.Tensor:
        """Host int32 ids -> int64 on the device, one staged copy."""
        dev = torch.empty(ids.size, dtype=torch.int32, device=self.device)
        host = self._pinned(name, ids.size)
        host.numpy()[...] = ids.reshape(-1)
        dev.copy_(host, non_blocking=True)
        return dev.long()

    def copy_blocks(self, pairs: list[tuple[int, int]]) -> None:
        """Clone shared blocks on the device (copy-on-write) before a
        write lands, every layer, data and scale planes, in place. The
        (src, dst) list pads to a power of two with (0, 0)."""
        if not pairs:
            return
        src, dst = zip(*pairs)
        ids = self._dev_ids("copy", np.concatenate([_pow2_ids(src),
                                                    _pow2_ids(dst)]))
        half = ids.shape[0] // 2
        kv_ops.copy_blocks(self.cache.k, self.cache.v, ids[:half], ids[half:])

    def export_blocks(self, block_ids: list[int]):
        """Blocks ``block_ids`` on the host, (k, v) each [n_layer, P,
        block_size, n_kv_head, head_dim] numpy in the given order (bf16 as
        uint16, fp8 as uint8; a quantized pool's as ``QuantizedKV`` with
        its scale planes), at the model's head dim: the pool's padding
        columns are cut off. The gather pads to a power of two with block
        0 and goes to the host as one byte buffer; the call waits for it,
        so it also waits for every step queued before it."""
        hd = self.cache.cfg.head_dim
        n = len(block_ids)
        ids = self._dev_ids("export", _pow2_ids(block_ids) if n else
                            np.zeros(0, np.int32))
        parts, specs = [], []
        for side in (self.cache.k, self.cache.v):
            planes = zip(kv_ops.block_planes(side), _wire_dtypes(side.dtype))
            for i, (plane, np_dtype) in enumerate(planes):
                g = plane.index_select(1, ids)
                if i == 0:  # the data plane, cut to the model's head dim
                    g = g[..., :hd]
                flat = g.contiguous().view(-1).view(torch.uint8)
                specs.append((tuple(g.shape), np_dtype, flat.numel()))
                parts.append(flat)
                pad = _align(flat.numel()) - flat.numel()
                if pad:
                    parts.append(flat.new_zeros(pad))
        dev = torch.cat(parts)
        if self._on_card:
            host = torch.empty(dev.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(dev, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            event.synchronize()
        else:
            host = dev
        buf = host.numpy()
        planes, off = [], 0
        for shape, np_dtype, nbytes in specs:
            planes.append(buf[off:off + nbytes].view(np_dtype).reshape(shape)
                          [:, :n])
            off += _align(nbytes)
        out = []
        for side in (self.cache.k, self.cache.v):
            if isinstance(side, QuantizedKV):
                out.append(QuantizedKV(planes.pop(0), planes.pop(0)))
            else:
                out.append(planes.pop(0))
        return out[0], out[1]

    def land_blocks(self, block_ids: list[int], k_new, v_new) -> None:
        """Write host payloads ([n_layer, P, block_size, n_kv_head,
        head_dim] numpy as ``export_blocks`` returns them, or
        ``QuantizedKV`` with scale planes) into blocks ``block_ids`` of
        every layer, in place, zero-padding the head dim to the pool's.
        Ids pad to a power of two onto block 0 with zero rows; every
        plane goes up in ONE staged host-to-device copy."""
        if not block_ids:
            return
        ids = _pow2_ids(block_ids)
        width = ids.size
        planes = []
        for side, new in ((self.cache.k, k_new), (self.cache.v, v_new)):
            for a in _payload_planes(new, side.dtype):
                if a.shape[1] != width:
                    pad = [(0, 0)] * a.ndim
                    pad[1] = (0, width - a.shape[1])
                    a = np.pad(a, pad)
                planes.append(a)
        sizes = [_align(a.nbytes) for a in planes]
        nbytes = sum(sizes) + _align(4 * width)
        host = self._pinned("land", 1 << max(nbytes - 1, 1).bit_length(),
                            torch.uint8)
        # written again only after the copy that read it has executed
        event = self._landed.pop(host.data_ptr(), None)
        if event is not None:
            event.synchronize()
        buf = host.numpy()
        off = 0
        for a, size in zip(planes, sizes):
            buf[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
            off += size
        buf[off:off + 4 * width] = ids.view(np.uint8)
        if self._on_card:
            dev = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
            dev.copy_(host[:nbytes], non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            self._landed[host.data_ptr()] = event
        else:
            dev = host[:nbytes].clone()
        views, off = [], 0
        for side in (self.cache.k, self.cache.v):
            for plane in kv_ops.block_planes(side):
                a = planes[len(views)]
                views.append(dev[off:off + a.nbytes].view(plane.dtype)
                             .view(a.shape))
                off += sizes[len(views) - 1]
        dev_ids = dev[off:off + 4 * width].view(torch.int32).long()
        new = []
        for side in (self.cache.k, self.cache.v):
            if isinstance(side, QuantizedKV):
                new.append(QuantizedKV(views.pop(0), views.pop(0)))
            else:
                new.append(views.pop(0))
        kv_ops.land_blocks(self.cache.k, self.cache.v, dev_ids, *new)

    def sync_tokens(self, ids: StepIds) -> np.ndarray:
        """THE device->host sync of the emit path: a step's [B] int32 ids,
        waiting for that step's copy alone."""
        if ids.event is not None:
            ids.event.synchronize()
            toks = ids.host.numpy().copy()
        else:
            toks = ids.dev.numpy().copy()
        if toks.ndim != 1:
            raise RuntimeError(f"sync path must move [B] ids, got {toks.shape}")
        return toks

    def sync_verify(self, ids: StepIds) -> np.ndarray:
        """The same device->host sync for a verify step: its packed [B,
        W + 1] int32 verdicts (committed count, then the window's target
        tokens), never logits, one transfer a step."""
        if ids.event is not None:
            ids.event.synchronize()
            packed = ids.host.numpy().copy()
        else:
            packed = ids.dev.numpy().copy()
        if packed.ndim != 2 or packed.dtype != np.int32:
            raise RuntimeError(
                f"verify sync must move [B, W + 1] int32, got "
                f"{packed.dtype} {packed.shape}")
        return packed
