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

The sync. Right after each step, a ``non_blocking`` copy of its [B] ids
into a pinned slot is queued and a CUDA event recorded behind it
(``StepIds``). ``sync_tokens`` waits on that event, never on the stream,
so syncing step N waits for step N only, not for step N+1 dispatched
after it. Decode slots alternate two per batch size, so step N's slot
survives the dispatch of N+1; prefill has its own pair (it syncs at once).

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

from ray_tpu_torch.ops.quantization import quantize_params
from ray_tpu_torch.ops.sampling import greedy_rows, keyed_uniform
from ray_tpu_torch.serve.llm.decode import (
    DecodeFns,
    Layout,
    family,
    family_of,
    model_sample,
    sample_fields,
)


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


class SingleDeviceExecutor:
    """One device: unsharded weights and pool, for the model family whose
    config ``model_cfg`` is (``decode.FAMILIES``). ``params`` is a state
    dict (``convert.gpt_params_from_numpy`` / ``llama_params_from_numpy``);
    None draws seeded random weights on the device."""

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
        # (name, size) -> [buffer 0, buffer 1, index of the last one used]
        self._staging: dict[tuple, list] = {}
        # (name, B) -> [(pinned ids, event) 0, ... 1, index of the last]
        self._slots: dict[tuple, list] = {}
        # the ids of the last decode step dispatched: the only ones a
        # decode step may be fed from on the device
        self._last_decode: StepIds | None = None

    # ---------------- staging ----------------

    def _pinned(self, name: str, size: int) -> torch.Tensor:
        """The next of two alternating int32 host buffers for (name, size),
        pinned on a card."""
        key = (name, size)
        pair = self._staging.get(key)
        if pair is None:
            pair = self._staging[key] = [
                torch.zeros(size, dtype=torch.int32,
                            pin_memory=self._on_card) for _ in range(2)
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
        that sample (a greedy row's draw is never read; it stays 0)."""
        out = {n: sample[n] for n in ("temperature", "top_k", "top_p")}
        rows = ~greedy_rows(sample)
        out["uniform"] = np.zeros(len(positions), np.float32)
        out["uniform"][rows] = keyed_uniform(sample["seeds"][rows],
                                             positions[rows]).numpy()
        return out

    def _ids(self, name: str, dev: torch.Tensor) -> StepIds:
        """Queue the copy of a step's ids to the host behind the step."""
        if not self._on_card:
            return StepIds(dev)
        key = (name, dev.shape[0])
        pair = self._slots.get(key)
        if pair is None:
            pair = self._slots[key] = [
                (torch.empty(dev.shape[0], dtype=torch.int32,
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
        layout = Layout(fields)
        buf = torch.empty(layout.size, dtype=torch.int32, device=self.device)
        self._upload("prefill", layout, values, buf)
        dev = layout.views(buf)
        ids = self.fns.prefill(dev["tokens"], dev["lengths"], dev["tables"],
                               start=dev.get("starts"),
                               sample=model_sample(dev, not greedy))
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
        g = self.fns.decode_graph(B, nb, not greedy)
        values = {"positions": positions, "tables": tables}
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
