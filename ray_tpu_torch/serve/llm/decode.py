"""The engine's model steps and their signature set (counterpart of
``ray_tpu/serve/llm/decode.py``'s ``DecodeFns``).

JAX compiles each step once per input-shape signature (``jax.jit``), so a
decode step costs the host one dispatch. The port's counterpart on a card
is one captured ``torch.cuda.CUDAGraph`` per decode or verify signature

    ("decode", B bucket, table width, whether any row samples,
     whether any row is grammar-constrained)
    ("verify", B bucket, table width, W, sampled, masked)

The sampled field is part of the key because a graph cannot branch on
the host's all-greedy test (``ops/sampling.sample_tokens``): a greedy
graph ends in the argmax, a sampled one in the sort. The masked field
adds the grammar allow-mask to the inputs only for batches that hold a
constrained row: the reference stages an all-ones mask for every batch,
and ``apply_allow_mask`` is the identity on all-ones rows, so the
unconstrained signatures keep their bytes and give the same tokens. A
verify step (speculative decoding, ``speculative_k`` > 0) scores a
[B, W = speculative_k + 1] window through the family's ``verify_step``,
the reference's one compile kind "verify" times the buckets: one graph
each, as ``jax.jit`` gives the reference. A signature is captured at
its first use, as ``jax.jit`` compiles at first use: one warm-up run of
the step on a side stream (PyTorch's rule before a capture; it builds the
kernels and runs the step for real, and the replay that follows writes
the same K/V again), then the capture, into one memory pool that every
graph of the engine shares (``torch.cuda.graph_pool_handle()``). A failed
capture or replay raises; nothing falls back to the eager step on a card.

A graph reads its inputs from one static int32 device buffer per
signature (``Layout``: tokens, positions, tables and, for a sampled
signature, the sampling controls and the keyed draws, f32 fields stored
bitwise; a verify signature's window, starts, draft lengths and its
sampling inputs tiled to [B, W]), written by the executor before each
replay, and writes the step's [B] int32 ids (a verify step's packed
[B, W + 1] verdicts) to its static output. The shared pool bounds how
long that output holds: another graph's capture may have placed its
temporaries in the same memory, so the next replay of any graph of the
engine may overwrite it. The executor reads it (its copy to the host and
its device-to-device feed of the next step) only on the stream, before
the next replay is queued.

Prefill stays eager: it runs the model at once, as the reference's
prefill syncs at lag 0, and its signatures ("prefill" or
"prefill_chunk", tokens shape, tables shape) join the same set. On the
CPU the same objects run every step eagerly.

Each signature also has the reference's shape (kind, tokens shape, tables
shape): ("decode", (B,), (B, nb)) and ("verify", (B, W), (B, nb)) for the
graphs. ``on_new_signature`` (the engine's compile-event hook, as in the
reference) is called with that shape the first time it is seen, so the
engine's ``llm_compile_events`` counts what the reference's does; the
graphs captured per sampled and masked variant are counted by
``graphs_by_kind``.

``FAMILIES`` is the registry of model families the engine serves
(``ray_tpu/serve/llm/decode.py`` ``FAMILIES``), kept in
``models/families.py`` so that training imports it without this module
and re-exported here: each names its config and model classes, its
seeded init, its quantization axes, its full width and its verify step.
The model steps themselves are generic: every family's model has the
same ``prefill`` / ``decode_step`` / ``verify_step`` contract.

The kernel wrappers count the launches they make themselves, not those
recorded into a graph under capture; a replay launches the graph's
kernels without calling a wrapper, and a profiler trace of the device
counts them (``benchmarks/engine_profile.paged_launches``).
"""
from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.models.families import (  # noqa: F401  (re-exported)
    FAMILIES,
    Family,
    family,
    family_of,
)


class Layout:
    """Named int32 / f32 fields packed into one int32 buffer, so a step's
    inputs move in one copy. ``fields``: (name, shape, dtype) in order."""

    def __init__(self, fields):
        self.fields = []
        offset = 0
        for name, shape, dtype in fields:
            if dtype not in (np.int32, np.float32):
                raise TypeError(f"{name}: only int32 and float32 pack")
            n = int(np.prod(shape))
            self.fields.append((name, tuple(shape), dtype, offset, n))
            offset += n
        self.size = offset

    def numpy_views(self, buf: np.ndarray) -> dict:
        """Writable views of an int32 numpy buffer, by field."""
        return {name: buf[o:o + n].view(dtype).reshape(shape)
                for name, shape, dtype, o, n in self.fields}

    def views(self, buf: torch.Tensor) -> dict:
        """Views of an int32 tensor, by field (f32 fields bitwise)."""
        out = {}
        for name, shape, dtype, o, n in self.fields:
            t = buf[o:o + n]
            if dtype == np.float32:
                t = t.view(torch.float32)
            out[name] = t.view(shape)
        return out


SAMPLE_FIELDS = ("temperature", "top_k", "top_p", "uniform")
_SAMPLE_DTYPES = {"temperature": np.float32, "top_k": np.int32,
                  "top_p": np.float32, "uniform": np.float32}


def mask_words(vocab_size: int) -> int:
    """32-bit words of one packed allow-mask row over ``vocab_size``."""
    return (vocab_size + 31) // 32


def sample_fields(B: int, W: int | None = None) -> list:
    """The sampling inputs of a step that samples: the controls and the
    keyed draws, [B] each, or [B, W] for a verify window (each row's
    controls tiled across its columns, a draw per column)."""
    shape = (B,) if W is None else (B, W)
    return [(n, shape, _SAMPLE_DTYPES[n]) for n in SAMPLE_FIELDS]


def decode_layout(B: int, nb: int, sampled: bool, masked: bool,
                  words: int) -> Layout:
    """A decode step's inputs; ``masked`` adds the [B, words] grammar
    allow-mask (uint32 words stored as int32)."""
    fields = [("tokens", (B,), np.int32), ("positions", (B,), np.int32),
              ("tables", (B, nb), np.int32)]
    fields += sample_fields(B) if sampled else []
    if masked:
        fields.append(("mask", (B, words), np.int32))
    return Layout(fields)


def verify_layout(B: int, nb: int, W: int, sampled: bool, masked: bool,
                  words: int) -> Layout:
    """A verify step's inputs: the [B, W] window, each row's start and
    draft length, the tables, the sampling inputs tiled to [B, W] and,
    when ``masked``, one allow-mask per column, [B, W, words]."""
    fields = [("tokens", (B, W), np.int32), ("starts", (B,), np.int32),
              ("draft_len", (B,), np.int32), ("tables", (B, nb), np.int32)]
    fields += sample_fields(B, W) if sampled else []
    if masked:
        fields.append(("mask", (B, W, words), np.int32))
    return Layout(fields)


def model_sample(inputs: dict, sampled: bool, masked: bool = False) -> dict:
    """The ``sample`` argument of a model step from its staged inputs."""
    out = {"all_greedy": not sampled}
    if sampled:
        out.update((n, inputs[n]) for n in SAMPLE_FIELDS)
    if masked:
        out["mask"] = inputs["mask"]
    return out


class DecodeGraph:
    """One step signature, decode or verify: its static input buffer
    ``packed`` (and its ``inputs`` views) and, on a card, the step
    captured as a graph."""

    def __init__(self, fns: "DecodeFns", sig: tuple, layout: Layout):
        self.fns = fns
        self.sig = sig
        self.kind = sig[0]
        self.sampled, self.masked = sig[-2], sig[-1]
        self.layout = layout
        self.packed = torch.zeros(layout.size, dtype=torch.int32,
                                  device=fns.device)
        self.inputs = layout.views(self.packed)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out: torch.Tensor | None = None

    def _step(self) -> torch.Tensor:
        if self.kind == "verify":
            return self.fns.verify(self.inputs, self.sampled, self.masked)
        return self.fns.step(self.inputs, self.sampled, self.masked)

    def run(self) -> torch.Tensor:
        """The step's int32 output ([B] ids, or [B, W + 1] packed
        verdicts): on a card the graph's static output (captured at the
        first call; valid until the next replay of any graph of the
        engine), on the CPU a fresh tensor."""
        if self.fns.device.type != "cuda":
            return self._step()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        self.fns.kind_replays[self.kind] += 1
        return self.out

    def _capture(self) -> None:
        from ray_tpu_torch.serve.llm import obs

        fns = self.fns
        t0 = obs.clock()
        main = torch.cuda.current_stream(fns.device)
        side = torch.cuda.Stream(fns.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._step()  # warm-up, launches for real
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=fns.pool):
            out = self._step()
        self.graph, self.out = graph, out
        fns.capture_seconds += obs.clock() - t0


class DecodeFns:
    """The model steps of one engine and the signatures they ran at: the
    prefill calls run eagerly, each decode and verify signature as a
    ``DecodeGraph`` (a captured CUDA graph on a card, the eager step on
    the CPU). The pool tensors are written in place by every step."""

    def __init__(self, model, cache):
        self.model = model
        self.cache = cache
        self.device = cache.k.device
        self.words = mask_words(model.cfg.vocab_size)
        self._verify = family(family_of(model.cfg)).verify_step
        self._signatures: set[tuple] = set()
        # the signatures in the reference's shape (kind, tokens shape,
        # tables shape); on_new_signature(shape) at each first sight
        self._shapes: set[tuple] = set()
        self.on_new_signature = None
        self._graphs: dict[tuple, DecodeGraph] = {}
        self.pool = (torch.cuda.graph_pool_handle()
                     if self.device.type == "cuda" else None)
        self.capture_seconds = 0.0
        self.kind_replays = {"decode": 0, "verify": 0}  # graph replays

    def _note(self, sig: tuple, shape: tuple) -> None:
        self._signatures.add(sig)
        if shape not in self._shapes:
            self._shapes.add(shape)
            if self.on_new_signature is not None:
                self.on_new_signature(shape)

    @property
    def num_compiled_shapes(self) -> int:
        """Distinct (kind, shape) signatures seen: each decode and verify
        one is one captured graph on a card."""
        return len(self._signatures)

    @property
    def signatures(self) -> frozenset:
        return frozenset(self._signatures)

    @property
    def shapes(self) -> frozenset:
        """The signatures in the reference's shape (``obs.shape_key``)."""
        return frozenset(self._shapes)

    @property
    def replays(self) -> int:
        """Graph replays of every kind."""
        return sum(self.kind_replays.values())

    @property
    def graphs_captured(self) -> int:
        return sum(g.graph is not None for g in self._graphs.values())

    def graphs_by_kind(self) -> dict:
        """Captured graphs by step kind ("decode", "verify")."""
        out = {"decode": 0, "verify": 0}
        for g in self._graphs.values():
            out[g.kind] += g.graph is not None
        return out

    def _same_pool(self, k, v) -> None:
        if k is not self.cache.k or v is not self.cache.v:
            raise RuntimeError("a model step must write the pool in place")

    def prefill(self, tokens, lengths, tables, start=None, sample=None):
        kind = "prefill" if start is None else "prefill_chunk"
        sig = (kind, tuple(tokens.shape), tuple(tables.shape))
        self._note(sig, sig)
        out, k, v = self.model.prefill(
            self.cache.k, self.cache.v, tokens, lengths, tables, start=start,
            sample=sample)
        self._same_pool(k, v)
        return out

    def _graph(self, sig: tuple, shape: tuple, layout) -> DecodeGraph:
        g = self._graphs.get(sig)
        if g is None:
            g = self._graphs[sig] = DecodeGraph(self, sig, layout())
            self._note(sig, shape)
        return g

    def decode_graph(self, B: int, nb: int, sampled: bool,
                     masked: bool = False) -> DecodeGraph:
        """The decode signature (B, nb, sampled, masked), made at its
        first use."""
        sig = ("decode", B, nb, bool(sampled), bool(masked))
        return self._graph(sig, ("decode", (B,), (B, nb)),
                           lambda: decode_layout(B, nb, sampled, masked,
                                                 self.words))

    def verify_graph(self, B: int, nb: int, W: int, sampled: bool,
                     masked: bool) -> DecodeGraph:
        """The verify signature (B, nb, W, sampled, masked), made at its
        first use. W = speculative_k + 1 is fixed per engine: whether a
        row drafted is data (its draft length), not shape."""
        sig = ("verify", B, nb, W, bool(sampled), bool(masked))
        return self._graph(sig, ("verify", (B, W), (B, nb)),
                           lambda: verify_layout(B, nb, W, sampled, masked,
                                                 self.words))

    def step(self, inputs: dict, sampled: bool,
             masked: bool = False) -> torch.Tensor:
        """One decode step of the model on staged inputs -> [B] int32 ids:
        no host reads, no allocation that depends on data, kernels on the
        current stream (what a capture needs)."""
        ids, k, v = self.model.decode_step(
            self.cache.k, self.cache.v, inputs["tokens"],
            inputs["positions"], inputs["tables"],
            sample=model_sample(inputs, sampled, masked))
        self._same_pool(k, v)
        return ids

    def verify(self, inputs: dict, sampled: bool, masked: bool,
               logits: bool = False) -> torch.Tensor:
        """One verify step of the model on staged inputs -> packed [B,
        W + 1] int32 verdicts (``ops/sampling.verify_tokens``), or with
        ``logits`` the window's [B, W, V] f32 logits; capturable like
        ``step``."""
        out, k, v = self._verify(
            self.model, self.cache.k, self.cache.v, inputs["tokens"],
            inputs["starts"], inputs["draft_len"], inputs["tables"],
            sample=None if logits else model_sample(inputs, sampled, masked))
        self._same_pool(k, v)
        return out
