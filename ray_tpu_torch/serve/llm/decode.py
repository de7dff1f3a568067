"""The engine's model steps and their signature set (counterpart of
``ray_tpu/serve/llm/decode.py``'s ``DecodeFns``).

JAX compiles each step once per input-shape signature (``jax.jit``), so a
decode step costs the host one dispatch. The port's counterpart on a card
is one captured ``torch.cuda.CUDAGraph`` per decode signature

    ("decode", B bucket, table width, whether any row samples)

The last field is part of the key because a graph cannot branch on the
host's all-greedy test (``ops/sampling.sample_tokens``): a greedy graph
ends in the argmax, a sampled one in the sort. A signature is captured at
its first use, as ``jax.jit`` compiles at first use: one warm-up run of
the step on a side stream (PyTorch's rule before a capture; it builds the
kernels and runs the step for real, and the replay that follows writes
the same K/V again), then the capture, into one memory pool that every
graph of the engine shares (``torch.cuda.graph_pool_handle()``). A failed
capture or replay raises; nothing falls back to the eager step on a card.

A graph reads its inputs from one static int32 device buffer per
signature (``Layout``: tokens, positions, tables and, for a sampled
signature, the sampling controls and the keyed draws, f32 fields stored
bitwise), written by the executor before each replay, and writes the
step's [B] int32 ids to its static output. The shared pool bounds how
long that output holds: another graph's capture may have placed its
temporaries in the same memory, so the next replay of any graph of the
engine may overwrite it. The executor reads it (its copy to the host and
its device-to-device feed of the next step) only on the stream, before
the next replay is queued.

Prefill stays eager: it runs the model at once, as the reference's
prefill syncs at lag 0, and its signatures ("prefill" or
"prefill_chunk", tokens shape, tables shape) join the same set. On the
CPU the same objects run every step eagerly.

The kernel wrappers count the launches they make themselves, not those
recorded into a graph under capture; a replay launches the graph's
kernels without calling a wrapper, and a profiler trace of the device
counts them (``benchmarks/engine_profile.paged_launches``).
"""
from __future__ import annotations

import time

import numpy as np
import torch


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


def sample_fields(B: int) -> list:
    """The sampling inputs of a step that samples: the controls and the
    keyed draws, [B] each."""
    return [(n, (B,), _SAMPLE_DTYPES[n]) for n in SAMPLE_FIELDS]


def decode_layout(B: int, nb: int, sampled: bool) -> Layout:
    fields = [("tokens", (B,), np.int32), ("positions", (B,), np.int32),
              ("tables", (B, nb), np.int32)]
    return Layout(fields + (sample_fields(B) if sampled else []))


def model_sample(inputs: dict, sampled: bool) -> dict:
    """The ``sample`` argument of a model step from its staged inputs."""
    if not sampled:
        return {"all_greedy": True}
    out = {n: inputs[n] for n in SAMPLE_FIELDS}
    out["all_greedy"] = False
    return out


class DecodeGraph:
    """One decode signature: its static input buffer ``packed`` (and its
    ``inputs`` views) and, on a card, the step captured as a graph."""

    def __init__(self, fns: "DecodeFns", sig: tuple, layout: Layout):
        self.fns = fns
        self.sig = sig
        self.sampled = sig[3]
        self.layout = layout
        self.packed = torch.zeros(layout.size, dtype=torch.int32,
                                  device=fns.device)
        self.inputs = layout.views(self.packed)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out: torch.Tensor | None = None

    def run(self) -> torch.Tensor:
        """The step's [B] int32 ids: on a card the graph's static output
        (captured at the first call; valid until the next replay of any
        graph of the engine), on the CPU a fresh tensor."""
        if self.fns.device.type != "cuda":
            return self.fns.step(self.inputs, self.sampled)
        if self.graph is None:
            self._capture()
        self.graph.replay()
        self.fns.replays += 1
        return self.out

    def _capture(self) -> None:
        fns = self.fns
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(fns.device)
        side = torch.cuda.Stream(fns.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            fns.step(self.inputs, self.sampled)  # warm-up, launches for real
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=fns.pool):
            out = fns.step(self.inputs, self.sampled)
        self.graph, self.out = graph, out
        fns.capture_seconds += time.perf_counter() - t0


class DecodeFns:
    """The model steps of one engine and the signatures they ran at: the
    prefill calls run eagerly, each decode signature as a ``DecodeGraph``
    (a captured CUDA graph on a card, the eager step on the CPU). The
    pool tensors are written in place by every step."""

    def __init__(self, model, cache):
        self.model = model
        self.cache = cache
        self.device = cache.k.device
        self._signatures: set[tuple] = set()
        self._graphs: dict[tuple, DecodeGraph] = {}
        self.pool = (torch.cuda.graph_pool_handle()
                     if self.device.type == "cuda" else None)
        self.capture_seconds = 0.0
        self.replays = 0

    def _note(self, sig: tuple) -> None:
        self._signatures.add(sig)

    @property
    def num_compiled_shapes(self) -> int:
        """Distinct (kind, shape) signatures seen: each decode one is one
        captured graph on a card."""
        return len(self._signatures)

    @property
    def signatures(self) -> frozenset:
        return frozenset(self._signatures)

    @property
    def graphs_captured(self) -> int:
        return sum(g.graph is not None for g in self._graphs.values())

    def _same_pool(self, k, v) -> None:
        if k is not self.cache.k or v is not self.cache.v:
            raise RuntimeError("a model step must write the pool in place")

    def prefill(self, tokens, lengths, tables, start=None, sample=None):
        kind = "prefill" if start is None else "prefill_chunk"
        self._note((kind, tuple(tokens.shape), tuple(tables.shape)))
        out, k, v = self.model.prefill(
            self.cache.k, self.cache.v, tokens, lengths, tables, start=start,
            sample=sample)
        self._same_pool(k, v)
        return out

    def decode_graph(self, B: int, nb: int, sampled: bool) -> DecodeGraph:
        """The decode signature (B, nb, sampled), made at its first use."""
        sig = ("decode", B, nb, bool(sampled))
        g = self._graphs.get(sig)
        if g is None:
            g = self._graphs[sig] = DecodeGraph(
                self, sig, decode_layout(B, nb, sampled))
            self._note(sig)
        return g

    def step(self, inputs: dict, sampled: bool) -> torch.Tensor:
        """One decode step of the model on staged inputs -> [B] int32 ids:
        no host reads, no allocation that depends on data, kernels on the
        current stream (what a capture needs)."""
        ids, k, v = self.model.decode_step(
            self.cache.k, self.cache.v, inputs["tokens"],
            inputs["positions"], inputs["tables"],
            sample=model_sample(inputs, sampled))
        self._same_pool(k, v)
        return ids
