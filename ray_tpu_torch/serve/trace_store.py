"""Fleet trace store — central span collection with tail-based sampling
(the port's copy of ``ray_tpu/serve/trace_store.py``).

The controller drains every replica/proxy process's bounded span buffer
(``tracing.drain_buffered_spans`` piggybacked on the ``metrics_report``
poll) into one ``TraceStore`` per controller: a bounded, ring-style map
of trace id -> span list, assembled on demand into per-trace trees that
cross process boundaries (proxy -> router -> prefill replica -> decode
replica). Like the ``FleetAggregator`` history rings it is deliberately
NOT checkpointed — traces are a debugging aid, not serving state, and a
recovered controller starts collecting again from live traffic.

Retention is TAIL-based: a trace's fate is decided by what happened to
it, not at ingest. The store always keeps traces that hit an error /
deadline expiry / admission shed / preemption / mid-stream failover /
handoff retry, plus a reservoir of the slowest-TTFT traces; the
remaining (boring) traces survive eviction only if a deterministic
per-trace-id sample selects them. Eviction only triggers past
``max_traces`` and removes the least interesting, oldest traces first.
"""
from __future__ import annotations

import zlib

__all__ = ["TraceStore", "RETENTION_FLAGS"]

# every tail-retention trigger the classifier can raise; docs list these
RETENTION_FLAGS = (
    "error", "deadline", "shed", "preempted", "failover", "handoff-retry",
)

# terminal engine finish_reasons mapped to retention flags
_ERROR_REASONS = frozenset({"failed", "cancelled", "shutdown"})


def sample_decision(trace_id: str, rate: float) -> bool:
    """Deterministic head/tail sampling decision for one trace id: the
    same id always lands on the same side of the rate, so every process
    (and every test) agrees without coordination. No RNG state — the
    decision is a pure hash of the id."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return (zlib.crc32(trace_id.encode()) % 10_000) < rate * 10_000


class _Trace:
    __slots__ = ("trace_id", "spans", "flags", "first_stamp", "last_stamp",
                 "ttft_s", "app", "engine_requests", "span_ids")

    def __init__(self, trace_id: str, stamp: float):
        self.trace_id = trace_id
        self.spans: list[dict] = []
        self.flags: set[str] = set()
        self.first_stamp = stamp
        self.last_stamp = stamp
        self.ttft_s: float | None = None
        self.app: str | None = None
        self.engine_requests = 0
        self.span_ids: set[str] = set()

    @property
    def start(self) -> float:
        return min(s["start"] for s in self.spans)

    @property
    def end(self) -> float:
        return max(s["end"] for s in self.spans)


class TraceStore:
    """Bounded per-controller trace collection (see module docstring).

    ``max_traces`` bounds the trace count and ``max_spans_per_trace``
    bounds any one trace (a runaway stream must not eat the store);
    ``sample_rate`` is the keep-probability for traces no retention
    trigger fired on; ``ttft_reservoir`` is how many slowest-TTFT traces
    ride out eviction regardless of sampling."""

    def __init__(self, *, max_traces: int = 512,
                 max_spans_per_trace: int = 512,
                 sample_rate: float = 0.1,
                 ttft_reservoir: int = 32):
        self.max_traces = int(max_traces)
        self.max_spans_per_trace = int(max_spans_per_trace)
        self.sample_rate = float(sample_rate)
        self.ttft_reservoir = int(ttft_reservoir)
        self._traces: dict[str, _Trace] = {}
        self.ingested_spans = 0
        self.dropped_spans = 0       # per-trace span-cap overflow
        self.evicted_traces = 0
        self.retained_traces = 0     # evictions AVOIDED by a flag/reservoir

    # ---------------- ingest ----------------

    def ingest(self, spans: list[dict], *, source: str,
               stamp: float) -> int:
        """Fold one process's drained span buffer in. ``source`` labels
        each span with the process it came from (``replica:<id>`` /
        ``proxy:<id>`` / ``controller``); ``stamp`` is the controller's
        clock at ingest (eviction ordering — span start/end stay wall
        times from the emitting process)."""
        n = 0
        for s in spans:
            tid = s.get("trace_id")
            sid = s.get("span_id")
            if not tid or not sid:
                continue  # not a span shape we understand: skip, count
            t = self._traces.get(tid)
            if t is None:
                t = self._traces[tid] = _Trace(tid, stamp)
            if sid in t.span_ids:
                continue  # re-delivered (poll retry) — exactly-once
            if len(t.spans) >= self.max_spans_per_trace:
                self.dropped_spans += 1
                continue
            rec = dict(s)
            rec["source"] = source
            t.spans.append(rec)
            t.span_ids.add(sid)
            t.last_stamp = stamp
            self._classify(t, rec)
            n += 1
        self.ingested_spans += n
        if len(self._traces) > self.max_traces:
            self._evict()
        return n

    def _classify(self, t: _Trace, span: dict) -> None:
        """Raise retention flags from one span — the tail-sampling
        triggers. Called per ingested span so a trace's fate is always
        current when eviction runs."""
        name = span.get("name") or ""
        attrs = span.get("attrs") or {}
        if name == "engine.request":
            t.engine_requests += 1
            if t.engine_requests >= 2:
                # two engine.request spans under one trace = the stream
                # was re-dispatched to a second replica mid-flight
                t.flags.add("failover")
            reason = attrs.get("finish_reason")
            if reason == "expired":
                t.flags.add("deadline")
            elif reason in _ERROR_REASONS:
                t.flags.add("error")
            if attrs.get("preempt_count"):
                t.flags.add("preempted")
            ttft = attrs.get("ttft_s")
            if ttft is not None:
                # a resumed stream's second engine.request has no first
                # token of its own — keep the first observed TTFT
                if t.ttft_s is None:
                    t.ttft_s = float(ttft)
        elif name == "engine.preempted":
            t.flags.add("preempted")
        elif name == "handle.resume":
            t.flags.add("failover")
        elif name == "handle.shed":
            t.flags.add("shed")
        elif name.startswith("handoff."):
            if attrs.get("attempt"):
                t.flags.add("handoff-retry")
        elif name in ("handle.dispatch", "http.request", "grpc.call",
                      "grpc.stream"):
            dep = attrs.get("deployment") or attrs.get("app")
            if dep and t.app is None:
                t.app = str(dep).split("/", 1)[0]

    # ---------------- eviction (tail sampling) ----------------

    def _keep_rank(self, t: _Trace, reservoir: set[str]) -> int:
        """2 = always keep (flagged, or slowest-TTFT reservoir member),
        1 = kept by the deterministic sample, 0 = evict first."""
        if t.flags or t.trace_id in reservoir:
            return 2
        if sample_decision(t.trace_id, self.sample_rate):
            return 1
        return 0

    def _ttft_reservoir_ids(self) -> set[str]:
        with_ttft = [t for t in self._traces.values() if t.ttft_s is not None]
        with_ttft.sort(key=lambda t: -t.ttft_s)
        return {t.trace_id for t in with_ttft[: self.ttft_reservoir]}

    def _evict(self) -> None:
        reservoir = self._ttft_reservoir_ids()
        order = sorted(
            self._traces.values(),
            key=lambda t: (self._keep_rank(t, reservoir), t.first_stamp),
        )
        excess = len(self._traces) - self.max_traces
        for t in order[:excess]:
            if self._keep_rank(t, reservoir) == 2:
                # the store is full of must-keep traces: count the
                # retention we honored, then age out the oldest anyway
                # (bounded beats complete)
                self.retained_traces += 1
            del self._traces[t.trace_id]
            self.evicted_traces += 1

    # ---------------- query ----------------

    def __len__(self) -> int:
        return len(self._traces)

    def __contains__(self, trace_id: str) -> bool:
        return trace_id in self._traces

    def status_of(self, t: _Trace, reservoir: set[str] | None = None) -> list:
        out = sorted(t.flags)
        if not out:
            if reservoir is None:
                reservoir = self._ttft_reservoir_ids()
            out = ["slow" if t.trace_id in reservoir else "sampled"]
        return out

    def _summary(self, t: _Trace, reservoir: set[str]) -> dict:
        start, end = t.start, t.end
        return {
            "trace_id": t.trace_id,
            "app": t.app,
            "status": self.status_of(t, reservoir),
            "spans": len(t.spans),
            "start": start,
            "duration_s": round(end - start, 6),
            "ttft_s": t.ttft_s,
        }

    def list_traces(self, *, app: str | None = None,
                    status: str | None = None,
                    min_duration_s: float | None = None,
                    limit: int = 100) -> list[dict]:
        """Trace summaries, newest first, filtered by app / retention
        status / minimum duration — the ``/api/traces`` payload."""
        reservoir = self._ttft_reservoir_ids()
        rows = []
        for t in sorted(self._traces.values(),
                        key=lambda t: -t.last_stamp):
            if not t.spans:
                continue
            row = self._summary(t, reservoir)
            if app is not None and row["app"] != app:
                continue
            if status is not None and status not in row["status"]:
                continue
            if (min_duration_s is not None
                    and row["duration_s"] < float(min_duration_s)):
                continue
            rows.append(row)
            if len(rows) >= limit:
                break
        return rows

    def spans_of(self, trace_id: str) -> list[dict] | None:
        t = self._traces.get(trace_id)
        if t is None:
            return None
        return list(t.spans)

    def assemble(self, trace_id: str) -> dict | None:
        """One trace as a nested span tree (children under
        parent_span_id; spans whose parent was never collected — e.g.
        sampled out on another process — surface as roots so a partial
        trace still renders). The ``/api/traces/<id>`` payload."""
        t = self._traces.get(trace_id)
        if t is None or not t.spans:
            return None
        by_id = {s["span_id"]: dict(s, children=[]) for s in t.spans}
        roots = []
        for node in sorted(by_id.values(), key=lambda s: s["start"]):
            parent = node.get("parent_span_id")
            if parent and parent in by_id and parent != node["span_id"]:
                by_id[parent]["children"].append(node)
            else:
                roots.append(node)
        return {
            "trace_id": trace_id,
            "status": self.status_of(t),
            "app": t.app,
            "start": t.start,
            "duration_s": round(t.end - t.start, 6),
            "ttft_s": t.ttft_s,
            "span_count": len(t.spans),
            "sources": sorted({s.get("source", "") for s in t.spans}),
            "tree": roots,
        }

    def exemplar_ids(self, *, flags: tuple | None = None,
                     slowest_ttft: bool = False, n: int = 3) -> list[str]:
        """Trace ids for SLO exemplars: either the newest traces carrying
        one of ``flags``, or the slowest-TTFT traces — the link from a
        burning SLO back into the trace plane."""
        if slowest_ttft:
            with_ttft = [t for t in self._traces.values()
                         if t.ttft_s is not None]
            with_ttft.sort(key=lambda t: -t.ttft_s)
            return [t.trace_id for t in with_ttft[:n]]
        want = set(flags or ())
        hits = [t for t in self._traces.values() if t.flags & want]
        hits.sort(key=lambda t: -t.last_stamp)
        return [t.trace_id for t in hits[:n]]

    def stats(self) -> dict:
        return {
            "traces": len(self._traces),
            "ingested_spans": self.ingested_spans,
            "dropped_spans": self.dropped_spans,
            "evicted_traces": self.evicted_traces,
            "retained_over_evict": self.retained_traces,
        }
