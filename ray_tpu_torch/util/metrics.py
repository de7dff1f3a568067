"""Application metrics: Counter / Gauge / Histogram (the port's copy of
``ray_tpu/util/metrics.py``).

The reference registers into ``prometheus_client``; the card's machine
does not have that package, so the port keeps a registry of its own in
plain Python. What it exposes is what ``prometheus_client`` would: the
same family names (a counter's ``_total`` suffix moves to its samples),
sample names (``_total`` and ``_created`` for counters, ``_bucket`` /
``_count`` / ``_sum`` / ``_created`` for histograms, the bucket's bound
as its ``le`` label spelled as Go spells a float), sample order, default
buckets, and errors (a duplicated name, a negative increment, unsorted
buckets). ``collect()``, ``collect_families()`` and ``sample_key()`` give
the reference's shapes; ``render_prometheus`` writes the text format
(0.0.4) by hand and ``start_metrics_server`` serves it with ``wsgiref``.

The registry is per process and separate from the JAX package's, so the
two never see each other's series. ``FleetAggregator`` is the Serve
controller's merge of many processes' ``collect_families()`` snapshots
into one plane (a copy of the reference's): entity labels per source,
per-kind rollups and a bounded history ring a series.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Sequence

logger = logging.getLogger("ray_tpu_torch.metrics")

INF = float("inf")
# prometheus_client's buckets for a histogram given none
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 0.75,
                   1.0, 2.5, 5.0, 7.5, 10.0)

# family name -> metric, in registration order; every name a family
# exports (family and sample names), for the duplicate check
_registry: dict[str, "_Metric"] = {}
_names: set[str] = set()
_registry_lock = threading.Lock()


def _go_float(d: float) -> str:
    """A float as Go (and so Prometheus) writes it: ``+Inf``, ``1.0``,
    ``1e+07``."""
    d = float(d)
    if d == INF:
        return "+Inf"
    if d == -INF:
        return "-Inf"
    if d != d:
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:  # Go switches to an exponent sooner than Python
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, description: str, tag_keys: Sequence[str]):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._default_tags: dict[str, str] = {}
        self._lock = threading.Lock()
        # label values (in tag_keys order) -> the series' state
        self._series: dict[tuple, dict] = {}
        self.family = name
        if self.kind == "counter" and name.endswith("_total"):
            self.family = name[:-len("_total")]
        exported = {self.family, *self._sample_names()}
        with _registry_lock:
            clash = exported & _names
            if clash:
                raise ValueError(
                    f"Duplicated timeseries in the registry: {sorted(clash)}")
            _names.update(exported)
            _registry[self.family] = self
        if not self.tag_keys:  # an unlabelled series exists from the start
            self._child(())

    def _sample_names(self) -> tuple:
        return ()

    def set_default_tags(self, tags: dict[str, str]):
        """Tags every later call falls back to (a call's own win)."""
        self._default_tags = dict(tags)
        return self

    def _labels(self, tags: dict | None) -> tuple:
        if not self.tag_keys:  # one series; extra tags select nothing
            return ()
        merged = {**self._default_tags, **(tags or {})}
        missing = set(self.tag_keys) - set(merged)
        if missing:
            raise ValueError(
                f"metric {self.name} missing tags: {sorted(missing)}")
        return tuple(str(merged[k]) for k in self.tag_keys)

    def _child(self, key: tuple) -> dict:
        """The series of ``key`` (label values), made at its first use;
        call under ``self._lock`` or from ``__init__``."""
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = self._new()
        return s

    def _new(self) -> dict:
        raise NotImplementedError

    def _samples(self, labels: dict, s: dict):
        raise NotImplementedError

    def samples(self) -> list[tuple[str, dict, float]]:
        """(sample name, labels, value) of every series, in the order
        ``prometheus_client`` yields them."""
        out = []
        with self._lock:  # one consistent reading of every series
            for key, s in self._series.items():
                out.extend(self._samples(dict(zip(self.tag_keys, key)), s))
        return out


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, description="", tag_keys=()):
        super().__init__(name, description, tag_keys)

    def _sample_names(self):
        return (f"{self.family}_total", f"{self.family}_created")

    def _new(self):
        return {"value": 0.0, "created": time.time()}

    def _samples(self, labels, s):
        return [(f"{self.family}_total", labels, s["value"]),
                (f"{self.family}_created", labels, s["created"])]

    def inc(self, value: float = 1.0, tags: dict | None = None):
        if value < 0:
            raise ValueError(
                "Counters can only be incremented by non-negative amounts.")
        key = self._labels(tags)
        with self._lock:
            self._child(key)["value"] += float(value)


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, description="", tag_keys=()):
        super().__init__(name, description, tag_keys)

    def _sample_names(self):
        return (self.family,)

    def _new(self):
        return {"value": 0.0}

    def _samples(self, labels, s):
        return [(self.family, labels, s["value"])]

    def set(self, value: float, tags: dict | None = None):
        key = self._labels(tags)
        with self._lock:
            self._child(key)["value"] = float(value)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, description="", boundaries=(), tag_keys=()):
        self.boundaries = tuple(boundaries)
        bounds = [float(b) for b in (boundaries or DEFAULT_BUCKETS)]
        if bounds != sorted(bounds):
            raise ValueError("Buckets not in sorted order")
        if bounds and bounds[-1] != INF:
            bounds.append(INF)
        if len(bounds) < 2:
            raise ValueError("Must have at least two buckets")
        self._bounds = tuple(bounds)
        super().__init__(name, description, tag_keys)

    def _sample_names(self):
        return tuple(f"{self.family}_{s}"
                     for s in ("bucket", "count", "sum", "created"))

    def _new(self):
        return {"buckets": [0] * len(self._bounds), "sum": 0.0,
                "created": time.time()}

    def _samples(self, labels, s):
        out, total = [], 0
        for bound, n in zip(self._bounds, s["buckets"]):
            total += n
            out.append((f"{self.family}_bucket",
                        {**labels, "le": _go_float(bound)}, float(total)))
        out += [(f"{self.family}_count", labels, float(total)),
                (f"{self.family}_sum", labels, s["sum"]),
                (f"{self.family}_created", labels, s["created"])]
        return out

    def observe(self, value: float, tags: dict | None = None):
        key = self._labels(tags)
        value = float(value)
        with self._lock:
            s = self._child(key)
            s["sum"] += value
            for i, bound in enumerate(self._bounds):
                if value <= bound:
                    s["buckets"][i] += 1
                    break


# Idempotent named-metric factories: the engine, built several times in a
# process, wants one shared instrument per name; a kind, tag-key or
# boundary mismatch raises, a different description warns once.
_named: dict[str, _Metric] = {}
_named_lock = threading.Lock()
_desc_warned: set[str] = set()


def _get_named(cls, name: str, description: str, tag_keys, **kwargs):
    with _named_lock:
        m = _named.get(name)
        if m is None:
            m = cls(name, description, tag_keys=tag_keys, **kwargs)
            _named[name] = m
        elif type(m) is not cls:
            raise TypeError(
                f"metric {name!r} already registered as {type(m).__name__}, "
                f"requested {cls.__name__}"
            )
        else:
            if tuple(tag_keys) != m.tag_keys:
                raise ValueError(
                    f"metric {name!r} already registered with tag_keys="
                    f"{m.tag_keys}, requested {tuple(tag_keys)}"
                )
            if isinstance(m, Histogram):
                want = tuple(kwargs.get("boundaries") or ())
                if want != m.boundaries:
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"boundaries={m.boundaries}, requested {want}"
                    )
            if (description and m.description
                    and description != m.description
                    and name not in _desc_warned):
                _desc_warned.add(name)
                logger.warning(
                    "metric %r re-registered with a different description "
                    "(%r vs original %r); keeping the original — update "
                    "the caller or the docs",
                    name, description, m.description,
                )
        return m


def counter(name: str, description: str = "", tag_keys=()) -> Counter:
    """Get-or-create a process-wide Counter by name."""
    return _get_named(Counter, name, description, tag_keys)


def gauge(name: str, description: str = "", tag_keys=()) -> Gauge:
    """Get-or-create a process-wide Gauge by name."""
    return _get_named(Gauge, name, description, tag_keys)


def histogram(name: str, description: str = "", boundaries=(),
              tag_keys=()) -> Histogram:
    """Get-or-create a process-wide Histogram by name."""
    return _get_named(Histogram, name, description, tag_keys,
                      boundaries=boundaries)


def _metrics() -> list[_Metric]:
    with _registry_lock:
        return list(_registry.values())


def collect(prefix: str | None = None) -> dict[str, float]:
    """Every sample as {``name{label=v,...}``: value} (labels sorted);
    ``prefix`` filters by sample name."""
    out = {}
    for m in _metrics():
        for name, labels, value in m.samples():
            if prefix is not None and not name.startswith(prefix):
                continue
            out[sample_key(name, labels)] = value
    return out


def collect_families(prefix: str | None = None) -> dict[str, dict]:
    """``{family: {"type", "help", "samples": [{"name", "labels",
    "value"}]}}``, ``_created`` samples dropped; ``prefix`` filters by
    family name. Plain JSON-safe dicts."""
    out: dict[str, dict] = {}
    for m in _metrics():
        if prefix is not None and not m.family.startswith(prefix):
            continue
        out[m.family] = {
            "type": m.kind,
            "help": m.description,
            "samples": [{"name": n, "labels": labels, "value": float(v)}
                        for n, labels, v in m.samples()
                        if not n.endswith("_created")],
        }
    return out


def sample_key(name: str, labels: dict[str, str]) -> str:
    """``name{k=v,...}`` with labels sorted, the ``collect()`` spelling."""
    pairs = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return f"{name}{{{pairs}}}" if pairs else name


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r"\""))


def _format_value(value: float) -> str:
    f = float(value)
    if f == INF:
        return "+Inf"
    if f == -INF:
        return "-Inf"
    if f.is_integer():
        return str(int(f))
    return repr(f)


def render_prometheus(families: dict[str, dict]) -> str:
    """Prometheus text exposition (format 0.0.4) of a
    ``collect_families()``-shaped dict."""
    lines: list[str] = []
    for fname in sorted(families):
        fam = families[fname]
        help_text = str(fam.get("help") or "").replace("\\", r"\\").replace(
            "\n", r"\n")
        if help_text:
            lines.append(f"# HELP {fname} {help_text}")
        lines.append(f"# TYPE {fname} {fam.get('type') or 'untyped'}")
        for s in fam["samples"]:
            labels = ",".join(f'{k}="{_escape_label(v)}"'
                              for k, v in sorted(s["labels"].items()))
            body = f"{s['name']}{{{labels}}}" if labels else s["name"]
            lines.append(f"{body} {_format_value(s['value'])}")
    return "\n".join(lines) + "\n"


def start_metrics_server(port: int = 9090, addr: str = "0.0.0.0"):
    """Serve the registry at ``http://addr:port/metrics`` (any path) from
    a daemon thread. -> ``(server, bound port)``; ``port=0`` binds a free
    one; ``server.shutdown()`` stops it."""
    from socketserver import ThreadingMixIn
    from wsgiref.simple_server import (
        WSGIRequestHandler,
        WSGIServer,
        make_server,
    )

    class _Server(ThreadingMixIn, WSGIServer):
        daemon_threads = True

    class _SilentHandler(WSGIRequestHandler):
        def log_message(self, format, *args):
            """Scrapes come every few seconds: keep them off stderr."""

    def app(environ, start_response):
        body = render_prometheus(collect_families()).encode()
        start_response("200 OK", [
            ("Content-Type", "text/plain; version=0.0.4; charset=utf-8"),
            ("Content-Length", str(len(body)))])
        return [body]

    server = make_server(addr, int(port), app, server_class=_Server,
                         handler_class=_SilentHandler)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="metrics-server")
    thread.start()
    return server, server.server_port


class FleetAggregator:
    """Merges per-process ``collect_families()`` snapshots into one fleet
    plane (driven by the Serve controller, one ``ingest`` per polled
    replica/proxy report).

    - Every source's samples are RELABELED with its entity labels
      (``deployment``/``replica_id``/``pool_role``/...), so per-replica
      series stay distinct at the single scrape target.
    - Rollup series drop ``replica_id`` and merge across sources with
      per-kind semantics: counters and histogram ``_bucket``/``_sum``/
      ``_count`` samples SUM (bucket counts are preserved exactly);
      gauges (and untyped families) are LAST-WRITE in report-stamp order.
    - Each relabeled series also feeds a bounded ring-buffer history
      (``history_samples`` newest ``(stamp, value)`` points, stamped with
      the ingest stamp — the controller's ``obs.clock``). Sources are
      never forgotten: a killed replica's last snapshot keeps the fleet
      counters monotonic and its rings stay queryable post-mortem.
    """

    ROLLUP_DROP = ("replica_id",)

    def __init__(self, history_samples: int = 360):
        self.history_samples = max(1, int(history_samples))
        self._lock = threading.Lock()
        # source key -> {"stamp", "labels", "families"}; insertion order
        # is irrelevant — fleet merges sort by stamp
        self._sources: dict[str, dict] = {}
        # relabeled series key -> deque[(stamp, value)]
        self._history: dict[str, deque] = {}

    def ingest(
        self,
        source: str,
        families: dict[str, dict],
        labels: dict[str, str],
        stamp: float,
    ) -> None:
        """Replace ``source``'s snapshot and append every sample to its
        history ring. Empty label values are dropped (Prometheus treats
        absent and empty labels identically)."""
        labels = {str(k): str(v) for k, v in (labels or {}).items() if v}
        with self._lock:
            self._sources[str(source)] = {
                "stamp": float(stamp),
                "labels": labels,
                "families": families,
            }
            for fam in families.values():
                for s in fam["samples"]:
                    key = sample_key(s["name"], {**s["labels"], **labels})
                    ring = self._history.get(key)
                    if ring is None:
                        ring = deque(maxlen=self.history_samples)
                        self._history[key] = ring
                    ring.append((float(stamp), float(s["value"])))

    def sources(self) -> dict[str, dict]:
        """{source: {"stamp", "labels"}} — who has reported, and when."""
        with self._lock:
            return {
                src: {"stamp": rec["stamp"], "labels": dict(rec["labels"])}
                for src, rec in self._sources.items()
            }

    def fleet_families(self) -> dict[str, dict]:
        """One ``collect_families()``-shaped dict for the whole fleet:
        per-source relabeled samples first, then the rollup samples
        (``replica_id`` dropped, per-kind merge)."""
        with self._lock:
            recs = sorted(
                self._sources.values(), key=lambda rec: rec["stamp"]
            )
            recs = [
                {
                    "stamp": rec["stamp"],
                    "labels": dict(rec["labels"]),
                    "families": rec["families"],
                }
                for rec in recs
            ]
        fams: dict[str, dict] = {}
        # (family, sample name, rollup label items) -> merged value
        rollup: dict[tuple, float] = {}
        for rec in recs:  # stamp order => "last write" = newest report
            for fname, fam in rec["families"].items():
                out = fams.setdefault(
                    fname,
                    {
                        "type": fam.get("type") or "untyped",
                        "help": fam.get("help") or "",
                        "samples": [],
                    },
                )
                summed = out["type"] in ("counter", "histogram")
                for s in fam["samples"]:
                    labels = {**s["labels"], **rec["labels"]}
                    out["samples"].append(
                        {
                            "name": s["name"],
                            "labels": labels,
                            "value": float(s["value"]),
                        }
                    )
                    if not any(k in labels for k in self.ROLLUP_DROP):
                        # nothing to drop: the per-source series IS the
                        # rollup; emitting both would duplicate it
                        continue
                    rl = tuple(sorted(
                        (k, v) for k, v in labels.items()
                        if k not in self.ROLLUP_DROP
                    ))
                    key = (fname, s["name"], rl)
                    if summed:
                        rollup[key] = rollup.get(key, 0.0) + float(s["value"])
                    else:
                        rollup[key] = float(s["value"])
        for (fname, sname, rl) in sorted(rollup, key=str):
            fams[fname]["samples"].append(
                {"name": sname, "labels": dict(rl), "value": rollup[(fname, sname, rl)]}
            )
        return fams

    def fleet_text(self) -> str:
        return render_prometheus(self.fleet_families())

    def history(
        self, series: str | None = None, prefix: str | None = None
    ) -> dict[str, list[tuple[float, float]]]:
        """Ring-buffer time series: ``{series_key: [(stamp, value), ...]}``
        (oldest first). ``series`` selects one exact key (``sample_key``
        spelling); ``prefix`` filters by key prefix; neither returns
        everything. Killed sources' rings remain until process exit."""
        with self._lock:
            if series is not None:
                ring = self._history.get(series)
                return {series: list(ring)} if ring is not None else {}
            return {
                key: list(ring)
                for key, ring in self._history.items()
                if prefix is None or key.startswith(prefix)
            }
