"""Declarative SLOs evaluated as multi-window burn rates over the
fleet metrics plane (the port's copy of ``ray_tpu/serve/slo.py``).

An ``SLOSpec`` names an objective over one of three signal shapes the
``FleetAggregator`` history rings already hold (serve/controller.py
polls them; util/metrics.py stores them):

- ``latency``: a histogram family + a threshold — "99% of requests see
  TTFT <= 200ms".  bad_fraction over a window = the fraction of events
  whose bucket is above the threshold.
- ``ratio``: bad-event counter families over total-event counter
  families — availability / error rate.
- ``gauge_floor``: a gauge family that must average >= a floor —
  goodput.  bad_fraction = how far below the floor the windowed average
  sits, as a fraction of the floor.

Burn rate follows the SRE-workbook definition: with an objective of
``p`` the error budget is ``1 - p``; ``burn = bad_fraction / (1 - p)``.
A burn of 1.0 exactly consumes the budget over the window; the monitor
alarms ("burning") only when EVERY configured window exceeds its burn
threshold — the standard multi-window guard against paging on blips
(short window confirms it's current, long window confirms it's real).

The module is pure: ``evaluate()`` takes the aggregator's ``history()``
output and the evaluation clock, returns plain dicts, and touches no
wall clock of its own — the controller stamps everything with
``obs.clock`` (the one-clock rule; lint-enforced).
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["SLOSpec", "default_slos", "evaluate", "parse_series_labels"]

# evaluation windows (seconds) and the burn threshold each must exceed
# before the SLO reports burning — short confirms current, long real
_DEFAULT_WINDOWS = (60.0, 300.0)


@dataclass(frozen=True)
class SLOSpec:
    """One declarative SLO (see module docstring for the three kinds)."""

    name: str                       # stable id: metric label + API key
    kind: str                       # "latency" | "ratio" | "gauge_floor"
    objective: float = 0.99         # good-event target (budget = 1 - obj)
    # latency:
    family: str | None = None       # histogram family, e.g. llm_ttft_seconds
    threshold_s: float | None = None
    # ratio:
    bad_families: tuple = ()
    total_families: tuple = ()      # totals = bad + these (bad is counted in)
    # gauge_floor:
    floor: float | None = None
    label_filters: tuple = ()       # ((key, value), ...) series must match
    windows_s: tuple = _DEFAULT_WINDOWS
    burn_threshold: float = 1.0
    # how the controller picks exemplar traces when this SLO burns:
    # "slowest_ttft" or a retention flag name from trace_store
    exemplar: str = "slowest_ttft"
    description: str = ""

    def __post_init__(self):
        if self.kind not in ("latency", "ratio", "gauge_floor"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if not 0.0 < self.objective < 1.0 and self.kind != "gauge_floor":
            raise ValueError(
                f"objective must be in (0, 1), got {self.objective}")
        if self.kind == "latency" and (
                self.family is None or self.threshold_s is None):
            raise ValueError(f"latency SLO {self.name!r} needs family "
                             "and threshold_s")
        if self.kind == "ratio" and not self.bad_families:
            raise ValueError(f"ratio SLO {self.name!r} needs bad_families")
        if self.kind == "gauge_floor" and (
                self.family is None or self.floor is None):
            raise ValueError(f"gauge_floor SLO {self.name!r} needs family "
                             "and floor")


def default_slos() -> tuple:
    """The serving fleet's stock SLOs; apps override by passing their own
    specs to the controller (``serve.start(slos=...)`` stays future work
    — the controller accepts a list at construction)."""
    return (
        SLOSpec(
            name="ttft_p99",
            kind="latency",
            objective=0.99,
            family="llm_ttft_seconds",
            threshold_s=0.5,
            exemplar="slowest_ttft",
            description="99% of requests see first token within 500ms",
        ),
        SLOSpec(
            name="tpot_p99",
            kind="latency",
            objective=0.99,
            family="llm_time_per_output_token_seconds",
            threshold_s=0.2,
            exemplar="slowest_ttft",
            description="99% of inter-token gaps under 200ms",
        ),
        SLOSpec(
            name="availability",
            kind="ratio",
            objective=0.99,
            bad_families=("llm_requests_rejected", "llm_deadline_exceeded",
                          "llm_requests_shed"),
            total_families=("llm_requests_finished",),
            exemplar="error",
            description="99% of requests finish without shed/reject/"
                        "deadline-expiry",
        ),
        SLOSpec(
            name="goodput_floor",
            kind="gauge_floor",
            family="llm_goodput_tokens_per_sec",
            label_filters=(("kind", "decode"),),
            floor=1.0,
            exemplar="slowest_ttft",
            description="windowed decode goodput stays above 1 token/s "
                        "per reporting engine",
        ),
    )


# ---------------- history-ring plumbing ----------------


def parse_series_labels(series_key: str) -> tuple[str, dict]:
    """Invert ``metrics.sample_key``: ``name{k=v,k2=v2}`` ->
    (name, {k: v}). Label values in this codebase never contain commas
    or braces (ids, app names, bucket boundaries)."""
    if "{" not in series_key:
        return series_key, {}
    name, _, rest = series_key.partition("{")
    labels = {}
    for pair in rest.rstrip("}").split(","):
        if not pair:
            continue
        k, _, v = pair.partition("=")
        labels[k] = v
    return name, labels


def _window_delta(ring, now: float, window_s: float) -> float:
    """Cumulative-series delta over [now - window_s, now]: latest value
    minus the newest sample at-or-before the window start. A ring that
    does not span the window yet contributes from its earliest sample
    (conservative: never invents events)."""
    if not ring:
        return 0.0
    latest = ring[-1][1]
    cutoff = now - window_s
    base = ring[0][1]
    for stamp, value in ring:
        if stamp <= cutoff:
            base = value
        else:
            break
    return max(0.0, latest - base)


def _window_avg(ring, now: float, window_s: float) -> float | None:
    """Mean of a gauge ring's samples inside the window (None when the
    window holds no samples)."""
    cutoff = now - window_s
    vals = [v for stamp, v in ring if stamp > cutoff]
    if not vals:
        return None
    return sum(vals) / len(vals)


def _match(labels: dict, filters: tuple) -> bool:
    return all(labels.get(k) == v for k, v in filters)


def _latency_bad_fraction(spec: SLOSpec, history: dict, now: float,
                          window_s: float) -> tuple[float | None, float]:
    """(bad_fraction, events) for one histogram window — None when the
    window saw no events (nothing to judge)."""
    prefix = spec.family + "_bucket"
    # buckets are cumulative per source series: the widest le <= threshold
    # already contains every smaller one, so group by (source labels sans
    # le), take that widest bucket as "good", and the +Inf bucket as the
    # series total
    per_source: dict[tuple, dict] = {}
    for key, ring in history.items():
        name, labels = parse_series_labels(key)
        if name != prefix or not _match(labels, spec.label_filters):
            continue
        le = labels.get("le")
        if le is None:
            continue
        src = tuple(sorted((k, v) for k, v in labels.items() if k != "le"))
        per_source.setdefault(src, {})[le] = _window_delta(
            ring, now, window_s)
    total = 0.0
    good = 0.0
    for buckets in per_source.values():
        inf = buckets.get("+Inf", 0.0)
        best = 0.0
        for le, delta in buckets.items():
            if le != "+Inf" and float(le) <= spec.threshold_s:
                best = max(best, delta)
        total += inf
        good += min(best, inf)
    if total <= 0.0:
        return None, 0.0
    return max(0.0, 1.0 - good / total), total


def _ratio_bad_fraction(spec: SLOSpec, history: dict, now: float,
                        window_s: float) -> tuple[float | None, float]:
    def fam_delta(families: tuple) -> float:
        out = 0.0
        for key, ring in history.items():
            name, labels = parse_series_labels(key)
            # counter samples carry the Prometheus ``_total`` suffix in
            # the history rings; specs name the bare family
            if name.endswith("_total"):
                name = name[: -len("_total")]
            if name in families and _match(labels, spec.label_filters):
                out += _window_delta(ring, now, window_s)
        return out

    bad = fam_delta(spec.bad_families)
    total = bad + fam_delta(spec.total_families)
    if total <= 0.0:
        return None, 0.0
    return min(1.0, bad / total), total


def _gauge_bad_fraction(spec: SLOSpec, history: dict, now: float,
                        window_s: float) -> tuple[float | None, float]:
    avgs = []
    for key, ring in history.items():
        name, labels = parse_series_labels(key)
        if name != spec.family or not _match(labels, spec.label_filters):
            continue
        avg = _window_avg(ring, now, window_s)
        if avg is not None:
            avgs.append(avg)
    if not avgs:
        return None, 0.0
    value = sum(avgs) / len(avgs)
    if spec.floor <= 0:
        return 0.0, float(len(avgs))
    return max(0.0, 1.0 - value / spec.floor), float(len(avgs))


_KIND_FNS = {
    "latency": _latency_bad_fraction,
    "ratio": _ratio_bad_fraction,
    "gauge_floor": _gauge_bad_fraction,
}


def evaluate(specs, history: dict, now: float) -> list[dict]:
    """Evaluate every spec over the aggregator history rings at clock
    ``now`` (the controller's ``obs.clock()``); -> one result dict per
    spec:  {name, kind, objective, description, burning,
    windows: {"60s": {burn_rate, bad_fraction, events}, ...}}.

    A window with no events contributes burn 0 (no data is not an
    outage — availability of an idle fleet is intact), and an SLO only
    reports burning when every window both saw data and exceeded its
    burn threshold."""
    results = []
    for spec in specs:
        fn = _KIND_FNS[spec.kind]
        budget = max(1e-9, 1.0 - spec.objective)
        windows = {}
        burning = True
        for w in spec.windows_s:
            bad, events = fn(spec, history, now, w)
            if bad is None:
                windows[f"{int(w)}s"] = {
                    "burn_rate": 0.0, "bad_fraction": 0.0,
                    "events": 0.0,
                }
                burning = False
                continue
            burn = bad / budget
            windows[f"{int(w)}s"] = {
                "burn_rate": round(burn, 4),
                "bad_fraction": round(bad, 6),
                "events": round(events, 2),
            }
            if burn < spec.burn_threshold:
                burning = False
        results.append({
            "name": spec.name,
            "kind": spec.kind,
            "objective": spec.objective,
            "description": spec.description,
            "burning": burning,
            "windows": windows,
        })
    return results
