"""The port's Serve layer, function by function, against the JAX package's
on the same seeded inputs (no cluster; a few seconds): the config
dataclasses' defaults and checks, the autoscaling policy, the SLO
evaluator over a fleet history, the trace store, the controller's
checkpoint codec, the router's prompt digests and resume backoff, the
proxy's head sampler and status mapping (``Retry-After`` included), the
fleet aggregator and the chaos plan's JSON."""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

from ray_tpu_torch import exceptions as texc
from ray_tpu_torch._private import chaos as tchaos
from ray_tpu_torch.serve import autoscaling_policy as tpol
from ray_tpu_torch.serve import config as tcfg
from ray_tpu_torch.serve import controller as tctl
from ray_tpu_torch.serve import handle as thandle
from ray_tpu_torch.serve import proxy as tproxy
from ray_tpu_torch.serve import slo as tslo
from ray_tpu_torch.serve import trace_store as ttrace
from ray_tpu_torch.util import metrics as tmetrics

from ray_tpu import exceptions as jexc
from ray_tpu._private import chaos as jchaos
from ray_tpu.serve import autoscaling_policy as jpol
from ray_tpu.serve import config as jcfg
from ray_tpu.serve import controller as jctl
from ray_tpu.serve import handle as jhandle
from ray_tpu.serve import proxy as jproxy
from ray_tpu.serve import slo as jslo
from ray_tpu.serve import trace_store as jtrace
from ray_tpu.util import metrics as jmetrics

CONFIGS = ("AutoscalingConfig", "BatchConfig", "DeploymentConfig",
           "HTTPOptions", "GrpcOptions", "ModelParallelConfig")


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the record is the error
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("name", CONFIGS)
def test_config_defaults_and_checks(name):
    mine, theirs = getattr(tcfg, name), getattr(jcfg, name)
    assert ([(f.name, f.default, f.default_factory) for f in
             dataclasses.fields(mine)] ==
            [(f.name, f.default, f.default_factory) for f in
             dataclasses.fields(theirs)])
    assert dataclasses.asdict(mine()) == dataclasses.asdict(theirs())
    bad = {"AutoscalingConfig": ({"min_replicas": 3, "max_replicas": 2},
                                 {"upscale_kv_pressure": 1.5},
                                 {"signal_mode": "x"},
                                 {"upscale_decode_step_p50_s": 0}),
           "DeploymentConfig": ({"pool_role": "x"},),
           "ModelParallelConfig": ({"tp": 0}, {"attention_backend": "x"})}
    for kw in bad.get(name, ()):
        got = _error(lambda: mine(**kw))
        assert got is not None and got == _error(lambda: theirs(**kw))


def _snapshots(rng, n):
    out = []
    for _ in range(n):
        out.append({
            "queue_wait_p95_s": float(rng.choice([0.0, 0.1, 0.3])),
            "rejection_rate": float(rng.choice([0.0, 0.0, 0.5])),
            "kv_pool_pressure": float(rng.uniform(0, 1)),
            "kv_pressure_two_tier": float(rng.uniform(0, 1)),
            "deadline_miss_rate": float(rng.choice([0.0, 0.0, 0.2])),
            "decode_step_p50_s": float(rng.uniform(0, 0.05)),
            "queue_depth": int(rng.integers(0, 3)),
            "running": int(rng.integers(0, 2)),
            "prefilling": int(rng.integers(0, 2)),
            "preempted_streams": int(rng.integers(0, 2)),
            "preempt_exhausted": bool(rng.integers(0, 2)),
            "queue_depth_by_class": {
                p: int(rng.integers(0, 2))
                for p in ("batch", "default", "interactive")},
        })
    return out


@pytest.mark.parametrize("mode", ["all", "prefill", "decode"])
def test_autoscaling_policy(mode):
    rng = np.random.default_rng(11)
    kw = dict(min_replicas=1, max_replicas=4, signal_mode=mode,
              upscale_decode_step_p50_s=0.03, upscale_delay_periods=2,
              downscale_delay_periods=3)
    mc, tc = tcfg.AutoscalingConfig(**kw), jcfg.AutoscalingConfig(**kw)
    for _ in range(50):
        load = float(rng.uniform(0, 20))
        cur = int(rng.integers(0, 5))
        assert (tpol.calculate_desired_num_replicas(mc, load, cur)
                == jpol.calculate_desired_num_replicas(tc, load, cur))
    md, jd = tpol.AutoscalingDecider(mc), jpol.AutoscalingDecider(tc)
    mine, theirs, cur_m, cur_j = [], [], 1, 1
    for _ in range(60):
        snaps = _snapshots(rng, int(rng.integers(0, 4)))
        for s in snaps:
            assert tpol.snapshot_is_hot(mc, s) == jpol.snapshot_is_hot(tc, s)
            assert (tpol.snapshot_is_cold(mc, s)
                    == jpol.snapshot_is_cold(tc, s))
        cur = int(rng.integers(1, 5))
        for fn in ("desired_from_signals", "fleet_saturated",
                   "shed_classes"):
            assert (getattr(tpol, fn)(mc, snaps, cur)
                    == getattr(jpol, fn)(tc, snaps, cur))
        cur_m = md.decide_from_signals(snaps, cur_m)
        cur_j = jd.decide_from_signals(snaps, cur_j)
        load = float(rng.uniform(0, 12))
        mine.append((cur_m, md.decide(load, cur_m)))
        theirs.append((cur_j, jd.decide(load, cur_j)))
    assert mine == theirs
    assert len({m for m, _ in mine}) > 1  # the series moved the fleet


def _families(rng, totals):
    """One report's families: a TTFT histogram, finished and rejected
    counters and a goodput gauge, the counters advancing from
    ``totals``."""
    totals["fast"] += int(rng.integers(0, 20))
    totals["slow"] += int(rng.integers(0, 3))
    totals["finished"] += int(rng.integers(5, 20))
    totals["rejected"] += int(rng.integers(0, 2))
    fast, slow = totals["fast"], totals["slow"]
    return {
        "llm_ttft_seconds": {"type": "histogram", "help": "ttft", "samples": [
            {"name": "llm_ttft_seconds_bucket", "labels": {"le": "0.5"},
             "value": float(fast)},
            {"name": "llm_ttft_seconds_bucket", "labels": {"le": "+Inf"},
             "value": float(fast + slow)},
            {"name": "llm_ttft_seconds_count", "labels": {},
             "value": float(fast + slow)},
            {"name": "llm_ttft_seconds_sum", "labels": {},
             "value": 0.1 * fast + 2.0 * slow}]},
        "llm_requests_finished": {"type": "counter", "help": "", "samples": [
            {"name": "llm_requests_finished_total", "labels": {},
             "value": float(totals["finished"])}]},
        "llm_requests_rejected": {"type": "counter", "help": "", "samples": [
            {"name": "llm_requests_rejected_total", "labels": {},
             "value": float(totals["rejected"])}]},
        "llm_goodput_tokens_per_sec": {"type": "gauge", "help": "",
                                       "samples": [
            {"name": "llm_goodput_tokens_per_sec",
             "labels": {"kind": "decode"},
             "value": float(rng.choice([0.0, 0.5, 40.0]))}]},
    }


def _fleet(metrics_mod):
    rng = np.random.default_rng(3)
    agg = metrics_mod.FleetAggregator(history_samples=50)
    totals = {r: dict(fast=0, slow=0, finished=0, rejected=0)
              for r in ("r0", "r1")}
    for i in range(80):
        rid = "r0" if i % 3 else "r1"
        agg.ingest(f"replica:{rid}", _families(rng, totals[rid]),
                   {"app": "a", "deployment": "d", "replica_id": rid,
                    "pool_role": ""}, stamp=2.5 * i)
    return agg


def test_fleet_aggregator_and_slo_evaluate():
    mine, theirs = _fleet(tmetrics), _fleet(jmetrics)
    assert mine.fleet_families() == theirs.fleet_families()
    assert mine.fleet_text() == theirs.fleet_text()
    assert mine.sources() == theirs.sources()
    assert mine.history() == theirs.history()
    assert (mine.history(prefix="llm_ttft")
            == theirs.history(prefix="llm_ttft"))
    now = 2.5 * 79
    got = tslo.evaluate(tslo.default_slos(), mine.history(), now)
    want = jslo.evaluate(jslo.default_slos(), theirs.history(), now)
    assert got == want
    assert any(r["burning"] for r in got)  # the history burns something
    assert ([dataclasses.asdict(s) for s in tslo.default_slos()]
            == [dataclasses.asdict(s) for s in jslo.default_slos()])


def _spans(rng):
    names = ("http.request", "handle.dispatch", "engine.request",
             "engine.preempted", "handle.resume", "handle.shed",
             "engine.prefill")
    spans = []
    for t in range(40):
        tid = f"{t:016x}"
        parent = None
        for j in range(int(rng.integers(1, 6))):
            name = str(rng.choice(names))
            attrs = {"deployment": f"app{t % 3}/d"}
            if name == "engine.request":
                attrs.update(finish_reason=str(rng.choice(
                    ["length", "expired", "failed", "eos"])),
                    ttft_s=float(rng.uniform(0, 1)),
                    preempt_count=int(rng.integers(0, 2)))
            sid = f"{t:08x}{j:08x}"
            start = float(t + j * 0.01)
            spans.append({"trace_id": tid, "span_id": sid,
                          "parent_span_id": parent, "name": name,
                          "start": start, "end": start + 0.5,
                          "attrs": attrs, "kind": "span"})
            parent = sid
    return spans


def test_trace_store():
    spans = _spans(np.random.default_rng(4))
    stores = []
    for mod in (ttrace, jtrace):
        store = mod.TraceStore(max_traces=25, sample_rate=0.3,
                               ttft_reservoir=4)
        for i in range(0, len(spans), 7):
            store.ingest(spans[i:i + 7], source=f"replica:{i % 2}",
                         stamp=float(i))
        store.ingest(spans[:5], source="replica:0", stamp=999.0)  # again
        stores.append(store)
    mine, theirs = stores
    assert mine.stats() == theirs.stats()
    for kw in ({}, {"app": "app1"}, {"status": "failover"},
               {"status": "sampled"}, {"min_duration_s": 0.51}):
        assert mine.list_traces(**kw) == theirs.list_traces(**kw)
    ids = [r["trace_id"] for r in mine.list_traces(limit=1000)]
    assert len(ids) == 25
    for tid in ids + ["missing"]:
        assert mine.assemble(tid) == theirs.assemble(tid)
        assert mine.spans_of(tid) == theirs.spans_of(tid)
    assert (mine.exemplar_ids(slowest_ttft=True)
            == theirs.exemplar_ids(slowest_ttft=True))
    assert (mine.exemplar_ids(flags=("error",))
            == theirs.exemplar_ids(flags=("error",)))
    for tid in ids:
        for rate in (0.0, 0.25, 0.5, 1.0):
            assert (ttrace.sample_decision(tid, rate)
                    == jtrace.sample_decision(tid, rate))


def test_checkpoint_codec():
    payload = {
        "version": tctl.CHECKPOINT_VERSION, "seq": 7, "written_at": 12.5,
        "restarts": 1, "reconciler_version": 42,
        "apps": {"app": {"ingress": "D", "route_prefix": "/a",
                         "deployments": {"D": {
                             "spec_blob": "eA==", "target": 2,
                             "status": "HEALTHY", "shed": False,
                             "shed_classes": ["batch"],
                             "replicas": [{"actor_id": "ab" * 16,
                                           "state": "DRAINING",
                                           "drain_remaining_s": 1.5}]}}}},
        "proxy_cfg": [{"port": 0}, None],
    }
    assert tctl.CHECKPOINT_VERSION == jctl.CHECKPOINT_VERSION
    assert (tctl.CHECKPOINT_KEY, tctl.CHECKPOINT_NS, tctl.CONTROLLER_NAME) \
        == (jctl.CHECKPOINT_KEY, jctl.CHECKPOINT_NS, jctl.CONTROLLER_NAME)
    blob = tctl.encode_checkpoint(payload)
    assert blob == jctl.encode_checkpoint(payload)
    assert tctl.decode_checkpoint(blob) == jctl.decode_checkpoint(blob)
    for bad in (b"\xff", b"[]", json.dumps({"version": 99}).encode(),
                json.dumps({"version": 1, "seq": 1}).encode()):
        got = _error(lambda: tctl.decode_checkpoint(bad))
        assert got is not None and got == _error(
            lambda: jctl.decode_checkpoint(bad))
    spec = {"name": "D", "callable_blob": b"\x00\x01", "init_args": (1,),
            "init_kwargs": {"k": [2, 3]}, "config": tcfg.DeploymentConfig()}
    assert tctl.decode_spec(tctl.encode_spec(spec)) == spec


def _router(mod, block_size, vocab):
    r = mod._Router("app", "dep")
    r._prefix_block_size, r._prefix_vocab_size = block_size, vocab
    r._prefix_summaries = {b"a": frozenset({"x"})}
    return r


def test_prompt_digests():
    rng = np.random.default_rng(8)
    mine, theirs = _router(thandle, 4, 512), _router(jhandle, 4, 512)
    payloads = [
        {"prompt": rng.integers(0, 512, 70).tolist()},
        {"prompt": rng.integers(0, 512, 3).tolist()},
        {"prompt": "hello, world! a string prompt"},
        {"prompt": "é" * 9},
        {"prompt": [1, 2, 3, 4, 5], "prior_tokens": [6]},
        {"prompt": ["x", "y", "z", "w"]},
    ]
    got = [mine._prompt_digests(p) for p in payloads]
    assert got == [theirs._prompt_digests(p) for p in payloads]
    assert len(got[0]) == 16 and got[1] is None and got[4] is None
    mine._prefix_summaries = {}
    assert mine._prompt_digests(payloads[0]) is None


def test_backoff_sampler_and_status_mapping():
    for seed in (0, 7, 123456):
        for attempt in range(12):
            assert (thandle.resume_backoff_s(seed, attempt)
                    == jhandle.resume_backoff_s(seed, attempt))
    for rate in (0.0, 0.3, 1.0):
        a = tproxy.head_sampler("http:127.0.0.1:0", rate)
        b = jproxy.head_sampler("http:127.0.0.1:0", rate)
        assert [a() for _ in range(200)] == [b() for _ in range(200)]
    assert tproxy._RETRY_AFTER == jproxy._RETRY_AFTER
    cases = [
        ("EngineOverloadedError", ("full",), None),
        ("EngineOverloadedError", ("full",), "batch"),
        ("EngineOverloadedError", ("full",), "interactive"),
        ("EngineOverloadedError", ("full",), "weird"),
        ("DeadlineExceededError", ("late",), None),
        ("RequestCancelledError", ("gone",), None),
        ("GetTimeoutError", ("slow",), None),
    ]
    for name, args, prio in cases:
        assert (tproxy._status_for(getattr(texc, name)(*args), prio)
                == jproxy._status_for(getattr(jexc, name)(*args), prio))
    for e, f in ((ValueError("bad"), ValueError("bad")),
                 (RuntimeError("x"), RuntimeError("x")),
                 (texc.TaskError("f", "tb", texc.EngineOverloadedError("o")),
                  jexc.TaskError("f", "tb", jexc.EngineOverloadedError("o")))):
        assert tproxy._status_for(e) == jproxy._status_for(f)
    assert tproxy._status_for(texc.EngineOverloadedError("x"), "batch") == (
        503, {"Retry-After": "5"})


def test_chaos_plan_json_round_trip(monkeypatch):
    faults = (("llm.token", "delay", 2, {"tag": "slow"}, None, 0.05),
              ("controller.kill", "kill", 0, {"reason": "deploy"}, 1, None),
              ("engine.decode", "raise", 10, None, 1, "boom"))
    mine = tchaos.FaultPlan(seed=9, faults=tuple(
        tchaos.Fault(*f) for f in faults))
    theirs = jchaos.FaultPlan(seed=9, faults=tuple(
        jchaos.Fault(*f) for f in faults))
    assert tchaos.ENV_VAR == jchaos.ENV_VAR
    assert mine.to_json() == theirs.to_json()
    assert tchaos.FaultPlan.from_json(theirs.to_json()) == mine
    assert (jchaos.FaultPlan.from_json(mine.to_json()).to_json()
            == mine.to_json())
    # the environment's plan is read at the first fire after clear()
    monkeypatch.setenv(tchaos.ENV_VAR, tchaos.FaultPlan(faults=(
        tchaos.Fault("unit.point", "raise", when={"k": 1}),)).to_json())
    tchaos.clear()
    try:
        tchaos.fire("unit.point", k=2)  # filtered out
        with pytest.raises(tchaos.ChaosFault):
            tchaos.fire("unit.point", k=1)
        tchaos.fire("unit.point", k=1)  # times=1: spent
    finally:
        monkeypatch.delenv(tchaos.ENV_VAR)
        tchaos.clear()
