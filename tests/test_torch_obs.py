"""The port's observability and fail-closed surface against the JAX
engine's, on the CPU (the scenarios of ``tests/test_serve_llm_obs.py``).

One seeded workload runs through the JAX engine (Llama-tiny, f32,
``attention="xla"``) and the port's on the same weights (``convert.py``),
``auto_step=False``: a shared-prefix wave, a cancel, a batch stream parked
on the host KV tier under an interactive flood and resumed, the prefix
wave again, and a wave of a motif prompt (the n-gram drafter's) beside a
JSON-mode row, with ``speculative_k=4``. The two engines must agree on
every metric's name, kind, description, tag keys and buckets; every
counter's delta by name and tags; every histogram's sample count (and the
masked-fraction histogram's buckets, which hold no time); each request's
timeline as a sequence of event names; the flight ring's kinds and
non-time fields, in order; and ``autoscaling_snapshot()``'s non-time
keys. Then, on the port alone: the bounded ring, timeline history and dump
directory, an ``engine_died`` dump under a chaos ``raise``, a lock-free
``watchdog_timeout`` dump under a chaos ``delay``, ``shutdown(dump=path)``,
spans from a traced request, and the metrics registry against
``prometheus_client`` itself."""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

BUCKETS = dict(block_size=4, num_blocks=24, batch_buckets=(8,),
               length_buckets=(64,))
PRESSURE = dict(kv_pressure=0.5, queue_wait_s=1e6, resume_pressure=0.4,
                aging_s=1e6)
TIER = 1 << 20
PREFIX = [7, 8, 9, 10, 11, 12, 13, 14]      # two full blocks
BATCH_PROMPT, BATCH_NEW = [5, 6, 7, 8, 9, 11], 16
FLOOD, FLOOD_LEN, FLOOD_NEW = 6, 12, (4, 8, 12)
MOTIF = [21, 22, 23, 24, 25]
# what moves with the clock: left out of the ring and snapshot comparisons
TIME_KEYS = {"ts", "dur_ms", "sync_ms", "clock", "ts_wall",
             "queue_wait_p95_s", "decode_step_p50_s"}


@pytest.fixture(autouse=True)
def _cpu(jax_cpu):
    return jax_cpu


_WEIGHTS: dict = {}


def _weights():
    if not _WEIGHTS:
        import jax
        import jax.numpy as jnp
        from ray_tpu.models.llama import LlamaConfig as J
        from ray_tpu.models.llama import llama_init

        from ray_tpu_torch import convert
        from ray_tpu_torch.models.llama import LlamaConfig as T

        jcfg = dataclasses.replace(J.tiny(), dtype=jnp.float32,
                                   attention="xla")
        tcfg = dataclasses.replace(T.tiny(), dtype=torch.float32)
        tree = jax.tree.map(np.asarray, llama_init(jax.random.PRNGKey(0),
                                                   jcfg))
        _WEIGHTS.update(jcfg=jcfg, tcfg=tcfg, tree=tree,
                        state=convert.llama_params_from_numpy(tree, tcfg))
    return _WEIGHTS


def _jax_engine(**kw):
    import jax
    import jax.numpy as jnp
    from ray_tpu.serve.llm import EngineConfig, LLMEngine

    w = _weights()
    return LLMEngine(EngineConfig(model="llama", model_config=w["jcfg"],
                                  attention_backend="xla",
                                  **{**BUCKETS, **kw}),
                     params=jax.tree.map(jnp.asarray, w["tree"]),
                     auto_step=False)


def _port_engine(auto_step=False, **kw):
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    w = _weights()
    return LLMEngine(EngineConfig(model="llama", model_config=w["tcfg"],
                                  device="cpu", **{**BUCKETS, **kw}),
                     params=w["state"], auto_step=auto_step)


def _drain(eng):
    while eng.step():
        pass


def _outcome(stream):
    try:
        return list(stream)
    except Exception as e:  # noqa: BLE001 — the error's class is the outcome
        return type(e).__name__


def _workload(eng) -> tuple[list, list]:
    """The seeded workload (see the module docstring). -> (the streams'
    outcomes, the autoscaling snapshots taken: one while the batch
    stream is parked, one at the end)."""
    streams, snaps = [], []
    streams.append(eng.submit(PREFIX + [1, 2], max_new_tokens=4))
    eng.step()
    streams.append(eng.submit(PREFIX + [3], max_new_tokens=4,
                              temperature=0.8, seed=3))
    _drain(eng)
    gone = eng.submit([5, 5, 5], max_new_tokens=4)
    assert eng.cancel(gone.request_id)
    streams.append(gone)
    streams.append(eng.submit(BATCH_PROMPT, max_new_tokens=BATCH_NEW,
                              priority="batch"))
    for _ in range(3):
        eng.step()
    rng = np.random.default_rng(100)
    for i in range(FLOOD):
        streams.append(eng.submit(
            rng.integers(1, 500, FLOOD_LEN).tolist(),
            max_new_tokens=FLOOD_NEW[i % len(FLOOD_NEW)],
            priority="interactive", temperature=0.8, seed=100 + i))
    while eng.step():
        if eng.stats()["preempted"] and not snaps:
            snaps.append(eng.autoscaling_snapshot())
    streams.append(eng.submit(PREFIX + [1, 2], max_new_tokens=4))
    streams.append(eng.submit(MOTIF * 4, max_new_tokens=12))
    streams.append(eng.submit([40, 41, 42], max_new_tokens=12,
                              temperature=0.8, seed=9, structured="json"))
    _drain(eng)
    snaps.append(eng.autoscaling_snapshot())
    return [_outcome(s) for s in streams], snaps


def _engine_metrics(eng, metric_base, structured_mod) -> dict:
    """The engine's instruments (its attributes, obs's and structured's
    factories) by name."""
    out = {m.name: m for m in vars(eng).values()
           if isinstance(m, metric_base)}
    for m in (structured_mod.compile_seconds_histogram(),
              structured_mod.cache_hit_gauge()):
        out[m.name] = m
    return out


def _schema(m) -> tuple:
    return (type(m).__name__, m.description, m.tag_keys,
            getattr(m, "boundaries", None))


def _families(collect_families, names) -> dict:
    """{family: {(sample name, sorted labels): value}} of ``names``."""
    out = {}
    for fam, body in collect_families().items():
        if fam in names:
            out[fam] = {(s["name"], tuple(sorted(s["labels"].items()))):
                        s["value"] for s in body["samples"]}
            out[fam]["__type__"] = body["type"]
    return out


def _moved(before: dict, after: dict, fam: str, suffix: str) -> dict:
    """{(sample, labels): after - before} of one family's samples ending
    in ``suffix`` that moved (series of earlier engines in the process
    stand still)."""
    b, a = before.get(fam, {}), after.get(fam, {})
    moved = {k: v - b.get(k, 0.0) for k, v in a.items()
             if k != "__type__" and k[0].endswith(suffix)}
    return {k: v for k, v in moved.items() if v}


def _ring(eng) -> list:
    return [{k: v for k, v in r.items() if k not in TIME_KEYS}
            for r in eng.debug_dump()["steps"]]


@pytest.mark.timeout(180)
def test_engine_obs_equals_jax():
    from ray_tpu.serve.llm import structured as jax_structured
    from ray_tpu.util import metrics as jax_metrics

    from ray_tpu_torch.serve.llm import structured as port_structured
    from ray_tpu_torch.util import metrics as port_metrics

    kw = dict(preemption=dict(PRESSURE), host_cache_bytes=TIER,
              speculative_k=4, flight_recorder_steps=4096)
    runs = []
    for eng, metrics, structured in (
            (_jax_engine(**kw), jax_metrics, jax_structured),
            (_port_engine(**kw), port_metrics, port_structured)):
        structured.clear_cache()  # the JSON grammar compiles in the run
        inst = _engine_metrics(eng, metrics._Metric, structured)
        # a counter's family drops its _total (prometheus_client's rule)
        fams = set(inst) | {n[:-len("_total")] for n in inst
                            if n.endswith("_total")}
        before = _families(metrics.collect_families, fams)
        outs, snaps = _workload(eng)
        after = _families(metrics.collect_families, fams)
        ids = range(len(outs))
        runs.append(dict(
            eng=eng, inst=inst, before=before, after=after, outs=outs,
            snaps=snaps, ring=_ring(eng), stats=eng.stats(),
            dump_keys=set(eng.debug_dump()),
            timelines=[eng.request_timeline(i) for i in ids]))
    jx, pt = runs
    assert pt["outs"] == jx["outs"]
    st = pt["stats"]
    assert st["preemptions_total"] >= 1 and st["kv_promoted_blocks"] >= 1
    assert st["prefix_hit_tokens"] > 0 and st["spec_steps"] > 0
    assert st["cancelled_total"] == 1 and st["structured_running"] == 0
    assert set(st) == set(jx["stats"])
    assert pt["dump_keys"] - jx["dump_keys"] == {"export_syncs"}
    assert jx["dump_keys"] <= pt["dump_keys"]

    # every metric: name, kind, description, tag keys, buckets
    assert set(pt["inst"]) == set(jx["inst"])
    for name in jx["inst"]:
        assert _schema(pt["inst"][name]) == _schema(jx["inst"][name]), name
    assert set(pt["after"]) == set(jx["after"])
    for fam, body in jx["after"].items():
        assert pt["after"][fam]["__type__"] == body["__type__"], fam
        if body["__type__"] == "counter":
            assert (_moved(pt["before"], pt["after"], fam, "_total")
                    == _moved(jx["before"], jx["after"], fam, "_total")), fam
        elif body["__type__"] == "histogram":
            suffix = ("_bucket" if fam == "llm_structured_masked_fraction"
                      else "_count")
            got = _moved(pt["before"], pt["after"], fam, suffix)
            want = _moved(jx["before"], jx["after"], fam, suffix)
            assert got == want, fam
    # a gauge holds no delta; the engine's goodput and MFU kinds agree
    assert set(pt["stats"]["goodput"]) == set(jx["stats"]["goodput"]) == {
        "prefill", "prefill_chunk", "decode", "verify"}
    moved = _moved(pt["before"], pt["after"], "llm_engine_tokens_generated",
                   "_total")
    assert sum(moved.values()) == sum(
        len(o) for o in pt["outs"] if isinstance(o, list))

    # timelines: event names in order, and the terminal reason
    for mine, ref in zip(pt["timelines"], jx["timelines"]):
        assert mine["finish_reason"] == ref["finish_reason"]
        assert ([e["event"] for e in mine["events"]]
                == [e["event"] for e in ref["events"]])
    parked = pt["timelines"][3]["events"]
    assert [e["event"] for e in parked].count("preempted") >= 1
    assert pt["timelines"][2]["finish_reason"] == "cancelled"

    # the flight ring, in order, without its times
    assert len(pt["ring"]) == len(jx["ring"]) > 0
    for i, (mine, ref) in enumerate(zip(pt["ring"], jx["ring"])):
        assert mine == ref, (i, mine, ref)
    kinds = {r["kind"] for r in pt["ring"]}
    assert {"prefill", "prefill_chunk", "decode", "verify", "compile",
            "autoscale_snapshot"} <= kinds

    # the snapshots' non-time keys
    assert len(pt["snaps"]) == len(jx["snaps"]) == 2
    for mine, ref in zip(pt["snaps"], jx["snaps"]):
        strip = (lambda d: {k: v for k, v in d.items()
                            if k not in TIME_KEYS})
        assert strip(mine) == strip(ref)
    assert pt["snaps"][0]["preempted_streams"] == 1
    assert set(pt["snaps"][0]["queue_depth_by_class"]) == {
        "batch", "default", "interactive"}
    for eng in (jx["eng"], pt["eng"]):
        eng.shutdown()


@pytest.mark.timeout(60)
def test_ring_timeline_history_and_dump_dir_are_bounded(tmp_path,
                                                        monkeypatch):
    from ray_tpu_torch.serve.llm import obs

    eng = _port_engine(flight_recorder_steps=8, timeline_history=2)
    streams = [eng.submit([1 + i, 2, 3], max_new_tokens=6)
               for i in range(3)]
    _drain(eng)
    assert all(len(list(s)) == 6 for s in streams)
    dump = eng.debug_dump()
    assert dump["reason"] == "debug" and dump["capacity"] == 8
    assert len(dump["steps"]) == 8 and dump["steps_total"] > 8
    nums = [r["step"] for r in dump["steps"]]
    assert nums == list(range(dump["steps_total"] - 7,
                              dump["steps_total"] + 1))
    for r in dump["steps"]:
        if r["kind"] != "compile":
            for key in ("kind", "ts", "dur_ms", "admitted", "expired", "cow",
                        "evicted_blocks", "kv_util", "waiting", "running"):
                assert key in r, (key, r)
    assert dump["stats"]["failed"] is False and dump["event_stats"]
    # two finished timelines kept, the oldest gone
    assert eng.request_timeline(0) is None
    assert [eng.request_timeline(i)["finish_reason"] for i in (1, 2)] == [
        "finished", "finished"]
    eng.shutdown()

    monkeypatch.setenv(obs.FLIGHT_KEEP_ENV, "3")
    paths = []
    for i in range(6):
        paths.append(obs.write_dump({"reason": f"death-{i}",
                                     "n": np.int64(i)}, dir=str(tmp_path)))
        time.sleep(0.002)  # distinct names, strict mtime order
    survivors = sorted(glob.glob(str(tmp_path / "llm_flight_*.json")))
    assert survivors == sorted(paths[-3:])
    assert json.loads(open(survivors[0]).read()) == {"reason": "death-3",
                                                     "n": 3}
    monkeypatch.setenv(obs.FLIGHT_KEEP_ENV, "0")
    for i in range(5):
        obs.write_dump({"reason": f"nocap-{i}"}, dir=str(tmp_path))
        time.sleep(0.002)
    assert len(glob.glob(str(tmp_path / "llm_flight_*.json"))) == 8
    # a tensor is written as its metadata, never read
    path = obs.write_dump({"t": torch.zeros(2, 3)}, path=str(
        tmp_path / "t.json"))
    assert json.load(open(path))["t"].startswith("<tensor (2, 3)")


@pytest.fixture
def plan():
    from ray_tpu_torch._private import chaos

    yield chaos.install
    chaos.clear()


def _pool_whole(eng) -> bool:
    c = eng.cache
    return (c.available_blocks == c.cfg.usable_blocks
            and c.reserved_blocks == 0)


@pytest.mark.timeout(60)
def test_engine_death_writes_one_dump_and_fails_every_stream(plan,
                                                              tmp_path):
    from ray_tpu_torch._private.chaos import Fault, FaultPlan
    from ray_tpu_torch.serve.llm import EngineDiedError

    plan(FaultPlan(faults=(
        Fault(point="engine.decode", action="raise", after=10, times=1),)))
    eng = _port_engine(auto_step=True, flight_recorder_dir=str(tmp_path))
    with eng._lock:  # every stream queued before the first step
        streams = [eng.submit([1 + i, 2, 3], max_new_tokens=40)
                   for i in range(3)]
    for s in streams:
        with pytest.raises(EngineDiedError):
            list(s)
    files = glob.glob(str(tmp_path / "llm_flight_*.json"))
    assert len(files) == 1, files
    dump = json.loads(open(files[0]).read())
    assert dump["reason"] == "engine_died"
    assert dump["stats"]["failed"] is True and dump["cache"]
    assert sum(r["kind"] == "decode" for r in dump["steps"]) == 9
    for s in streams:
        assert eng.request_timeline(s.request_id)["finish_reason"] == "failed"
    assert _pool_whole(eng)
    with pytest.raises(EngineDiedError):
        eng.submit([1, 2], max_new_tokens=2)
    eng.shutdown(dump=True)  # one post-mortem an engine
    assert len(glob.glob(str(tmp_path / "llm_flight_*.json"))) == 2


@pytest.mark.timeout(60)
def test_watchdog_fails_streams_with_a_lock_free_dump(plan, tmp_path):
    """A 3 s delay at the 4th decode step: the watchdog (1 s) fails
    every stream and writes its dump while the wedged stepper still holds
    the lock; the stepper, once awake, dispatches nothing more and gives
    the pool back."""
    from ray_tpu_torch._private.chaos import Fault, FaultPlan
    from ray_tpu_torch.serve.llm import EngineDiedError, obs

    # the process's first model steps are slow on the CPU: run them first
    # (on an engine without a watchdog), so only the fault can wedge
    warm = _port_engine()
    for i in range(3):
        warm.generate([1 + i, 2, 3], max_new_tokens=4)
    plan(FaultPlan(faults=(
        Fault(point="engine.decode", action="delay", arg=3.0, after=4,
              times=1),)))
    eng = _port_engine(auto_step=True, step_timeout_s=1.0,
                       flight_recorder_dir=str(tmp_path))
    with eng._lock:  # every stream queued before the first step
        streams = [eng.submit([1 + i, 2, 3], max_new_tokens=40)
                   for i in range(3)]
    for s in streams:
        with pytest.raises(EngineDiedError, match="wedged"):
            list(s)
    failed_at = time.monotonic()
    begin = eng._step_begin
    assert begin is not None, "the streams failed after the wedged step"
    wedged_for = obs.clock() - begin  # the engine's clock
    held = not eng._lock.acquire(blocking=False)
    if not held:
        eng._lock.release()
    files = glob.glob(str(tmp_path / "llm_flight_*.json"))
    assert held and wedged_for < 2.5, wedged_for  # still in the delay
    assert len(files) == 1
    dump = json.loads(open(files[0]).read())
    assert dump["reason"] == "watchdog_timeout"
    assert dump["steps"] and "stats" not in dump and "cache" not in dump
    steps = eng.num_decode_steps
    eng._thread.join(timeout=10)
    assert time.monotonic() - failed_at < 10
    assert eng.num_decode_steps == steps == 3
    assert _pool_whole(eng)
    eng.shutdown()


@pytest.mark.timeout(60)
def test_shutdown_dump_to_explicit_path(tmp_path):
    eng = _port_engine()
    assert len(eng.generate([1, 2, 3], max_new_tokens=2)) == 2
    path = str(tmp_path / "final.json")
    eng.shutdown(dump=path)
    dump = json.loads(open(path).read())
    assert dump["reason"] == "shutdown" and dump["steps_total"] >= 1
    assert dump["stats"]["executor"]["executor"] == "single"


@pytest.mark.timeout(60)
def test_traced_request_emits_engine_spans():
    from ray_tpu_torch.util import tracing

    tracing.drain_buffered_spans()
    eng = _port_engine()
    with tracing.span("client") as ctx:
        s = eng.submit([1, 2, 3, 4, 5], max_new_tokens=4)
    _drain(eng)
    assert len(list(s)) == 4
    spans = tracing.drain_buffered_spans()
    by = {sp["name"]: sp for sp in spans}
    root = by["engine.request"]
    assert root["trace_id"] == ctx["trace_id"]
    assert root["parent_span_id"] == ctx["span_id"]
    for name in ("engine.queued", "engine.prefill", "engine.first_token",
                 "engine.decode"):
        assert by[name]["parent_span_id"] == root["span_id"], name
    assert root["attrs"]["finish_reason"] == "finished"
    events = tracing.spans_to_chrome(spans)
    assert {e["name"] for e in events} == set(by)
    eng.shutdown()


def test_registry_matches_prometheus_client():
    """The port's registry gives what prometheus_client gives for the same
    instruments and observations: families, types, help, sample names,
    labels and values (``_created`` aside); and the same errors."""
    import prometheus_client as prom

    from ray_tpu_torch.util import metrics

    reg = prom.CollectorRegistry()
    tag = f"obs_{os.getpid()}_{threading.get_ident()}"
    specs = [("c_total", "counter", (), ()), ("cl", "counter", ("shape",), ()),
             ("h", "histogram", (), (0.005, 1.0, 2.5, 1e7)),
             ("hl", "histogram", ("kind",), (0.001, 1)),
             ("hd", "histogram", (), ()), ("g", "gauge", (), ()),
             ("gl", "gauge", ("kind",), ())]
    ref, mine = {}, {}
    for name, kind, tags, bounds in specs:
        n = f"{tag}_{name}"
        if kind == "counter":
            ref[name] = prom.Counter(n, "help " + name, labelnames=tags,
                                     registry=reg)
            mine[name] = metrics.counter(n, "help " + name, tags)
        elif kind == "gauge":
            ref[name] = prom.Gauge(n, "g", labelnames=tags, registry=reg)
            mine[name] = metrics.gauge(n, "g", tags)
        else:
            extra = {"buckets": bounds} if bounds else {}
            ref[name] = prom.Histogram(n, "h", labelnames=tags, registry=reg,
                                       **extra)
            mine[name] = metrics.histogram(n, "h", boundaries=bounds,
                                           tag_keys=tags)
    ref["c_total"].inc(3)
    mine["c_total"].inc(3)
    ref["cl"].labels("a").inc(2)
    mine["cl"].inc(2, tags={"shape": "a"})
    for v in (0.3, 5.0, 2e7, 0.005):
        ref["h"].observe(v)
        mine["h"].observe(v)
    ref["hl"].labels("x").observe(0.5)
    mine["hl"].observe(0.5, tags={"kind": "x"})
    ref["hd"].observe(0.07)
    mine["hd"].observe(0.07)
    ref["gl"].labels("k").set(1.5)
    mine["gl"].set(1.5, tags={"kind": "k"})
    want = {}
    for fam in reg.collect():
        want[fam.name] = {
            "type": fam.type, "help": fam.documentation,
            "samples": [{"name": s.name, "labels": dict(s.labels),
                         "value": float(s.value)}
                        for s in fam.samples
                        if not s.name.endswith("_created")]}
    assert metrics.collect_families(tag) == want
    keys = {metrics.sample_key(s.name, s.labels)
            for fam in reg.collect() for s in fam.samples}
    assert set(metrics.collect(tag)) == keys
    text = metrics.render_prometheus(metrics.collect_families(tag))
    assert f'{tag}_hl_bucket{{kind="x",le="+Inf"}} 1' in text
    server, port = metrics.start_metrics_server(0, "127.0.0.1")
    try:
        import urllib.request

        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10) as resp:
            body = resp.read().decode()
    finally:
        server.shutdown()
        server.server_close()
    assert f'{tag}_cl_total{{shape="a"}} 2' in body
    with pytest.raises(ValueError, match="Duplicated"):
        metrics.Counter(f"{tag}_c", "again")
    with pytest.raises(ValueError, match="non-negative"):
        mine["c_total"].inc(-1)
    with pytest.raises(ValueError, match="boundaries"):
        metrics.histogram(f"{tag}_h", "h", boundaries=(1.0, 2.0))
    with pytest.raises(ValueError, match="tag_keys"):
        metrics.counter(f"{tag}_cl", "x", ("other",))
    with pytest.raises(TypeError, match="already registered"):
        metrics.gauge(f"{tag}_c_total")
