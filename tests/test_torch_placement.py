"""The port's placement groups, state API and trace read-back
(``ray_tpu_torch.util.placement_group`` / ``state`` / ``tracing``)
against the JAX package's, one cluster per package for the module.

One driver program (``_program``) runs on both packages, GPUs on the
port where the JAX package has TPUs (``{"CPU": 1, "GPU": 1}`` against
``{"CPU": 1, "TPU": 1}``), and its records must be equal once ids, times
and the accelerator's name are normalized: PACK, STRICT_PACK and
STRICT_SPREAD groups on one node (ready, their bundles, the resources
they hold and give back on ``remove_placement_group``); STRICT_SPREAD of
two bundles on one node not ready within 1 s; an actor in bundle 0 and a
task in bundle 1, each with its card (``CUDA_VISIBLE_DEVICES`` as the JAX
package's ``TPU_VISIBLE_CHIPS``); ``list_actors``, ``list_tasks``,
``summarize_tasks``, ``timeline``, ``summary``; ``get_trace`` and
``trace_to_chrome`` of a traced task. Then the port's own refusals: an
unknown strategy, a fractional card in a bundle."""
from __future__ import annotations

import contextlib
import gc
import importlib
import pickle
import time

import pytest

# the GCS's view of free resources follows the raylet's heartbeat: a short
# one keeps the waits for a reservation's hold and return short
SYSTEM = {"gcs_heartbeat_interval_ms": 100}
ACC = {"ray_tpu": ("TPU", "TPU_VISIBLE_CHIPS", "num_tpus"),
       "ray_tpu_torch": ("GPU", "CUDA_VISIBLE_DEVICES", "num_gpus")}


@pytest.fixture(scope="module")
def torch_rt():
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4, num_gpus=2, _system_config=SYSTEM)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def jax_rt():
    pytest.importorskip("jax")
    import ray_tpu

    if ray_tpu.is_initialized():  # left by a file run before in this process
        ray_tpu.shutdown()
    with _collector_off():
        ray_tpu.init(num_cpus=4, num_tpus=2, _system_config=SYSTEM)
    yield ray_tpu
    with _collector_off():
        ray_tpu.shutdown()


@contextlib.contextmanager
def _collector_off():
    """For calls into the JAX package's cluster: its RpcClient guards
    call_async with a plain Lock that an ObjectRef's __del__ re-enters
    when the collector runs inside it (``tests/test_torch_core.py``)."""
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.collect()


def _norm(res: dict, acc: str) -> dict:
    """A resource dict with the accelerator named ACC."""
    return {("ACC" if k == acc else k): v for k, v in res.items()}


def _wait(pred, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def _program(rt):
    """One driver program; -> its records (no ids, times or names of the
    accelerator)."""
    pkg = rt.__name__
    acc, env, opt = ACC[pkg]
    pgs = importlib.import_module(pkg + ".util.placement_group")
    state = importlib.import_module(pkg + ".util.state")
    tracing = importlib.import_module(pkg + ".util.tracing")
    strategies = importlib.import_module(pkg + ".util.scheduling_strategies")
    rec = {}
    total = state.cluster_resources()
    rec["total"] = _norm(total, acc)
    bundle = {"CPU": 1.0, acc: 1.0}

    for strategy, n in (("PACK", 2), ("STRICT_PACK", 2), ("STRICT_SPREAD", 1)):
        pg = pgs.placement_group([bundle] * n, strategy=strategy)
        ready = pg.ready(timeout=10)
        held = _wait(lambda: state.available_resources() != total)
        avail = state.available_resources()
        pgs.remove_placement_group(pg)
        back = _wait(lambda: state.available_resources() == total)
        rec[strategy] = (ready, pg.wait(1), [_norm(b, acc) for b in
                                             pg.bundle_specs],
                         held, _norm(avail, acc), back)
    pg = pgs.placement_group([bundle] * 2, strategy="STRICT_SPREAD")
    rec["strict_spread_one_node"] = pg.ready(timeout=1.0)
    pgs.remove_placement_group(pg)
    with pytest.raises(ValueError) as e:
        pgs.placement_group([bundle], strategy="NEAREST")
    rec["bad_strategy"] = str(e.value)

    # an actor in bundle 0 holds one card, a task in bundle 1 gets the other
    pg = pgs.placement_group([bundle] * 2, strategy="PACK")
    assert pg.ready(timeout=10)
    pg2 = pickle.loads(pickle.dumps(pg))
    rec["pickled"] = (pg2.id == pg.id, pg2.bundles == pg.bundles,
                      pg2.strategy)

    @rt.remote
    class Holder:
        def visible(self):
            import os

            return os.environ.get(env)

    def in_bundle(i):
        return strategies.PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=i)

    @rt.remote
    def visible():
        import os

        return os.environ.get(env)

    holder = Holder.options(num_cpus=0, **{opt: 1},
                            scheduling_strategy=in_bundle(0)).remote()
    rec["actor_slot"] = rt.get(holder.visible.remote(), timeout=60)
    rec["task_slot"] = rt.get(visible.options(
        num_cpus=0, **{opt: 1}, scheduling_strategy=in_bundle(1)).remote(),
        timeout=60)
    rt.kill(holder)
    pgs.remove_placement_group(pg)
    rec["back_after_remove"] = _wait(
        lambda: state.available_resources() == total)
    _wait(lambda: all(a["state"] == "DEAD" for a in state.list_actors()
                      if a.get("class_name") == "Holder"))
    rec["actors"] = sorted((a.get("class_name"), a["state"])
                           for a in state.list_actors()
                           if a.get("class_name") == "Holder")

    # tasks: a traced one under a driver span, read back by its trace id
    @rt.remote
    def traced(x):
        return x + 1

    with tracing.span("root", user="u") as ctx:
        rec["traced"] = rt.get(traced.remote(1), timeout=60)
    tid = ctx["trace_id"]
    _wait(lambda: len(tracing.get_trace(tid)) >= 2)
    spans = tracing.get_trace(tid)
    names = {s["span_id"]: s["name"] for s in spans}
    rec["trace"] = sorted(
        (s["name"], s["type"], names.get(s["parent_span_id"]),
         sorted(s["attrs"])) for s in spans)
    rec["trace_chrome"] = sorted((e["name"], e["cat"], e["ph"],
                                  sorted(e["args"]))
                                 for e in tracing.trace_to_chrome(tid))
    # (the killed actor's method is left out: whether its worker flushed
    # its events before the kill is a race in either package)
    mine = ("visible", "traced")

    def settled():
        rows = [t for t in state.list_tasks() if t["name"] in mine]
        return len(rows) == 2 and all(t["state"] == "FINISHED" for t in rows)

    _wait(settled)
    rec["tasks"] = sorted((t["name"], t["type"], t["state"],
                           t["started_at"] is not None)
                          for t in state.list_tasks() if t["name"] in mine)
    summ = state.summarize_tasks()
    rec["summary_tasks"] = {n: (summ[n]["states"], summ[n]["count"])
                            for n in mine if n in summ}
    rec["timeline"] = sorted((e["name"], e["cat"], e["ph"])
                             for e in state.timeline()
                             if e["name"] in mine)
    s = state.summary()
    rec["summary"] = (s["nodes"], _norm(s["resources"]["total"], acc),
                      _norm(s["resources"]["available"], acc))
    rec["nodes"] = [(n["alive"], _norm(n["resources"], acc))
                    for n in state.list_nodes()]
    rec["debug_state"] = state.debug_state().splitlines()[0]
    rec["event_stats"] = type(state.event_stats()).__name__
    return rec


@pytest.mark.timeout(120)
def test_program_records_equal_jax(torch_rt, jax_rt):
    with _collector_off():
        want = _program(jax_rt)
    got = _program(torch_rt)
    assert got == want
    # and the records say what they should
    assert got["PACK"][0] and got["STRICT_PACK"][0] and got["STRICT_SPREAD"][0]
    assert got["PACK"][3] and got["PACK"][5]
    assert got["PACK"][4]["ACC"] == got["total"]["ACC"] - 2
    assert got["strict_spread_one_node"] is False
    assert (got["actor_slot"], got["task_slot"]) == ("0", "1")
    assert got["back_after_remove"]
    assert got["actors"] == [("Holder", "DEAD")]
    assert ("traced", "task", "root", ["task_id"]) in got["trace"]
    assert ("root", "span", None, ["user"]) in got["trace"]


def test_group_asked_for_within_a_heartbeat_of_a_release(torch_rt):
    """The GCS places a group on its view of free resources, which the
    raylet's next heartbeat refreshes: a group asked for right after
    another gave the cards back finds them taken there, is left
    PENDING, and ``ready`` asks for it again until it is placed (a gang
    restarting on the cards its last attempt held)."""
    from ray_tpu_torch.util import state
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    remove_placement_group)

    total = state.cluster_resources()
    both = [{"CPU": 1.0, "GPU": 1.0}] * int(total["GPU"])
    first = placement_group(both, strategy="PACK")
    assert first.ready(timeout=10)
    assert _wait(lambda: state.available_resources()["GPU"] == 0)
    remove_placement_group(first)
    again = placement_group(both, strategy="PACK")
    assert again.ready(timeout=10)
    remove_placement_group(again)
    assert _wait(lambda: state.available_resources() == total)


def test_fractional_card_in_a_bundle_is_refused(torch_rt):
    from ray_tpu_torch.util.placement_group import placement_group

    with pytest.raises(ValueError, match="whole number of GPUs"):
        placement_group([{"CPU": 1, "GPU": 0.5}])


def test_exports():
    import ray_tpu_torch.exceptions as tex
    import ray_tpu_torch.util.state as tstate
    import ray_tpu_torch.util.tracing as ttracing
    import ray_tpu.util.state as jstate
    import ray_tpu.util.tracing as jtracing

    assert issubclass(tex.PlacementGroupUnavailableError, tex.RayTpuError)
    public = {n for n in dir(jstate) if not n.startswith("_")
              and callable(getattr(jstate, n))
              and getattr(getattr(jstate, n), "__module__", "") == jstate.__name__}
    assert public <= set(dir(tstate))
    assert {"get_trace", "trace_to_chrome", "spans_to_chrome"} <= set(
        dir(ttracing)) & set(dir(jtracing))
