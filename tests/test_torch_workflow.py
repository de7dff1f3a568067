"""The port's ``util.actor_pool``, ``util.queue`` and ``workflow`` against
the JAX package's (the cases of ``tests/test_util_workflow.py``), one
cluster per package for the module: ``ActorPool`` ordered and unordered,
the ``Queue``'s FIFO order, limits and timeouts, and workflow run, resume
and the frontier after a failed step give equal results, in equal order,
with equal counts of the steps that ran."""
from __future__ import annotations

import contextlib
import gc
import importlib
import os

import pytest

PKGS = ("ray_tpu", "ray_tpu_torch")


@pytest.fixture(scope="module")
def torch_rt():
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def jax_rt():
    pytest.importorskip("jax")
    import ray_tpu

    if ray_tpu.is_initialized():  # left by a file run before in this process
        ray_tpu.shutdown()
    with _collector_off():
        ray_tpu.init(num_cpus=4)
    yield ray_tpu
    with _collector_off():
        ray_tpu.shutdown()


@pytest.fixture
def both(jax_rt, torch_rt):
    return {"ray_tpu": jax_rt, "ray_tpu_torch": torch_rt}


@contextlib.contextmanager
def _collector_off():
    """For calls into the JAX package's cluster (``tests/test_torch_core.py``:
    its RpcClient's plain Lock and an ObjectRef's __del__)."""
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.collect()


def _each(both, fn):
    """``fn(pkg, rt)`` for each package, the JAX one with the collector
    off; -> (JAX's, the port's)."""
    out = []
    for pkg in PKGS:
        with _collector_off() if pkg == "ray_tpu" else contextlib.nullcontext():
            out.append(fn(pkg, both[pkg]))
    return tuple(out)


def _pool(pkg):
    return importlib.import_module(pkg + ".util.actor_pool").ActorPool


def test_actor_pool_map_ordered(both):
    def run(pkg, rt):
        @rt.remote
        class Sq:
            def f(self, x):
                return x * x

        actors = [Sq.remote(), Sq.remote()]
        pool = _pool(pkg)(actors)
        out = list(pool.map(lambda a, v: a.f.remote(v), range(8)))
        out.append(pool.has_next())
        for a in actors:  # their CPUs, for the tasks of the later cases
            rt.kill(a)
        return out

    jax_out, port_out = _each(both, run)
    assert port_out == jax_out == [x * x for x in range(8)] + [False]


def test_actor_pool_unordered_returns_the_slow_one_last(both):
    def run(pkg, rt):
        @rt.remote
        class Sleepy:
            def f(self, x):
                import time

                time.sleep(1.0 if x == 0 else 0.0)
                return x

        actors = [Sleepy.remote(), Sleepy.remote()]
        pool = _pool(pkg)(actors)
        out = list(pool.map_unordered(lambda a, v: a.f.remote(v), range(4)))
        for a in actors:
            rt.kill(a)
        return out

    jax_out, port_out = _each(both, run)
    assert port_out == jax_out == [1, 2, 3, 0]


def test_actor_pool_needs_an_actor_alike(both):
    def run(pkg, rt):
        with pytest.raises(ValueError) as e:
            _pool(pkg)([])
        return str(e.value)

    jax_out, port_out = _each(both, run)
    assert port_out == jax_out


def test_queue_fifo_limits_and_timeouts(both):
    def run(pkg, rt):
        qm = importlib.import_module(pkg + ".util.queue")
        q = qm.Queue(maxsize=2, name=f"q_{pkg}")
        out = [q.empty()]
        q.put(1)
        q.put_nowait({"two": 2})
        out.append(q.qsize())
        for put in (lambda: q.put(3, block=False),
                    lambda: q.put(3, timeout=0.05)):
            with pytest.raises(qm.Full):
                put()
        out += [q.get(), q.get_nowait()]
        for get in (q.get_nowait, lambda: q.get(timeout=0.05)):
            with pytest.raises(qm.Empty):
                get()
        q.put("x")
        out += [q.get(block=False), q.empty()]
        q.shutdown()
        return out

    jax_out, port_out = _each(both, run)
    assert port_out == jax_out == [True, 2, 1, {"two": 2}, "x", True]


def _dag(pkg, marker):
    wf = importlib.import_module(pkg + ".workflow")

    @wf.step
    def load(x):
        with open(marker, "a") as f:
            f.write(f"load{x}\n")
        return x * 2

    @wf.step
    def combine(a, b, scale=1):
        with open(marker, "a") as f:
            f.write("combine\n")
        return {"sum": (a + b) * scale, "parts": [a, b]}

    return wf, combine.bind(load.bind(3), load.bind(4), scale=10)


def test_workflow_run_and_resume(both, tmp_path):
    def run(pkg, rt):
        storage = str(tmp_path / pkg)
        marker = os.path.join(storage, "runs.txt")
        os.makedirs(storage)
        wf, dag = _dag(pkg, marker)
        out = [wf.run(dag, workflow_id="wf1", storage=storage)]
        out.append(wf.resume(dag, workflow_id="wf1", storage=storage))
        out.append(wf.get_output("wf1", storage=storage))
        out.append(sorted(n for n in os.listdir(os.path.join(storage, "wf1"))))
        out.append(wf.list_workflows(storage))
        with open(marker) as f:
            out.append(f.read().split())
        out.append(wf.run(dag, workflow_id="wf1", storage=storage,
                          overwrite=True))
        with open(marker) as f:
            out.append(len(f.read().split()))
        return out

    jax_out, port_out = _each(both, run)
    assert port_out == jax_out
    assert port_out[0] == {"sum": 140, "parts": [6, 8]}
    assert port_out[5] == ["load3", "load4", "combine"]  # resume ran nothing
    assert port_out[7] == 6


def test_workflow_partial_failure_resumes_frontier(both, tmp_path):
    def run(pkg, rt):
        wf = importlib.import_module(pkg + ".workflow")
        storage = str(tmp_path / pkg)
        os.makedirs(storage)
        flag = os.path.join(storage, "fail_once")
        marker = os.path.join(storage, "runs.txt")
        open(flag, "w").close()

        @wf.step
        def first():
            with open(marker, "a") as f:
                f.write("first\n")
            return 10

        @wf.step
        def flaky(x):
            with open(marker, "a") as f:
                f.write("flaky\n")
            if os.path.exists(flag):
                os.unlink(flag)
                raise RuntimeError("transient failure")
            return x + 1

        @wf.step
        def last(x):
            with open(marker, "a") as f:
                f.write("last\n")
            return [x, x * 2]

        dag = last.bind(flaky.bind(first.bind()))
        with pytest.raises(Exception, match="transient failure"):
            wf.run(dag, workflow_id="wf2", storage=storage)
        out = [wf.list_workflows(storage)]
        with pytest.raises(ValueError, match="did not finish"):
            wf.get_output("wf2", storage=storage)
        out.append(wf.resume(dag, workflow_id="wf2", storage=storage))
        out.append(wf.list_workflows(storage))
        with open(marker) as f:
            out.append(f.read().split())
        return out

    jax_out, port_out = _each(both, run)
    assert port_out == jax_out
    assert port_out[0] == [{"workflow_id": "wf2", "status": "RUNNING"}]
    assert port_out[1] == [11, 22]
    assert port_out[3] == ["first", "flaky", "flaky", "last"]


def test_workflow_default_storage_is_the_ports_own():
    from ray_tpu_torch.workflow import api

    assert api._DEFAULT_STORAGE == os.path.expanduser(
        "~/.ray_tpu_torch_workflows")
