"""The port's Serve (``ray_tpu_torch.serve``: controller, router, replicas,
the standard-library HTTP proxy, the LLM deployment) against the JAX
package's, one cluster per package for the whole module, every port
ephemeral.

One driver program (``_program``) runs on both packages and its records
must be equal: handle results of a function deployment, a class
deployment with ``@serve.batch`` and a streaming generator deployment;
HTTP statuses, headers (``Date`` and ``Server`` masked) and bodies,
byte for byte, chunk framing included, for JSON, server-sent events and
raw chunks, 404s, ``/healthz``, ``/debug/llm``, and errors mapped to
503 (with each class's ``Retry-After``), 504 and 400; and ``status()``.

Then the slice as a whole, on the port: a tiny f32 Llama app
(``build_llm_app``, ``device="cpu"``, ``num_gpus=1`` on a node of two
fake GPU slots) on weights converted from the JAX engine's seeded init
streams, through the handle (``stream_tokens``) and over HTTP, what the
in-process JAX engine streams, greedy and sampled; it does so again when
its replica is killed mid-stream (the streams resume on the replica the
controller starts in its place), and when the controller is killed (the
restarted controller adopts the replica); a two-replica app drains one
replica on scale-down and loses no stream. Streams are held mid-flight by
a chaos plan exported to the workers through ``RAY_TPU_CHAOS_PLAN``: a
delay after each chunk of a request tagged ``slow``. The teardown leaves
no replica, controller, store process or ``rtt_store_`` segment."""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import signal
import socket
import threading
import time

import numpy as np
import pytest

SLOW_TAG = "slow"
SLOW_DELAY_S = 0.1  # after each chunk of a tagged request, in the replica
BUCKETS = dict(block_size=8, num_blocks=64, max_batch_size=4,
               batch_buckets=(4,), length_buckets=(32,))
NEW_TOKENS = 8
SEED = 5


@pytest.fixture(scope="module")
def torch_serve():
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch._private import chaos

    prev = os.environ.get(chaos.ENV_VAR)
    # exported before the workers spawn, so every replica reads it
    os.environ[chaos.ENV_VAR] = chaos.FaultPlan(faults=(chaos.Fault(
        point="llm.token", action="delay", when={"tag": SLOW_TAG},
        times=None, arg=SLOW_DELAY_S),)).to_json()
    node = ray_tpu_torch.init(num_cpus=8, num_gpus=2)
    serve.start(http_options={"port": 0})
    yield ray_tpu_torch, serve, node
    if ray_tpu_torch.is_initialized():  # the last test shuts down itself
        serve.shutdown()
        ray_tpu_torch.shutdown()
    if prev is None:
        os.environ.pop(chaos.ENV_VAR, None)
    else:
        os.environ[chaos.ENV_VAR] = prev
    chaos.clear()  # this process read the plan at its first fire


@pytest.fixture(scope="module")
def jax_serve():
    pytest.importorskip("jax")
    import ray_tpu
    from ray_tpu import serve

    if ray_tpu.is_initialized():  # left by a file run before in this process
        ray_tpu.shutdown()
    with _collector_off():
        ray_tpu.init(num_cpus=8)
        serve.start(http_options={"port": 0})
    yield ray_tpu, serve
    with _collector_off():
        serve.shutdown()
        ray_tpu.shutdown()


@contextlib.contextmanager
def _collector_off():
    """For calls into the JAX package's cluster: its RpcClient guards
    call_async with a plain Lock that an ObjectRef's __del__ re-enters
    when the collector runs inside it (``tests/test_torch_core.py``).
    The collector is held off and runs after, with no lock held."""
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.collect()


def _http(port, method, path, body=None, headers=()):
    """One request on a fresh connection (``Connection: close``); -> the
    status line, the headers (lower-cased names; ``Date``, ``Server`` and
    the connection's own masked) and the raw body, chunk framing
    included."""
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        head = [f"{method} {path} HTTP/1.1", f"Host: 127.0.0.1:{port}",
                "Connection: close", *(f"{k}: {v}" for k, v in headers)]
        data = b""
        if body is not None:
            data = body if isinstance(body, bytes) else json.dumps(
                body).encode()
            head += ["Content-Type: application/json",
                     f"Content-Length: {len(data)}"]
        s.sendall(("\r\n".join(head) + "\r\n\r\n").encode() + data)
        raw = b""
        while True:
            got = s.recv(1 << 16)
            if not got:
                break
            raw += got
    top, _, rest = raw.partition(b"\r\n\r\n")
    lines = top.decode().split("\r\n")
    hdrs = {}
    for line in lines[1:]:
        k, v = line.split(":", 1)
        if k.lower() not in ("date", "server", "connection", "keep-alive"):
            hdrs[k.lower()] = v.strip()
    return lines[0], hdrs, rest


def _dechunk(body: bytes) -> list[bytes]:
    """The chunks of a chunked body, in order (the last, empty, dropped)."""
    out = []
    while True:
        size, _, body = body.partition(b"\r\n")
        n = int(size, 16)
        if n == 0:
            return out
        out.append(body[:n])
        body = body[n + 2:]


def _program(rt, serve, exc):
    """One driver program; -> its records (no ids, no times)."""
    port = serve.api._proxy.port
    rec = {}

    @serve.deployment
    def echo(x):
        return {"echo": x}

    @serve.deployment(max_ongoing_requests=8)
    class Doubler:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
        def __call__(self, xs):
            return [x * 2 for x in xs]

    @serve.deployment
    class Tokens:
        def __call__(self, p):
            if p.get("overload"):
                raise exc.EngineOverloadedError("no room in the fleet")
            for i in range(p["n"]):
                yield {"i": i, "text": f"t{i}"}

    @serve.deployment
    class Faulty:
        def __call__(self, p):
            kind = p["kind"]
            if kind == "overload":
                raise exc.EngineOverloadedError("engine queue full")
            if kind == "deadline":
                raise exc.DeadlineExceededError("deadline passed")
            if kind == "bad":
                raise ValueError("bad request body")
            return "ok"

    h_echo = serve.run(echo.bind(), name="echo", route_prefix="/echo",
                       timeout_s=120)
    h_dbl = serve.run(Doubler.bind(), name="dbl", route_prefix="/dbl",
                      timeout_s=120)
    h_tok = serve.run(Tokens.bind(), name="tok", route_prefix="/tok",
                      timeout_s=120)
    serve.run(Faulty.bind(), name="faulty", route_prefix="/faulty",
              timeout_s=120)
    rec["handle"] = (h_echo.remote({"a": 1}).result(),
                     h_echo.remote([1, "b"]).result(),
                     [r.result() for r in [h_dbl.remote(i)
                                           for i in range(10)]],
                     list(h_tok.remote({"n": 4})),
                     sorted(h_tok.stream_methods()))
    sse = [("Accept", "text/event-stream")]
    rec["http"] = {
        "json": _http(port, "POST", "/echo", {"k": [1, 2]}),
        "query": _http(port, "GET", "/echo/sub?x=1&y=&x=2"),
        "text": _http(port, "POST", "/echo", b"not json"),
        "batched": _http(port, "POST", "/dbl", 21),
        "missing": _http(port, "GET", "/nowhere"),
        "healthz": _http(port, "GET", "/healthz"),
        "sse": _http(port, "POST", "/tok", {"n": 3}, sse),
        "raw": _http(port, "POST", "/tok", {"n": 3}),
        "empty": _http(port, "POST", "/tok", {"n": 0}),
        "stream_overload": _http(port, "POST", "/tok",
                                 {"n": 3, "overload": True},
                                 [("x-ray-tpu-priority", "interactive")]),
        "overload": _http(port, "POST", "/faulty", {"kind": "overload"}),
        "overload_batch": _http(port, "POST", "/faulty",
                                {"kind": "overload", "priority": "batch"}),
        "deadline": _http(port, "POST", "/faulty", {"kind": "deadline"}),
        "bad": _http(port, "POST", "/faulty", {"kind": "bad"}),
        "debug_unknown": _http(port, "GET", "/debug/llm?app=nope"),
        "debug_echo": _http(port, "GET", "/debug/llm?app=echo"),
    }
    rec["chunks"] = {k: _dechunk(rec["http"][k][2])
                     for k in ("sse", "raw", "empty")}
    st = serve.status()
    ctl = st.pop("_controller")
    rec["status"] = (st, sorted(ctl), ctl["restarts"],
                     ctl["checkpoint_version"])
    for app in ("echo", "dbl", "tok", "faulty"):
        serve.delete(app)
    rec["after_delete"] = serve.status()["_controller"]["restarts"]
    rec["healthz_after"] = _http(port, "GET", "/healthz")
    return rec


@pytest.mark.timeout(120)
def test_one_program_equal_records(torch_serve, jax_serve):
    from ray_tpu_torch import exceptions as texc

    from ray_tpu import exceptions as jexc

    rt, serve, _ = torch_serve
    mine = _program(rt, serve, texc)
    jrt, jserve = jax_serve
    with _collector_off():
        theirs = _program(jrt, jserve, jexc)
    assert mine == theirs
    http = mine["http"]
    assert http["overload"][0] == "HTTP/1.1 503 Service Unavailable"
    assert http["overload"][1]["retry-after"] == "2"
    assert http["overload_batch"][1]["retry-after"] == "5"
    assert http["stream_overload"][1]["retry-after"] == "1"
    assert http["deadline"][0].split()[1] == "504"
    assert http["bad"][0].split()[1] == "400"
    assert mine["chunks"]["sse"] == [
        b'data: {"i": %d, "text": "t%d"}\n\n' % (i, i) for i in range(3)]
    assert mine["chunks"]["raw"] == [
        b'{"i": %d, "text": "t%d"}\n' % (i, i) for i in range(3)]
    assert mine["handle"][2] == [2 * i for i in range(10)]


# ---------------------------------------------------------------- the LLM app


@pytest.fixture(scope="module")
def tiny_llama(jax_cpu):
    """The JAX engine's seeded weights (``jax.random.PRNGKey(SEED)``),
    converted, and its streams of the requests on them."""
    import jax
    import jax.numpy as jnp
    import torch
    from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from ray_tpu.serve.llm import EngineConfig as JaxEngineConfig
    from ray_tpu.serve.llm import LLMEngine as JaxLLMEngine

    from ray_tpu_torch.convert import llama_params_from_numpy
    from ray_tpu_torch.models.llama import LlamaConfig

    jcfg = dataclasses.replace(JaxLlamaConfig.tiny(), dtype=jnp.float32,
                               attention="xla")
    tcfg = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32)
    rng = np.random.default_rng(SEED)
    requests = [dict(prompt=rng.integers(0, 512, n).tolist(),
                     max_new_tokens=NEW_TOKENS, **kw) for n, kw in (
        (6, {}), (17, {"temperature": 0.8, "top_p": 0.9, "seed": 4}),
        (3, {"temperature": 1.1, "top_k": 30, "seed": 9}), (10, {}))]
    engine = JaxLLMEngine(
        JaxEngineConfig(model="llama", model_config=jcfg, seed=SEED,
                        prefix_caching=False, attention_backend="xla",
                        prefill_chunk_tokens=8, **BUCKETS),
        auto_step=False)
    streams = [engine.submit(r["prompt"], **{k: v for k, v in r.items()
                                             if k != "prompt"})
               for r in requests]
    while engine.step():
        pass
    want = [list(s) for s in streams]
    params = llama_params_from_numpy(
        jax.tree.map(np.asarray, engine.params), tcfg)
    engine.shutdown()
    assert all(len(s) == NEW_TOKENS for s in want)
    return tcfg, params, requests, want


def _engine_config(tcfg):
    from ray_tpu_torch.serve.llm import EngineConfig

    return EngineConfig(model="llama", model_config=tcfg, device="cpu",
                        prefill_chunk_tokens=8, prefix_caching=False,
                        **BUCKETS)


def _alive(rt, node, class_name) -> dict:
    """actor id -> worker pid of the live actors of ``class_name``."""
    actors = rt.worker.global_worker().gcs.call("list_actors")["actors"]
    ids = {a["actor_id"] for a in actors if a.get("class_name") == class_name
           and a.get("state") != "DEAD"}
    return {w.actor_id: w.proc.pid for w in node.raylet._all_workers.values()
            if w.actor_id in ids and w.proc is not None}


def _wait(pred, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.1)
    return False


def _streams(handle, requests, tag=None, on_chunk=None):
    """Every request through ``stream_tokens`` at once, one thread each;
    -> (tokens, chunk indices, serving replica ids) per request."""
    from ray_tpu_torch.serve.llm import stream_tokens

    out = [None] * len(requests)

    def run(i):
        p = dict(requests[i], **({"chaos_tag": tag} if tag else {}))
        gen = stream_tokens(handle, p)
        toks, idx, replicas = [], [], set()
        for c in gen:
            toks.append(c["token"])
            idx.append(c["index"])
            replicas.add(gen._inner.replica_actor_id)
            if on_chunk is not None:
                on_chunk(i, len(toks))
        out[i] = (toks, idx, replicas)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert all(o is not None for o in out)
    return out


def _sse_tokens(port, payload):
    status, hdrs, body = _http(port, "POST", "/llm", payload,
                               [("Accept", "text/event-stream")])
    assert status == "HTTP/1.1 200 OK", (status, body)
    assert hdrs["content-type"] == "text/event-stream"
    chunks = []
    for c in _dechunk(body):
        assert c.startswith(b"data: ") and c.endswith(b"\n\n")
        chunks.append(json.loads(c[6:-2]))
    assert [c["index"] for c in chunks] == list(range(len(chunks)))
    return [c["token"] for c in chunks]


@pytest.mark.timeout(150)
def test_tiny_llama_app_streams_equal_jax_engine(torch_serve, tiny_llama):
    from ray_tpu_torch.serve.llm import build_llm_app

    rt, serve, node = torch_serve
    tcfg, params, requests, want = tiny_llama
    app = build_llm_app(_engine_config(tcfg), params=rt.put(params),
                        num_replicas=1, ray_actor_options={"num_gpus": 1})
    handle = serve.run(app, name="llm", route_prefix="/llm", timeout_s=120)
    got = _streams(handle, requests)
    assert [g[0] for g in got] == want
    assert all(g[1] == list(range(NEW_TOKENS)) for g in got)
    port = serve.api._proxy.port
    assert [_sse_tokens(port, r) for r in requests] == want
    dump = _http(port, "GET", "/debug/llm?app=llm")
    replicas = json.loads(dump[2])["replicas"]
    assert len(replicas) == 1
    rep = replicas[0]
    assert rep["stats"]["running"] == rep["stats"]["waiting"] == 0
    assert rep["stats"]["prefill_tokens_total"] == 2 * sum(
        len(r["prompt"]) for r in requests)
    cache = rep["cache"]
    assert cache["used_blocks"] == 0 and not rep["draining"]
    assert {r["kind"] for r in rep["steps"]} >= {"prefill", "decode"}
    assert len(_alive(rt, node, "ReplicaActor")) == 1


@pytest.mark.timeout(150)
def test_replica_killed_mid_stream_resumes(torch_serve, tiny_llama):
    """Each stream's replica dies after the stream has 2 tokens; every
    stream resumes (``prior_tokens``, keyed sampling) on the replica the
    controller starts in its place, to the JAX engine's tokens."""
    from ray_tpu_torch.serve import get_app_handle

    rt, serve, node = torch_serve
    _, _, requests, want = tiny_llama
    handle = get_app_handle("llm")
    (old_id, old_pid), = _alive(rt, node, "ReplicaActor").items()
    seen = [0] * len(requests)
    killed = threading.Event()

    def on_chunk(i, n):
        seen[i] = n
        if min(seen) >= 2 and not killed.is_set():
            killed.set()
            os.kill(old_pid, signal.SIGKILL)

    got = _streams(handle, requests, tag=SLOW_TAG, on_chunk=on_chunk)
    assert killed.is_set()
    assert [g[0] for g in got] == want
    assert all(g[1] == list(range(NEW_TOKENS)) for g in got)
    assert all(len(g[2]) == 2 and old_id in g[2] for g in got)
    new = _alive(rt, node, "ReplicaActor")
    assert len(new) == 1 and old_id not in new
    stats = handle.broadcast("stats")[0]
    assert stats["requests_resumed"] == len(requests)


def _loads_torch(pid) -> bool:
    with open(f"/proc/{pid}/maps") as f:
        return "libtorch" in f.read()


@pytest.mark.timeout(150)
def test_controller_killed_recovers_and_adopts(torch_serve, tiny_llama):
    """The controller's process dies while streams run; they finish from
    the routers' cached table, and the controller the raylet restarts in
    place recovers from its checkpoint and adopts the replica (same actor
    id, no second replica). Neither controller loads torch: the LLM app's
    bind arguments (its EngineConfig, its weights' ref) reach them as
    bytes."""
    from ray_tpu_torch.serve import get_app_handle

    rt, serve, node = torch_serve
    _, _, requests, want = tiny_llama
    handle = get_app_handle("llm")
    before = _alive(rt, node, "ReplicaActor")
    (ctl_id, ctl_pid), = _alive(rt, node, "ServeController").items()
    assert not _loads_torch(ctl_pid)
    killed = threading.Event()

    def on_chunk(i, n):
        if n == 1 and not killed.is_set():
            killed.set()
            os.kill(ctl_pid, signal.SIGKILL)

    got = _streams(handle, requests, tag=SLOW_TAG, on_chunk=on_chunk)
    assert killed.is_set()
    assert [g[0] for g in got] == want

    def recovered():
        try:
            st = serve.status()
        except Exception:  # noqa: BLE001 — still restarting
            return False
        return (st["_controller"]["restarts"] == 1
                and st["llm"]["LLMDeployment"]["status"] == "HEALTHY")

    assert _wait(recovered, 60)
    ctl = _alive(rt, node, "ServeController")
    assert list(ctl) == [ctl_id] and ctl[ctl_id] != ctl_pid
    assert _alive(rt, node, "ReplicaActor") == before
    assert not _loads_torch(ctl[ctl_id])
    # and the adopted replica serves
    assert [g[0] for g in _streams(handle, requests[:2])] == want[:2]


@pytest.mark.timeout(150)
def test_two_replicas_drain_one_on_scale_down(torch_serve, tiny_llama):
    """A scale-down from 2 replicas to 1 drains one replica: it stops
    admitting, its streams finish, and only then is it retired. The
    scale-down comes once every stream has its first token (a fresh
    request that raced the drain would be refused, as it should), and the
    drain's deadline is wide enough for a loaded machine (at the deadline
    the controller kills the replica and its streams fail over)."""
    from ray_tpu_torch.serve.controller import CONTROLLER_NAME
    from ray_tpu_torch.serve.llm import build_llm_app

    rt, serve, node = torch_serve
    tcfg, params, requests, want = tiny_llama
    serve.delete("llm")
    app = build_llm_app(_engine_config(tcfg), params=rt.put(params),
                        num_replicas=2, ray_actor_options={"num_gpus": 1},
                        graceful_shutdown_timeout_s=60.0)
    handle = serve.run(app, name="llm2", route_prefix="/llm2",
                       timeout_s=120)
    two = _alive(rt, node, "ReplicaActor")
    assert len(two) == 2
    controller = rt.get_actor(CONTROLLER_NAME)
    scaled = threading.Event()
    reqs = requests * 2
    seen = [0] * len(reqs)

    def on_chunk(i, n):
        seen[i] = n
        if min(seen) >= 1 and not scaled.is_set():
            scaled.set()
            assert rt.get(controller.scale_deployment.remote(
                "llm2", "LLMDeployment", 1), timeout=60)

    got = _streams(handle, reqs, tag=SLOW_TAG, on_chunk=on_chunk)
    assert [g[0] for g in got] == want * 2
    assert all(len(g[2]) == 1 for g in got)  # no stream moved replica

    def one_left():
        st = serve.status()["llm2"]["LLMDeployment"]
        return (st["running_replicas"], st["draining_replicas"]) == (1, 0) \
            and len(_alive(rt, node, "ReplicaActor")) == 1

    assert _wait(one_left, 60)
    (kept,) = _alive(rt, node, "ReplicaActor")
    drained = set(two) - {kept}
    served = [next(iter(g[2])) for g in got]
    assert drained & set(served)  # the drained replica had streams
    serve.delete("llm2")


@pytest.mark.timeout(60)
def test_teardown_leaves_nothing(torch_serve):
    """Runs last: shuts Serve and the cluster down itself and looks."""
    rt, serve, node = torch_serve
    store = node.store_proc
    actors = _alive(rt, node, "ReplicaActor")
    actors.update(_alive(rt, node, "ServeController"))
    serve.shutdown()
    assert _wait(lambda: not _alive(rt, node, "ServeController")
                 and not _alive(rt, node, "ReplicaActor"), 30)
    workers = [w.proc for w in node.raylet._all_workers.values()
               if w.proc is not None]
    rt.shutdown()
    assert store.poll() is not None
    assert all(p.poll() is not None for p in workers)
    assert all(not os.path.exists(f"/proc/{pid}") or
               open(f"/proc/{pid}/stat").read().rsplit(")", 1)[1].split()[0]
               == "Z" for pid in actors.values())
    assert not [n for n in os.listdir("/dev/shm")
                if n.startswith(f"rtt_store_{store.pid}_")]
