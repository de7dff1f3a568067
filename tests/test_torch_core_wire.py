"""The port's core against the JAX package's, piece by piece, with no
cluster: its wire (``_private/wire.py``) byte for byte ``msgpack``'s, its
IDs byte for byte ``ray_tpu._private.ids``'s, its serialized plain data
byte for byte the JAX package's (each reading the other's), functions and
classes pickled by value that a fresh interpreter runs, torch tensors
through the out-of-band path, and the scheduler's decisions equal to
``ray_tpu._private.scheduler``'s. ``msgpack``, ``cloudpickle`` and JAX are
the reference only: they are imported inside the tests."""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ray_tpu_torch._private import ids, serialization, wire

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_INT_EDGES = [2**7, 2**8, 2**15, 2**16, 2**31, 2**32, 2**63]


def _ints():
    out = [0, 1, -1, 31, 32, -32, -33, 127, -127, 2**64 - 1, -2**63]
    for e in _INT_EDGES:
        out += [e - 1, e, e + 1, -e + 1, -e, -e - 1]
    return [v for v in out if -2**63 <= v < 2**64]


def _corpus(seed):
    rng = np.random.default_rng(seed)
    lengths = (0, 31, 32, 255, 256, 65536)
    strs = ["".join(chr(c) for c in rng.integers(32, 0x2FF, n)) for n in
            lengths]
    strs += ["a" * n for n in lengths]
    blobs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
             for n in lengths]
    floats = [0.0, -0.0, 1.5, -2.25e300, float("inf"),
              *rng.standard_normal(8).tolist()]

    def nested(depth):
        if depth == 0:
            return int(rng.integers(-2**40, 2**40))
        return {f"k{i}": [nested(depth - 1), strs[i % len(strs)][:40],
                          blobs[i % 3], None, True, floats[i % 4]]
                for i in range(int(rng.integers(1, 20)))}

    return (_ints() + floats + strs + blobs
            + [None, True, False, [], {}, (), list(range(20)),
               tuple(range(70000)), {str(i): i for i in range(17)},
               nested(3), [nested(2), {"x": nested(1)}]])


@pytest.mark.timeout(60)
@pytest.mark.parametrize("seed", [0, 1])
def test_wire_is_msgpack_byte_for_byte(seed):
    msgpack = pytest.importorskip("msgpack")
    for obj in _corpus(seed):
        want = msgpack.packb(obj, use_bin_type=True)
        assert wire.packb(obj) == want, repr(obj)[:80]
        assert wire.unpackb(want) == msgpack.unpackb(want, raw=False)


@pytest.mark.timeout(60)
def test_wire_carries_the_cores_messages():
    """A task spec, a heartbeat and an RPC frame as the core sends them."""
    msgpack = pytest.importorskip("msgpack")
    from ray_tpu_torch._private import task_spec as ts

    spec = ts.make_task_spec(
        task_id=ids.TaskID(bytes(range(24))), job_id=ids.JobID(b"\1\0\0\0"),
        name="f", function_blob=b"\x80\x05blob", args=(1, "a", b"b"),
        kwargs={"k": [1.5, None]}, resources={"CPU": 1.0, "GPU": 1.0},
        num_returns=2)
    frames = [spec, [0, 7, "submit_task", {"spec": spec}],
              [1, 7, True, {"ok": True, "queued_on": "ab" * 16}],
              [2, 0, "execute_task", {"spec": spec, "gpus": [0, 1]}],
              {"node_id": b"\xff" * 16, "available": {"CPU": 3.5},
               "load": 0, "pending_shapes": [], "seen_seq": 2**33}]
    for f in frames:
        assert wire.packb(f) == msgpack.packb(f, use_bin_type=True)
        assert wire.unpackb(wire.packb(f)) == msgpack.unpackb(
            msgpack.packb(f, use_bin_type=True), raw=False)


@pytest.mark.timeout(30)
@pytest.mark.parametrize("obj", [{1, 2}, object(), np.int64(3), 2**64,
                                 -2**63 - 1, {"a": [1, complex(1, 2)]}])
def test_wire_refuses_other_types(obj):
    with pytest.raises((TypeError, OverflowError)):
        wire.packb(obj)


@pytest.mark.timeout(30)
def test_ids_byte_equal_to_jax(monkeypatch):
    pytest.importorskip("jax")
    from ray_tpu._private import ids as jids

    rng = np.random.default_rng(7)
    draws = [rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
             for _ in range(8)]

    def seeded(module):
        it = iter(draws)
        monkeypatch.setattr(module, "_random_bytes",
                            lambda n: next(it)[:n])

    out = {}
    for name, m in (("torch", ids), ("jax", jids)):
        seeded(m)
        job = m.JobID(b"\x07\0\0\0")
        actor = m.ActorID.of(job)
        task = m.TaskID.for_task(job)
        atask = m.TaskID.for_actor_task(actor)
        out[name] = [
            job.binary(), actor.binary(), actor.job_id().binary(),
            task.binary(), atask.binary(),
            m.TaskID.for_driver(job).binary(),
            m.ObjectID.for_task_return(task, 3).binary(),
            m.ObjectID.for_put(task, 5).binary(),
            m.ObjectID.for_put(task, 5).index(),
            m.ObjectID.for_put(task, 5).is_put(),
            m.ObjectID.for_task_return(atask, 2).task_id().binary(),
            m.PlacementGroupID.of(job).binary(), m.NodeID.nil().hex(),
            m.WorkerID.from_hex("ab" * 16).hex(),
            repr(m.ObjectID.for_task_return(task, 0)),
        ]
    assert out["torch"] == out["jax"]


_PLAIN = {
    "f32_small": lambda: np.arange(10, dtype=np.float32),
    "f64_large": lambda: np.linspace(0, 1, 5000),
    "i8_2d": lambda: np.arange(64 * 80, dtype=np.int8).reshape(64, 80),
    "u16_4096": lambda: np.arange(2048, dtype=np.uint16),
    "bool": lambda: np.arange(9000) % 3 == 0,
    "f16_strided": lambda: np.ones((100, 100), np.float16)[:, ::2],
    "bytes_small": lambda: b"x" * 100,
    "bytes_large": lambda: bytes(range(256)) * 40,
    "dict": lambda: {"a": [1, 2.5, "s", None, (1, 2)],
                     "b": np.zeros(3000, np.float32),
                     "c": {"nested": [np.arange(5), b"\0" * 5000]}},
}


@pytest.mark.timeout(60)
@pytest.mark.parametrize("case", sorted(_PLAIN))
def test_plain_serialize_byte_equal_to_jax(case):
    pytest.importorskip("jax")
    pytest.importorskip("cloudpickle")
    from ray_tpu._private import serialization as jser

    value = _PLAIN[case]()
    mine = b"".join(bytes(c) for c in serialization.serialize(value))
    theirs = b"".join(bytes(c) for c in jser.serialize(value))
    assert mine == theirs
    for data, load in ((theirs, serialization.deserialize),
                       (mine, jser.deserialize)):
        back = load(data)
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(back, value)
            assert back.dtype == value.dtype
        elif isinstance(value, dict):
            np.testing.assert_array_equal(back["b"], value["b"])
            assert back["a"] == value["a"]
            assert back["c"]["nested"][1] == value["c"]["nested"][1]
        else:
            assert back == value


def _by_value_objects():
    """Functions and classes only a by-value pickle can carry."""
    base = 10

    def closure(x):
        return x + base

    def fact(n):
        return 1 if n <= 1 else n * fact(n - 1)

    class Point:
        scale = 3

        def __init__(self, x):
            self.x = x

        def doubled(self):
            return Point(self.x * 2)

        @classmethod
        def origin(cls):
            return cls(0)

        @staticmethod
        def unit():
            return 1

        @property
        def scaled(self):
            return self.x * Point.scale

        def __repr__(self):
            return f"Point({self.x})"

    class Slotted:
        __slots__ = ("a",)

        def __init__(self, a):
            self.a = a

    def uses_module(n):
        import math

        return math.factorial(n) + len(np.arange(n))

    return {
        "closure": closure, "lambda": lambda y, k=2: y * k + base,
        "fact": fact, "Point": Point, "Slotted": Slotted,
        "uses_module": uses_module,
    }


_PROBE = """
import pickle, sys
objs = pickle.loads(sys.stdin.buffer.read())
p = objs["Point"](4)
print(repr([objs["closure"](1), objs["lambda"](3), objs["fact"](6),
            repr(p.doubled().doubled()), p.scaled, objs["Point"].origin().x,
            objs["Point"].unit(), objs["Slotted"](7).a,
            objs["uses_module"](5), isinstance(p.doubled(), objs["Point"]),
            any(m.startswith("test_torch") for m in sys.modules)]))
"""


@pytest.mark.timeout(60)
def test_functions_and_classes_by_value_in_a_fresh_interpreter():
    blob = serialization.dumps_by_value(_by_value_objects())
    r = subprocess.run([sys.executable, "-c", _PROBE], input=blob,
                       capture_output=True, cwd=ROOT, timeout=50)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert eval(r.stdout.decode()) == [
        11, 16, 720, "Point(16)", 12, 0, 1, 7, 125, True, False]


@pytest.mark.timeout(30)
def test_importable_objects_go_by_reference():
    import math

    from ray_tpu_torch._private.task_spec import make_task_spec

    for obj in (make_task_spec, math.sqrt, np.ndarray, serialization):
        blob = serialization.dumps_by_value(obj)
        assert len(blob) < 120, (obj, len(blob))
        assert pickle_loads(blob) is obj


def pickle_loads(blob):
    import pickle

    return pickle.loads(blob)


@pytest.mark.timeout(60)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8",
                                   "float8_e4m3fn"])
@pytest.mark.parametrize("layout", ["contiguous", "strided", "small"])
def test_tensor_round_trip(dtype, layout):
    gen = torch.Generator().manual_seed(3)
    base = torch.randn(192, 160, generator=gen) * 20
    t = base.to(getattr(torch, dtype))
    if layout == "strided":
        t = t.t()[::2]
    elif layout == "small":
        t = t[:3, :5].contiguous()
    chunks = serialization.serialize({"t": t, "n": 3})
    data = bytearray(serialization.serialized_size(chunks))
    serialization.write_chunks(chunks, memoryview(data))
    view = memoryview(bytes(data))
    back = serialization.deserialize(view)["t"]
    assert back.dtype == t.dtype and back.shape == t.shape
    assert back.device.type == "cpu"
    assert torch.equal(back.view(torch.uint8), t.contiguous().view(torch.uint8))
    if layout != "small":  # out of band: a view onto the buffer itself
        addr = np.frombuffer(view, np.uint8).ctypes.data
        assert addr <= back.data_ptr() < addr + len(view)


@pytest.mark.timeout(60)
def test_scheduler_decisions_equal_jax():
    pytest.importorskip("jax")
    import random

    from ray_tpu._private import scheduler as jsched

    from ray_tpu_torch._private import scheduler as sched

    rng = np.random.default_rng(11)
    names = ("CPU", "GPU", "memory", "custom")
    picks = bundles = 0
    for trial in range(60):
        nodes = {}
        for i in range(int(rng.integers(1, 6))):
            total = {n: float(rng.integers(0, 9)) for n in names
                     if rng.random() < 0.8}
            total.setdefault("CPU", 4.0)
            avail = {n: float(rng.integers(0, int(v) + 1))
                     for n, v in total.items()}
            nodes[bytes([i]) * 16] = {"resources": total, "available": avail,
                                      "alive": bool(rng.random() < 0.9)}
        demand = {n: float(rng.integers(0, 4)) for n in names
                  if rng.random() < 0.5}
        local = list(nodes)[int(rng.integers(0, len(nodes)))]
        assert sched.fits(demand, nodes[local]["available"]) == jsched.fits(
            demand, nodes[local]["available"])
        for strategy in ("default", "spread", "node_affinity"):
            got = []
            for m in (sched, jsched):
                random.seed(trial)
                got.append(m.pick_node(demand, nodes, strategy=strategy,
                                       local_node_id=local,
                                       affinity_node_id=local,
                                       soft=bool(trial % 2)))
            assert got[0] == got[1], (trial, strategy)
            picks += got[0] is not None
        shapes = [{n: float(rng.integers(0, 3)) for n in ("CPU", "custom")}
                  for _ in range(int(rng.integers(1, 4)))]
        for strategy in ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD"):
            a = sched.schedule_bundles(shapes, strategy, nodes)
            b = jsched.schedule_bundles(shapes, strategy, nodes)
            assert a == b, (trial, strategy)
            bundles += a is not None
    assert picks > 30 and bundles > 30  # the corpus reaches both outcomes
    acc = {"CPU": 2.0}
    for m in (sched, jsched):
        m.subtract(acc, {"CPU": 0.5, "GPU": 1.0})
        m.add(acc, {"CPU": 0.5, "GPU": 1.0})
    assert acc == {"CPU": 2.0, "GPU": 0.0}


@pytest.mark.timeout(30)
def test_stale_segment_sweep_judges_only_its_own_namespace():
    """``_gc_stale_segments`` unlinks a segment of a dead store of this pid
    namespace, and keeps a live store's and any of another namespace
    (whose pid says nothing here)."""
    from ray_tpu_torch._private import object_store

    ns = object_store._pid_namespace()
    assert ns and ns.isdigit()
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    names = {"dead": f"rtt_store_{dead.pid}_{ns}_0badc0de_0",
             "live": f"rtt_store_{os.getpid()}_{ns}_0badc0de_0",
             "elsewhere": f"rtt_store_{dead.pid}_{ns}0_0badc0de_0"}
    try:
        for n in names.values():
            open("/dev/shm/" + n, "wb").close()
        object_store._gc_stale_segments()
        left = {k for k, n in names.items() if os.path.exists("/dev/shm/" + n)}
    finally:
        for n in names.values():
            if os.path.exists("/dev/shm/" + n):
                os.unlink("/dev/shm/" + n)
    assert left == {"live", "elsewhere"}
