"""Where a no-op task's round trip goes in the port's core, by part.

    python -m ray_tpu_torch.benchmarks.core_round_trip [--n 200] [--out FILE]

Starts a one-node cluster (``init(num_cpus=2, num_gpus=0)``: no card is
touched), warms one worker, then times ``n`` round trips of a task that
returns ``time.time()`` when it starts. Each round trip is split at that
stamp (the worker's clock and the driver's are the host's wall clock):
``to_worker`` (submit, the raylet's dispatch, the push to the worker and
its unpickling) and ``back`` (the task's return, its seal in the store,
``task_done`` and the driver's ``get``).

The RPC codec (``_private/wire.py``) is measured beside it. In this
process, which hosts the driver, the GCS and the raylet, every
``wire.packb`` / ``wire.unpackb`` call is timed while the round trips run
(``codec_here_ms``). Every message is recorded too: those packed here,
and those unpacked here that were packed in the worker. After the run,
one ``packb`` and one ``unpackb`` of each recorded message are timed
again alone, with ``wire`` and with stdlib ``marshal`` (a C codec of the
same types) for scale: ``codec_ms`` and ``marshal_ms`` are the codec's
whole cost per round trip, worker side included. The server's handler
wall times per round trip come from ``event_stats`` (``rpc.<server>.<method>``).
Prints one JSON object; ``--out FILE`` also writes it there.
"""
from __future__ import annotations

import argparse
import json
import marshal
import statistics
import time


def _quantiles(xs: list) -> dict:
    s = sorted(xs)
    return {"p50": statistics.median(s), "p99": s[int(0.99 * (len(s) - 1))],
            "mean": statistics.fmean(s)}


def run(n: int = 200) -> dict:
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import event_stats, wire

    rt.init(num_cpus=2, num_gpus=0)
    real_pack, real_unpack = wire.packb, wire.unpackb
    packed, unpacked, spent = [], [], [0.0]

    def packb(obj):
        t = time.perf_counter()
        out = real_pack(obj)
        spent[0] += time.perf_counter() - t
        packed.append(out)
        return out

    def unpackb(data):
        t = time.perf_counter()
        out = real_unpack(data)
        spent[0] += time.perf_counter() - t
        unpacked.append(bytes(data))
        return out

    @rt.remote
    def stamp():
        import time

        return time.time()

    try:
        for _ in range(5):
            rt.get(stamp.remote(), timeout=120)  # a warm worker
        wire.packb, wire.unpackb = packb, unpackb
        event_stats.reset()
        total, to_worker, back = [], [], []
        for _ in range(n):
            t0 = time.time()
            p0 = time.perf_counter()
            started = rt.get(stamp.remote(), timeout=60)
            p1 = time.perf_counter()
            t1 = time.time()
            total.append(1e3 * (p1 - p0))
            to_worker.append(1e3 * (started - t0))
            back.append(1e3 * (t1 - started))
        stats = event_stats.snapshot("rpc.")
    finally:
        wire.packb, wire.unpackb = real_pack, real_unpack
        rt.shutdown()

    # every message once: those packed here, and those unpacked here that
    # no pack here made (the worker's)
    here = {}
    for b in packed:
        here[b] = here.get(b, 0) + 1
    messages = list(packed)
    for b in unpacked:
        if here.get(b):
            here[b] -= 1
        else:
            messages.append(b)
    objs = [real_unpack(b) for b in messages]

    def alone(pack, unpack) -> float:
        blobs = [pack(o) for o in objs]
        best = float("inf")
        for _ in range(5):
            t = time.perf_counter()
            for o in objs:
                pack(o)
            for b in blobs:
                unpack(b)
            best = min(best, time.perf_counter() - t)
        return 1e3 * best / n

    handlers = {k: round(v["total_ms"] / n, 4) for k, v in stats.items()
                if not k.endswith(".cpu")}
    return {
        "n": n,
        "round_trip_ms": _quantiles(total),
        "to_worker_ms": _quantiles(to_worker),
        "back_ms": _quantiles(back),
        "messages_per_round_trip": len(messages) / n,
        "bytes_per_round_trip": sum(map(len, messages)) / n,
        "codec_here_ms": 1e3 * spent[0] / n,
        "codec_ms": alone(real_pack, real_unpack),
        "marshal_ms": alone(marshal.dumps, marshal.loads),
        "handler_ms": dict(sorted(handlers.items(), key=lambda kv: -kv[1])),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out = run(args.n)
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
