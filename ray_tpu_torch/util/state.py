"""State API: cluster introspection (list/summarize) + chrome timeline
(the port's copy of ``ray_tpu/util/state.py``, over the port's GCS).

Equivalent of the reference's state API and timeline
(reference: python/ray/experimental/state/api.py list_actors/tasks/nodes +
`ray summary`; served by StateAPIManager dashboard/state_aggregator.py:141
over GcsTaskManager task events gcs_task_manager.h:326; chrome trace
ray.timeline python/ray/_private/state.py:435-451).

``available_resources`` reads the GCS's view, which each raylet's
heartbeat refreshes (``gcs_heartbeat_interval_ms``): a release shows
there within a heartbeat.
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Any

from ray_tpu_torch._private.worker import global_worker


def list_nodes() -> list[dict]:
    w = global_worker()
    return w.gcs.call("get_nodes")["nodes"]


def list_actors() -> list[dict]:
    w = global_worker()
    return w.gcs.call("list_actors")["actors"]


def cluster_resources() -> dict[str, float]:
    w = global_worker()
    return w.gcs.call("cluster_resources")["total"]


def available_resources() -> dict[str, float]:
    w = global_worker()
    return w.gcs.call("cluster_resources")["available"]


def _task_events(job_id: str | None = None, *,
                 trace_id: str | None = None,
                 limit: int | None = None) -> list[dict]:
    w = global_worker()
    w.task_events.flush()
    req: dict = {"job_id": job_id}
    if trace_id is not None:
        req["trace_id"] = trace_id
    if limit is not None:
        req["limit"] = int(limit)
    return w.gcs.call("list_task_events", req)["events"]


def list_tasks(job_id: str | None = None) -> list[dict]:
    """One row per task with its latest state + timings."""
    rows: dict[str, dict] = {}
    for e in _task_events(job_id):
        row = rows.setdefault(
            e["task_id"],
            {
                "task_id": e["task_id"],
                "name": e["name"],
                "type": e["type"],
                "job_id": e["job_id"],
                "state": "UNKNOWN",
                "node_id": None,
                "worker_id": None,
                "submitted_at": None,
                "started_at": None,
                "finished_at": None,
            },
        )
        ev = e["event"]
        if ev == "SUBMITTED":
            row["submitted_at"] = e["ts"]
            if row["state"] == "UNKNOWN":
                row["state"] = "PENDING"
        elif ev == "RUNNING":
            row["started_at"] = e["ts"]
            row["state"] = "RUNNING"
            row["node_id"] = e["node_id"]
            row["worker_id"] = e["worker_id"]
        elif ev in ("FINISHED", "FAILED"):
            row["finished_at"] = e["ts"]
            row["state"] = ev
            row["node_id"] = e["node_id"]
            row["worker_id"] = e["worker_id"]
    return list(rows.values())


def summarize_tasks(job_id: str | None = None) -> dict:
    """`ray summary tasks` equivalent: per-name state counts + wall time."""
    summary: dict[str, Any] = defaultdict(
        lambda: {"states": defaultdict(int), "total_time_s": 0.0, "count": 0}
    )
    for t in list_tasks(job_id):
        s = summary[t["name"]]
        s["states"][t["state"]] += 1
        s["count"] += 1
        if t["started_at"] and t["finished_at"]:
            s["total_time_s"] += t["finished_at"] - t["started_at"]
    return {
        name: {**v, "states": dict(v["states"])} for name, v in summary.items()
    }


def timeline(filename: str | None = None) -> list[dict] | None:
    """Chrome-trace events (chrome://tracing 'X' phases): one row per
    worker, one slice per task execution."""
    events = []
    for t in list_tasks():
        if not (t["started_at"] and t["finished_at"]):
            continue
        events.append(
            {
                "name": t["name"],
                "cat": t["type"],
                "ph": "X",
                "ts": t["started_at"] * 1e6,
                "dur": (t["finished_at"] - t["started_at"]) * 1e6,
                "pid": t["node_id"] or "node",
                "tid": t["worker_id"] or "worker",
                "args": {"task_id": t["task_id"], "state": t["state"]},
            }
        )
    if filename is None:
        return events
    with open(filename, "w") as f:
        json.dump(events, f)
    return None


def summary() -> dict:
    """Cluster-level rollup (`ray status`-shaped)."""
    nodes = list_nodes()
    return {
        "nodes": {
            "total": len(nodes),
            "alive": sum(1 for n in nodes if n["alive"]),
        },
        "resources": {
            "total": cluster_resources(),
            "available": available_resources(),
        },
        "actors": {
            "total": len(list_actors()),
        },
    }


def event_stats() -> dict[str, dict]:
    """Per-process control-loop latency stats (reference: the event_stats
    section of `ray debug_state.txt`, src/ray/common/asio/
    instrumented_io_context.h). Process-local: covers this driver's RPC
    servers and raylet loops when they run in-process."""
    from ray_tpu_torch._private import event_stats as es

    return es.snapshot()


def debug_state() -> str:
    """Human-readable debug dump (the reference's debug_state.txt)."""
    from ray_tpu_torch._private import event_stats as es

    lines = ["== event_stats ==", es.summary_string()]
    try:
        nodes = list_nodes()
        lines.append("== nodes ==")
        for n in nodes:
            nid = n["node_id"]
            nid = nid.hex() if isinstance(nid, bytes) else str(nid)
            lines.append(
                f"{nid[:12]} alive={n.get('alive')} "
                f"disk={n.get('disk_used_frac', float('nan')):.2f} "
                f"load={n.get('load', 0)}"
            )
    except Exception:  # noqa: BLE001 — dump what we can without a cluster
        pass
    return "\n".join(lines)
