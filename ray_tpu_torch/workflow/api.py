"""Workflow DAG build + durable execution (the port's copy of
``ray_tpu/workflow/api.py``; steps run as the port's tasks, and the
default storage is the port's own directory).

Equivalent of the reference's workflow engine
(reference: python/ray/workflow/api.py run/resume/get_output;
workflow/task_executor.py step execution + checkpointing;
python/ray/dag FunctionNode bind graph). Design: a WorkflowNode DAG is
topologically executed; each step runs as a task, its pickled result lands
in <storage>/<workflow_id>/<step>.pkl BEFORE dependents start, so a crashed
driver resumes from the last completed frontier.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Callable

import ray_tpu_torch

_DEFAULT_STORAGE = os.path.expanduser("~/.ray_tpu_torch_workflows")


class WorkflowNode:
    """One step bound to its arguments (reference: dag.FunctionNode)."""

    def __init__(self, fn: Callable, args: tuple, kwargs: dict, *, name: str | None = None, max_retries: int = 0):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.name = name or fn.__name__
        self.max_retries = max_retries

    def options(self, *, name: str | None = None, max_retries: int | None = None) -> "WorkflowNode":
        return WorkflowNode(
            self.fn, self.args, self.kwargs,
            name=name or self.name,
            max_retries=self.max_retries if max_retries is None else max_retries,
        )

    # unique step ids assigned at run time via deterministic DFS numbering
    def _deps(self) -> list["WorkflowNode"]:
        out = []

        def visit(v):
            if isinstance(v, WorkflowNode):
                out.append(v)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    visit(x)
            elif isinstance(v, dict):
                for x in v.values():
                    visit(x)

        for a in self.args:
            visit(a)
        for a in self.kwargs.values():
            visit(a)
        return out


class _Step:
    """step decorator product: .bind() builds DAG nodes."""

    def __init__(self, fn: Callable, max_retries: int = 0):
        self.fn = fn
        self.max_retries = max_retries

    def bind(self, *args, **kwargs) -> WorkflowNode:
        return WorkflowNode(self.fn, args, kwargs, max_retries=self.max_retries)

    def options(self, *, max_retries: int = 0) -> "_Step":
        return _Step(self.fn, max_retries)


def step(fn: Callable | None = None, *, max_retries: int = 0):
    """Mark a function as a workflow step: `my_step.bind(...)` builds the
    DAG (reference: @workflow.step in the classic API / dag bind)."""
    if fn is None:
        return lambda f: _Step(f, max_retries)
    return _Step(fn, max_retries)


def _storage_dir(workflow_id: str, storage: str | None) -> str:
    d = os.path.join(storage or _DEFAULT_STORAGE, workflow_id)
    os.makedirs(d, exist_ok=True)
    return d


def _assign_ids(root: WorkflowNode) -> list[tuple[str, WorkflowNode]]:
    """Deterministic post-order (deps first); id = order:name, stable across
    runs of the same DAG shape — the resume key."""
    order: list[tuple[str, WorkflowNode]] = []
    seen: dict[int, str] = {}

    def visit(node: WorkflowNode):
        if id(node) in seen:
            return
        for d in node._deps():
            visit(d)
        sid = f"{len(order):06d}-{node.name}"
        seen[id(node)] = sid
        order.append((sid, node))

    visit(root)
    return order


def _resolve(value, results: dict[int, Any]):
    if isinstance(value, WorkflowNode):
        return results[id(value)]
    if isinstance(value, (list, tuple)):
        return type(value)(_resolve(v, results) for v in value)
    if isinstance(value, dict):
        return {k: _resolve(v, results) for k, v in value.items()}
    return value


def run(
    dag: WorkflowNode,
    *,
    workflow_id: str,
    storage: str | None = None,
    overwrite: bool = False,
) -> Any:
    """Execute the DAG durably; returns the root step's result
    (reference: workflow.run api.py)."""
    d = _storage_dir(workflow_id, storage)
    if overwrite:
        for f in os.listdir(d):
            os.unlink(os.path.join(d, f))
    steps = _assign_ids(dag)
    results: dict[int, Any] = {}
    for sid, node in steps:
        ckpt = os.path.join(d, sid + ".pkl")
        if os.path.exists(ckpt):
            with open(ckpt, "rb") as f:
                results[id(node)] = pickle.load(f)
            continue
        args = tuple(_resolve(a, results) for a in node.args)
        kwargs = {k: _resolve(v, results) for k, v in node.kwargs.items()}
        remote_fn = ray_tpu_torch.remote(max_retries=node.max_retries)(node.fn)
        value = ray_tpu_torch.get(remote_fn.remote(*args, **kwargs), timeout=3600)
        tmp = ckpt + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(value, f)
        os.replace(tmp, ckpt)  # atomic: a crash mid-write never corrupts
        results[id(node)] = value
    # mark completion for list_workflows/get_output
    with open(os.path.join(d, "_status"), "w") as f:
        f.write("SUCCESSFUL")
    return results[id(dag)]


def resume(dag: WorkflowNode, *, workflow_id: str, storage: str | None = None) -> Any:
    """Re-run the DAG, replaying completed steps from their checkpoints
    (reference: workflow.resume)."""
    return run(dag, workflow_id=workflow_id, storage=storage)


def get_output(workflow_id: str, *, storage: str | None = None) -> Any:
    """Root-step result of a FINISHED workflow; raises if it never
    completed (resume it instead of reading a partial frontier)."""
    d = _storage_dir(workflow_id, storage)
    status_file = os.path.join(d, "_status")
    if not os.path.exists(status_file) or open(status_file).read().strip() != "SUCCESSFUL":
        raise ValueError(
            f"workflow {workflow_id!r} did not finish — resume() it first"
        )
    pkls = sorted(f for f in os.listdir(d) if f.endswith(".pkl"))
    if not pkls:
        raise ValueError(f"workflow {workflow_id!r} has no outputs")
    with open(os.path.join(d, pkls[-1]), "rb") as f:
        return pickle.load(f)


def list_workflows(storage: str | None = None) -> list[dict]:
    base = storage or _DEFAULT_STORAGE
    if not os.path.isdir(base):
        return []
    out = []
    for wid in sorted(os.listdir(base)):
        if not os.path.isdir(os.path.join(base, wid)):
            continue
        status_file = os.path.join(base, wid, "_status")
        status = "RUNNING"
        if os.path.exists(status_file):
            with open(status_file) as f:
                status = f.read().strip()
        out.append({"workflow_id": wid, "status": status})
    return out
