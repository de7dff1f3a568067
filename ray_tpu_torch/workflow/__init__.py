"""ray_tpu_torch.workflow — durable DAG execution with storage checkpoints
(the port's copy of ``ray_tpu/workflow``).

Equivalent of the reference's Workflow library
(reference: python/ray/workflow — api.py run/resume, task_executor.py,
storage-backed step checkpoints workflow/storage/filesystem.py; built on
the Ray DAG bind API python/ray/dag/). Steps are tasks on the distributed
core; each step's result is checkpointed to the workflow's storage dir, so
`resume` replays completed steps from disk and re-executes only the rest.
"""
from ray_tpu_torch.workflow.api import (
    WorkflowNode,
    get_output,
    list_workflows,
    resume,
    run,
    step,
)

__all__ = [
    "WorkflowNode",
    "get_output",
    "list_workflows",
    "resume",
    "run",
    "step",
]

