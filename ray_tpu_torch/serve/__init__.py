"""ray_tpu_torch.serve — model serving on the port's distributed core (the
port's copy of ``ray_tpu/serve``).

Controller/reconciler + replica actors + client-side power-of-two routing +
shape-aware dynamic batching + a standard-library HTTP ingress (reference:
python/ray/serve — surveyed in SURVEY.md §2.3 A4). Replicas hold cards
through ``ray_actor_options={"num_gpus": 1}`` (whole cards, as the
port's raylet gives them), and batching pads to fixed size buckets so a
model step sees a closed set of shapes. Not here yet: the gRPC ingress
(``start(grpc_options=...)`` raises), sharded replicas and the
disaggregated prefill handoff (``serve/llm/api.py``).
"""
from ray_tpu_torch.serve.api import (
    delete,
    get_app_handle,
    get_deployment_handle,
    proxy_addresses,
    run,
    shutdown,
    start,
    status,
)
from ray_tpu_torch.serve.batching import batch, pad_to_bucket
from ray_tpu_torch.serve.multiplex import multiplexed
from ray_tpu_torch.serve.config import (
    AutoscalingConfig,
    BatchConfig,
    DeploymentConfig,
    GrpcOptions,
    HTTPOptions,
)
from ray_tpu_torch.serve.deployment import Application, Deployment, deployment
from ray_tpu_torch.serve.handle import (
    DeploymentHandle,
    DeploymentResponse,
    DeploymentResponseGenerator,
)

__all__ = [
    "Application",
    "AutoscalingConfig",
    "BatchConfig",
    "Deployment",
    "DeploymentConfig",
    "DeploymentHandle",
    "DeploymentResponse",
    "DeploymentResponseGenerator",
    "GrpcOptions",
    "HTTPOptions",
    "batch",
    "delete",
    "deployment",
    "get_app_handle",
    "get_deployment_handle",
    "multiplexed",
    "pad_to_bucket",
    "proxy_addresses",
    "run",
    "shutdown",
    "start",
    "status",
]
