"""Train on the port's core (counterpart of ``ray_tpu/train``): a gang of
worker actors reserved through a placement group, joined in one
``torch.distributed`` group (nccl on cards, gloo on the CPU), with
report/checkpoint plumbing and gang restarts. ``DataParallelTrainer`` is
the base trainer (the JAX package's ``JaxTrainer``), ``TorchTrainer`` its
DDP flavour (``train.torch``: ``get_device``, ``prepare_model``,
``prepare_data_loader``). Trainer ``datasets=`` are the port's Data
(``ray_tpu_torch.data``): each is ``streaming_split`` across the gang and
read by a worker through ``get_dataset_shard``. Not ported yet: the GBDT
trainers (ROADMAP A10)."""
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.session import get_context, get_dataset_shard, report
from ray_tpu_torch.train.trainer import DataParallelTrainer, Result
from ray_tpu_torch.train.torch import TorchTrainer
from ray_tpu_torch.train.worker_group import WorkerGroup

__all__ = [
    "Checkpoint",
    "CheckpointConfig",
    "CheckpointManager",
    "DataParallelTrainer",
    "FailureConfig",
    "TorchTrainer",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "WorkerGroup",
    "get_context",
    "get_dataset_shard",
    "report",
]
