"""TorchTrainer — torch DDP training on the actor gang (the port's copy of
``ray_tpu/train/torch.py``).

Equivalent of the reference's TorchTrainer (reference:
python/ray/train/torch/torch_trainer.py; backend setup config.py:63 —
process-group rendezvous across the worker gang; prepare_model
train_loop_utils.py:70 DDP wrap; prepare_data_loader :330
DistributedSampler injection). The gang joins an nccl group when it holds
cards (``ScalingConfig(use_gpu=True)``, the default) and a gloo group on
the CPU (``use_gpu=False``); each GPU worker runs on its own card, which
it sees as ``cuda:0`` (``get_device``).

    from ray_tpu_torch.train import ScalingConfig, report
    from ray_tpu_torch.train.torch import TorchTrainer, get_device, prepare_model

    def train_loop(cfg):
        model = prepare_model(Net())          # on the card, DDP-wrapped
        ...
        report({"loss": float(loss)})

    TorchTrainer(train_loop, scaling_config=ScalingConfig(num_workers=1)).fit()
"""
from __future__ import annotations

from typing import Any

from ray_tpu_torch.train.trainer import DataParallelTrainer


class TorchTrainer(DataParallelTrainer):
    pass


def get_device():
    """The device this worker should use: its card as ``cuda:0`` (the
    core sets ``CUDA_VISIBLE_DEVICES`` to the worker's slot) in a GPU
    gang, the CPU in a CPU gang or outside one (reference:
    train/torch/train_loop_utils.py get_device)."""
    import torch

    from ray_tpu_torch._private.worker import global_worker_or_none

    w = global_worker_or_none()
    if w is not None and w._current_gpus:
        return torch.device("cuda", 0)
    return torch.device("cpu")


def prepare_model(model: Any) -> Any:
    """Move the model to ``get_device()``, and wrap it in
    DistributedDataParallel when the gang has >1 rank (reference:
    train_loop_utils.py:70)."""
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    device = get_device()
    model = model.to(device)
    if dist.is_initialized() and dist.get_world_size() > 1:
        if device.type == "cuda":
            return DistributedDataParallel(model, device_ids=[device.index])
        return DistributedDataParallel(model)
    return model


def prepare_data_loader(loader: Any, *, shuffle: bool | None = None) -> Any:
    """Rebuild a DataLoader with a DistributedSampler so each rank sees its
    shard (reference: train_loop_utils.py:330). No-op for world_size 1."""
    import torch.distributed as dist
    from torch.utils.data import DataLoader, DistributedSampler

    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return loader
    if loader.batch_size is None:
        # custom batch_sampler: a rebuilt loader would silently yield
        # UNBATCHED samples — the caller must shard inside their sampler
        raise ValueError(
            "prepare_data_loader cannot re-shard a DataLoader built with a "
            "batch_sampler; make your batch_sampler rank-aware instead "
            "(dist.get_rank()/get_world_size())"
        )
    if shuffle is None:
        # mirror the loader's own setting; RandomSampler implies shuffle
        from torch.utils.data import RandomSampler

        shuffle = isinstance(getattr(loader, "sampler", None), RandomSampler)
    sampler = DistributedSampler(
        loader.dataset,
        num_replicas=dist.get_world_size(),
        rank=dist.get_rank(),
        shuffle=shuffle,
    )
    kwargs = dict(
        batch_size=loader.batch_size,
        sampler=sampler,
        num_workers=loader.num_workers,
        collate_fn=loader.collate_fn,
        drop_last=loader.drop_last,
        pin_memory=loader.pin_memory,
        timeout=loader.timeout,
        worker_init_fn=loader.worker_init_fn,
        generator=loader.generator,
    )
    if loader.num_workers > 0:
        # only valid with worker processes
        kwargs["persistent_workers"] = loader.persistent_workers
        kwargs["prefetch_factor"] = loader.prefetch_factor
    return DataLoader(loader.dataset, **kwargs)
