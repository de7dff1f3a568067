"""WorkerGroup: the gang of training actors (the port's copy of
``ray_tpu/train/worker_group.py``, on the port's core).

Equivalent of the reference's WorkerGroup + BackendExecutor
(reference: python/ray/train/_internal/worker_group.py:101 actor gang;
backend_executor.py:105 start / :344 start_training; the torch rendezvous
at train/torch/config.py:63).

The gang is reserved through a placement group, one bundle a worker, and
each worker is pinned to its bundle, so the workers land together and
fail and restart as a unit: the reference's gang semantics. A worker of a
GPU gang runs on its card as ``cuda:0`` under the ``CUDA_VISIBLE_DEVICES``
the core gives it. The gang always joins one ``torch.distributed`` group
(DDP needs it even at world size 1): nccl when it holds cards, gloo when
``use_gpu=False``. A GPU gang on a host without CUDA fails at that
rendezvous; there is no fallback to the CPU. The train loop travels by
value (``_private/serialization.py``), so a loop defined in a script or a
function reaches the workers as written. Each trainer dataset is sharded
across the gang (``Dataset.streaming_split(n, equal=True)``) at every
attempt's start; the group holds the shards' block refs for the attempt,
since the port's owner (the driver) frees an object when its own count
reaches zero and a worker does not count as a borrower.
"""
from __future__ import annotations

import socket
import threading
import traceback
from typing import Callable

import ray_tpu_torch
from ray_tpu_torch._private import task_spec as ts
from ray_tpu_torch.exceptions import PlacementGroupUnavailableError
from ray_tpu_torch.train.config import ScalingConfig
from ray_tpu_torch.train.session import TrainContext, init_session
from ray_tpu_torch.util.placement_group import (placement_group,
                                                remove_placement_group)
from ray_tpu_torch.util.scheduling_strategies import \
    PlacementGroupSchedulingStrategy

# seconds the rendezvous may take before it fails the attempt
RENDEZVOUS_TIMEOUT_S = 300
# seconds a worker's shutdown (its process group's teardown) may take
# before the actor is killed all the same
SHUTDOWN_TIMEOUT_S = 10


@ray_tpu_torch.remote
class TrainWorker:
    """One rank of the gang. The user train fn runs on a background
    thread so report-polling actor calls stay responsive."""

    def __init__(self, context_kwargs: dict):
        self.context = TrainContext(**context_kwargs)
        self.session = init_session(self.context)
        self._thread = None

    def get_address(self) -> str:
        return socket.gethostbyname(socket.gethostname())

    def setup_distributed(self, coordinator: str, world_size: int, rank: int,
                          backend: str) -> bool:
        """Join the gang's process group over TCP at ``coordinator``
        (reference: train/torch/config.py:63); ``backend`` is "nccl" for
        a GPU gang, "gloo" for a CPU one."""
        import datetime
        import os

        import torch
        import torch.distributed as dist

        os.environ["RT_COORDINATOR"] = coordinator
        os.environ["RT_WORLD_SIZE"] = str(world_size)
        os.environ["RT_RANK"] = str(rank)
        if backend == "nccl":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "a GPU gang (ScalingConfig(use_gpu=True)) needs CUDA, "
                    "and this worker sees no CUDA device (CUDA_VISIBLE_"
                    f"DEVICES={os.environ.get('CUDA_VISIBLE_DEVICES')!r}); "
                    "pass use_gpu=False to train on the CPU")
            torch.cuda.set_device(0)
        if not dist.is_initialized():
            dist.init_process_group(
                backend, init_method=f"tcp://{coordinator}",
                rank=rank, world_size=world_size,
                timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S),
            )
        return True

    def start_training(self, fn_blob: bytes, train_loop_config: dict | None) -> bool:
        import inspect

        fn = ts.loads_function(fn_blob)
        # fn() or fn(config) are both accepted (reference semantics:
        # train_loop_per_worker may take an optional config dict)
        takes_config = bool(inspect.signature(fn).parameters)

        def runner():
            try:
                if takes_config:
                    fn(train_loop_config or {})
                else:
                    fn()
                self.session.finish()
            except Exception:
                self.session.finish(error=traceback.format_exc())

        self._thread = threading.Thread(target=runner, daemon=True)
        self._thread.start()
        return True

    def poll(self, since: int) -> dict:
        reports, done, error = self.session.drain(since)
        return {"reports": reports, "done": done, "error": error}

    def shutdown(self) -> bool:
        """Leave the process group, so nothing of this gang's rendezvous
        outlives it."""
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        return True


class WorkerGroup:
    def __init__(self, scaling: ScalingConfig, run_name: str,
                 storage_path: str):
        self.scaling = scaling
        self.run_name = run_name
        self.storage_path = storage_path
        self.pg = None
        self.workers: list = []
        # name -> the per-rank DataIterators of the running attempt
        self._dataset_shards: dict[str, list] = {}

    def start(
        self,
        experiment_config: dict | None = None,
        datasets: dict | None = None,
    ) -> None:
        n = self.scaling.num_workers
        bundles = [self.scaling.worker_resources() for _ in range(n)]
        self.pg = placement_group(bundles, strategy=self.scaling.placement_strategy)
        if not self.pg.ready(timeout=60):
            remove_placement_group(self.pg)
            raise PlacementGroupUnavailableError(
                f"cannot reserve {bundles} with strategy "
                f"{self.scaling.placement_strategy}"
            )
        # the cards come from the bundle too: a worker asks its bundle for
        # them, so the core gives it their CUDA_VISIBLE_DEVICES slots
        num_gpus = int(bundles[0].get("GPU", 0))
        # shard each dataset across the gang (reference: streaming_split,
        # python/ray/data/dataset.py:1149; delivered per-worker like
        # data_parallel_trainer.py:59's dataset ingestion), and keep the
        # shards' refs alive for the whole run on the group
        self._dataset_shards = {name: _shard_dataset(ds, n)
                                for name, ds in (datasets or {}).items()}
        self.workers = []
        for rank in range(n):
            ctx = dict(
                world_size=n,
                world_rank=rank,
                local_rank=rank,  # single-host: local == world
                trial_name=self.run_name,
                storage_path=self.storage_path,
                trial_dir=f"{self.storage_path}/worker_{rank}",
                experiment_config=experiment_config or {},
                dataset_shards={name: shards[rank] for name, shards
                                in self._dataset_shards.items()},
            )
            w = TrainWorker.options(
                num_cpus=0,  # resources come from the bundle
                num_gpus=num_gpus,
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    placement_group=self.pg, placement_group_bundle_index=rank
                ),
            ).remote(ctx)
            self.workers.append(w)
        # rendezvous
        addr = ray_tpu_torch.get(self.workers[0].get_address.remote(), timeout=120)
        coordinator = f"{addr}:{_free_port()}"
        backend = "nccl" if self.scaling.use_gpu else "gloo"
        ray_tpu_torch.get(
            [
                w.setup_distributed.remote(coordinator, n, rank, backend)
                for rank, w in enumerate(self.workers)
            ],
            timeout=RENDEZVOUS_TIMEOUT_S,
        )

    def run(self, fn: Callable, config: dict | None = None) -> None:
        blob = ts.dumps_function(fn)
        ray_tpu_torch.get(
            [w.start_training.remote(blob, config) for w in self.workers],
            timeout=300,
        )

    def poll(self, since: list[int]) -> list[dict]:
        """Each worker's new reports. A worker whose actor died raises
        here (``ActorDiedError``) at once: the attempt ends as a gang
        failure."""
        return ray_tpu_torch.get(
            [w.poll.remote(s) for w, s in zip(self.workers, since)], timeout=300
        )

    def shutdown(self) -> None:
        if self.workers:
            try:
                ray_tpu_torch.get([w.shutdown.remote() for w in self.workers],
                                  timeout=SHUTDOWN_TIMEOUT_S)
            except Exception:  # noqa: BLE001 — a dead or wedged rank
                pass
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        if self.pg is not None:
            try:
                remove_placement_group(self.pg)
            except Exception:
                pass
        self.workers = []
        self._dataset_shards = {}


def _shard_dataset(ds, n: int) -> list:
    """Dataset -> n per-worker DataIterators; a DataIterator is replicated
    (the caller pre-sharded); anything else is rejected."""
    from ray_tpu_torch.data.dataset import Dataset
    from ray_tpu_torch.data.iterator import DataIterator

    if isinstance(ds, Dataset):
        return ds.streaming_split(n, equal=True)
    if isinstance(ds, DataIterator):
        return [ds] * n
    raise TypeError(
        f"trainer datasets must be ray_tpu.data Datasets or DataIterators, "
        f"got {type(ds).__name__}"
    )


def _free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port
