"""ray_tpu_torch.data — distributed numpy-blocked data pipelines on the
port's task core (the counterpart of ``ray_tpu.data``).

Equivalent of the reference data library (reference: python/ray/data/ —
Dataset dataset.py:178, streaming executor _internal/execution/
streaming_executor.py:49). All block transforms run as the port's tasks
(or actors) over object-store blocks, dicts of numpy columns
(``block.py``: the card's machine has no pyarrow and no pandas); ingestion
ends in ``iter_torch_batches``, which stages batches in pinned memory and
copies them to the card ahead of the step. ``Dataset.streaming_split``
shards a dataset across a Train gang (``train.get_dataset_shard``).

The names of the JAX package's ``__all__`` that need pyarrow, pandas or
packages the card's machine lacks (``GroupedData``, ``from_arrow``,
``from_pandas``, ``from_huggingface``, ``read_csv``, ``read_huggingface``,
``read_images``, ``read_mongo``, ``read_parquet``, ``read_sql``,
``read_webdataset``) raise ``NotImplementedError`` naming ROADMAP A10.
"""
from ray_tpu_torch.data.block import BlockAccessor
from ray_tpu_torch.data.compute import ActorPoolStrategy, TaskPoolStrategy
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.dataset import Dataset, GroupedData
from ray_tpu_torch.data.iterator import DataIterator
from ray_tpu_torch.data.datasource import (
    from_arrow,
    from_huggingface,
    from_items,
    from_numpy,
    from_pandas,
    range,
    range_tensor,
    read_csv,
    read_binary_files,
    read_huggingface,
    read_images,
    read_json,
    read_mongo,
    read_numpy,
    read_parquet,
    read_sql,
    read_text,
    read_tfrecords,
    read_webdataset,
)

__all__ = [
    "ActorPoolStrategy",
    "TaskPoolStrategy",
    "BlockAccessor",
    "DataContext",
    "DataIterator",
    "Dataset",
    "GroupedData",
    "from_arrow",
    "from_huggingface",
    "from_items",
    "from_numpy",
    "from_pandas",
    "range",
    "range_tensor",
    "read_csv",
    "read_binary_files",
    "read_huggingface",
    "read_images",
    "read_json",
    "read_mongo",
    "read_numpy",
    "read_parquet",
    "read_sql",
    "read_text",
    "read_tfrecords",
    "read_webdataset",
]
