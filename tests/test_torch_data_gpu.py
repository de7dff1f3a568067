"""The port's Data feeding a card (marked ``gpu``: skips without an NVIDIA
card of compute capability 9.0 or more): ``iter_torch_batches(device=
"cuda")`` stages each batch in pinned memory and copies it ahead of the
consumer. Over 66 batches of 1.5 MiB (an int64 and a float32 column, a short
last batch) the batches on the card equal the host batches of
``iter_batches`` byte for byte, at prefetch 0, 2 and 4, whether the
consumer reads each batch as it comes (synchronising) or keeps every
batch and reads them all at the end, with no synchronisation in between:
a pinned buffer written again before its copy finished would show there."""
from __future__ import annotations

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

ROWS, BATCH, WIDTH = 64 * 66 - 24, 64, 4096


@pytest.fixture(scope="module")
def dataset():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability >= 9.0")
    import ray_tpu_torch
    from ray_tpu_torch import data as rd

    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    ids = np.random.default_rng(0).integers(0, 1 << 40, (ROWS, WIDTH // 2))
    ds = rd.from_numpy(np.array_split(ids, 5), column="ids").map_batches(
        lambda b: {"ids": b["ids"],
                   "x": (b["ids"] % 1000).astype(np.float32) / 7})
    ds = ds.materialize()
    host = list(ds.iter_batches(batch_size=BATCH))
    yield ds, host
    ray_tpu_torch.shutdown()


def _equal(dev, host) -> bool:
    return (set(dev) == set(host) and all(
        dev[k].device.type == "cuda"
        and dev[k].cpu().numpy().tobytes() == np.ascontiguousarray(
            host[k]).tobytes() for k in host))


@pytest.mark.parametrize("prefetch", [0, 2, 4])
@pytest.mark.parametrize("hold", [False, True])
@pytest.mark.timeout(300)
def test_cuda_batches_equal_host_batches(dataset, prefetch, hold):
    ds, host = dataset
    assert len(host) >= 64 and len(host[-1]["ids"]) == BATCH - 24
    got = []
    for i, batch in enumerate(ds.iter_torch_batches(
            batch_size=BATCH, device="cuda", prefetch=prefetch)):
        if hold:
            got.append(batch)  # no synchronisation until the end
        else:
            assert _equal(batch, host[i]), i
            got.append(None)
    assert len(got) == len(host)
    if hold:
        torch.cuda.synchronize()
        bad = [i for i, (d, h) in enumerate(zip(got, host))
               if not _equal(d, h)]
        assert not bad, bad
