"""The distributed core on the card (marked ``gpu``: skips without an
NVIDIA card of compute capability 9.0 or more): a ``num_gpus=1`` task sees
``CUDA_VISIBLE_DEVICES`` "0" and this card, and a ``num_gpus=1`` actor
runs kernel B4 (``paged_attention_cuda``) against its plain twin
(``kv_cache.paged_attention``) on the actor's own device, at Llama-125M's
decode shapes (12 query heads on 4 kv heads of 64), with the tolerances
of ``test_torch_kernels.py``."""
from __future__ import annotations

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def core():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability >= 9.0 (kernels target sm_90a)")
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=2, num_gpus=1)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.mark.timeout(300)
def test_gpu_task_sees_its_card(core):
    @core.remote(num_gpus=1)
    def seen():
        import os

        import torch

        return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                torch.cuda.device_count(), torch.cuda.get_device_name(0))

    assert core.get(seen.remote(), timeout=240) == (
        "0", 1, torch.cuda.get_device_name(0))


@pytest.mark.timeout(300)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_actor_b4_matches_plain(core, dtype):
    @core.remote(num_gpus=1)
    class DecodeCheck:
        def run(self, dtype_name):
            import torch

            from ray_tpu_torch.ops import paged_attention as pa
            from ray_tpu_torch.ops.kv_cache import paged_attention

            dev = torch.device("cuda", 0)
            dtype = getattr(torch, dtype_name)
            gen = torch.Generator(device=dev).manual_seed(14)
            lengths = [1, 17, 300, 900]
            B, Hkv, G, hd, bs, NB = len(lengths), 4, 3, 64, 16, 64
            perm = torch.randperm(B * NB, generator=gen, device=dev) + 1
            tables = torch.zeros(B, NB, dtype=torch.int32, device=dev)
            for b, n in enumerate(lengths):
                used = -(-n // bs)
                tables[b, :used] = perm[b * NB:b * NB + used].int()
            shape = (1 + B * NB, bs, Hkv, hd)
            k = torch.randn(shape, generator=gen, device=dev).to(dtype)
            v = torch.randn(shape, generator=gen, device=dev).to(dtype)
            q = torch.randn(B, Hkv * G, hd, generator=gen,
                            device=dev).to(dtype)
            pos = torch.tensor([n - 1 for n in lengths], dtype=torch.int32,
                               device=dev)
            before = pa.LAUNCHES["paged_decode"]
            got = pa.paged_attention_cuda(q, k, v, tables, pos)
            want = paged_attention(q, k, v, tables, pos)
            torch.cuda.synchronize()
            return (got.float().cpu(), want.float().cpu(),
                    pa.LAUNCHES["paged_decode"] - before, str(got.device))

    checker = DecodeCheck.remote()
    got, want, launches, device = core.get(checker.run.remote(dtype),
                                           timeout=240)
    core.kill(checker)
    atol, rtol = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1.6e-2)}[dtype]
    assert launches == 1 and device == "cuda:0"
    diff = (got - want).abs()
    assert bool((diff <= atol + rtol * want.abs()).all()), diff.max()
