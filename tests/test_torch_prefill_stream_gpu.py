"""B5 (``paged_prefill_attention_cuda``) against the port's plain paged
prefill at a 2048-token context, where the plain version takes its
streaming branch (``ops/kv_cache.PREFILL_STREAM_MIN_T``). Marked ``gpu``:
skips without an NVIDIA card of compute capability 9.0 or more. Tolerance
as ``tests/test_torch_kernels.py``'s bf16: 1e-2 + 2 bf16 ulps."""
from __future__ import annotations

import pytest
import torch

pytestmark = pytest.mark.gpu


def test_b5_matches_streaming_twin_at_2048():
    """B5 (``paged_prefill_attention_cuda``) against the plain version,
    which streams at T = 2048: bf16, Llama-125M's head dim 64 at G 3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability >= 9.0 (kernels target sm_90a)")
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.ops.kv_cache import paged_prefill_attention

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(11)
    B, S, Hkv, G, hd, bs, NB = 2, 64, 4, 3, 64, 16, 128
    tables = (torch.randperm(B * NB, generator=gen, device=dev) + 1).to(
        torch.int32).view(B, NB)
    k = torch.randn(1 + B * NB, bs, Hkv, hd, generator=gen,
                    device=dev).to(torch.bfloat16)
    v = torch.randn(k.shape, generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn(B, S, Hkv * G, hd, generator=gen,
                    device=dev).to(torch.bfloat16)
    pos = (NB * bs - S + torch.arange(S, device=dev, dtype=torch.int32))[
        None].repeat(B, 1).contiguous()
    got = pa.paged_prefill_attention_cuda(q, k, v, tables, pos)
    want = paged_prefill_attention(q, k, v, tables, pos)
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= 1e-2 + 1.6e-2 * want.float().abs()).all()), diff.max()
