"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked ``gpu``: every test skips without an NVIDIA card of
compute capability 9.0 or more (the kernels are built for sm_90a and have
no CPU mode). ``chip_smoke.py`` runs the same comparisons at the serving
path's full shapes.

Tolerances on the same inputs: f32 1e-5 (online vs one-shot softmax
order); bf16 1e-2 + 2 bf16 ulps of the value (the kernel rounds exp2 and
the probabilities to bf16 like the TPU kernel). The quantized variants
dequantize the same bytes to the same f32 values as their plain versions
and run an f32 softmax, so they take the tolerance of q's dtype (bf16:
the q pre-scale and the output rounding)."""
from __future__ import annotations

import dataclasses

import pytest
import torch

TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1.6e-2)}

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability >= 9.0 (kernels target sm_90a)")
    return torch.device("cuda", 0)


def _assert_close(got, want, dtype):
    atol, rtol = TOL[dtype]
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= atol + rtol * want.float().abs()).all()), diff.max()


def _case(dev, dtype, B, Hkv, G, hd, bs, NB, used, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    num_blocks = 1 + B * NB
    perm = torch.randperm(B * NB, generator=gen, device=dev) + 1
    tables = torch.zeros(B, NB, dtype=torch.int32, device=dev)
    for b in range(B):
        tables[b, :used[b]] = perm[b * NB:b * NB + used[b]].to(torch.int32)
    shape = (num_blocks, bs, Hkv, hd)
    k = torch.randn(shape, generator=gen, device=dev).to(dtype)
    v = torch.randn(shape, generator=gen, device=dev).to(dtype)
    return gen, k, v, tables


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gqa", [1, 2, 4])
def test_decode_kernel_matches_plain(cuda, dtype, gqa):
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.ops.kv_cache import paged_attention

    lengths = [1, 17, 64, 200]
    B, Hkv, hd, bs, NB = len(lengths), 2, 64, 16, 16
    gen, k, v, tables = _case(cuda, dtype, B, Hkv, gqa, hd, bs, NB,
                              [-(-n // bs) for n in lengths], seed=gqa)
    q = torch.randn(B, Hkv * gqa, hd, generator=gen, device=cuda).to(dtype)
    pos = torch.tensor([n - 1 for n in lengths], dtype=torch.int32,
                       device=cuda)
    before = pa.LAUNCHES["paged_decode"]
    got = pa.paged_attention_cuda(q, k, v, tables, pos)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_decode"] == before + 1
    _assert_close(got, paged_attention(q, k, v, tables, pos), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gqa,window", [(1, None), (2, None), (4, 24),
                                        (1, 7)])
def test_prefill_kernel_matches_plain(cuda, dtype, gqa, window):
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.ops.kv_cache import paged_prefill_attention

    starts, S = [0, 5, 40], 45
    lens = torch.tensor([45, 30, 12], device=cuda)
    B, Hkv, hd, bs, NB = 3, 2, 64, 16, 6
    gen, k, v, tables = _case(cuda, dtype, B, Hkv, gqa, hd, bs, NB,
                              [-(-(s + S) // bs) for s in starts], seed=9)
    q = torch.randn(B, S, Hkv * gqa, hd, generator=gen, device=cuda).to(dtype)
    ar = torch.arange(S, device=cuda)
    pos = torch.tensor(starts, device=cuda)[:, None] + ar[None, :]
    pos = torch.where(ar[None, :] < lens[:, None], pos, 0).to(torch.int32)
    got = pa.paged_prefill_attention_cuda(q, k, v, tables, pos, window=window)
    torch.cuda.synchronize()
    want = paged_prefill_attention(q, k, v, tables, pos, window=window)
    valid = ar[None, :] < lens[:, None]  # padding rows are discarded
    _assert_close(got[valid], want[valid], dtype)


# ---- the quantized variants of B4 and B5: int8 / fp8-e4m3 pools with f32
# scales, against the same plain versions on the same QuantizedKV pool


def _quantized(k, v, kind):
    from ray_tpu_torch.ops.quantization import QuantizedKV, quantize_kv

    return tuple(QuantizedKV(*quantize_kv(x, kind)) for x in (k, v))


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gqa", [1, 2])
def test_quantized_decode_kernel_matches_plain(cuda, kind, dtype, gqa):
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.ops.kv_cache import paged_attention

    lengths = [1, 17, 64, 200]
    B, Hkv, hd, bs, NB = len(lengths), 2, 64, 16, 16
    gen, k, v, tables = _case(cuda, torch.float32, B, Hkv, gqa, hd, bs, NB,
                              [-(-n // bs) for n in lengths], seed=gqa)
    k, v = _quantized(k, v, kind)
    q = torch.randn(B, Hkv * gqa, hd, generator=gen, device=cuda).to(dtype)
    pos = torch.tensor([n - 1 for n in lengths], dtype=torch.int32,
                       device=cuda)
    before = dict(pa.LAUNCHES)
    got = pa.paged_attention_cuda(q, k, v, tables, pos)
    torch.cuda.synchronize()
    assert {n: pa.LAUNCHES[n] - before[n] for n in before
            if pa.LAUNCHES[n] != before[n]} == {f"paged_decode_{kind}": 1}
    _assert_close(got, paged_attention(q, k, v, tables, pos), dtype)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gqa,window", [(1, None), (2, None), (1, 7),
                                        (2, 24)])
def test_quantized_prefill_kernel_matches_plain(cuda, kind, dtype, gqa,
                                                window):
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.ops.kv_cache import paged_prefill_attention

    starts, S = [0, 5, 40], 45
    lens = torch.tensor([45, 30, 12], device=cuda)
    B, Hkv, hd, bs, NB = 3, 2, 64, 16, 6
    gen, k, v, tables = _case(cuda, torch.float32, B, Hkv, gqa, hd, bs, NB,
                              [-(-(s + S) // bs) for s in starts], seed=9)
    k, v = _quantized(k, v, kind)
    q = torch.randn(B, S, Hkv * gqa, hd, generator=gen, device=cuda).to(dtype)
    ar = torch.arange(S, device=cuda)
    pos = torch.tensor(starts, device=cuda)[:, None] + ar[None, :]
    pos = torch.where(ar[None, :] < lens[:, None], pos, 0).to(torch.int32)
    before = pa.LAUNCHES[f"paged_prefill_{kind}"]
    got = pa.paged_prefill_attention_cuda(q, k, v, tables, pos, window=window)
    torch.cuda.synchronize()
    assert pa.LAUNCHES[f"paged_prefill_{kind}"] == before + 1
    want = paged_prefill_attention(q, k, v, tables, pos, window=window)
    valid = ar[None, :] < lens[:, None]
    _assert_close(got[valid], want[valid], dtype)


def test_quantized_wrappers_refuse_bad_pools_on_cuda(cuda):
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.ops.quantization import QuantizedKV

    gen, k, v, tables = _case(cuda, torch.float32, 1, 2, 1, 64, 16, 2, [2],
                              seed=0)
    k, v = _quantized(k, v, "int8")
    q = torch.randn(1, 2, 64, generator=gen, device=cuda)
    pos = torch.tensor([20], dtype=torch.int32, device=cuda)
    before = dict(pa.LAUNCHES)
    bad_scale = QuantizedKV(k.data, k.scale[..., :1].contiguous())
    with pytest.raises(ValueError, match="scale plane"):
        pa.paged_attention_cuda(q, bad_scale, v, tables, pos)
    with pytest.raises(TypeError, match="both be quantized"):
        pa.paged_attention_cuda(q, k, v.data.float(), tables, pos)
    with pytest.raises(TypeError, match="pool dtype"):
        pa.paged_attention_cuda(q, k.data, v.data, tables, pos)
    narrow = _quantized(torch.zeros(3, 16, 2, 8, device=cuda),
                        torch.zeros(3, 16, 2, 8, device=cuda), "fp8")
    with pytest.raises(ValueError, match="multiple of 16"):
        pa.paged_attention_cuda(q[..., :8].contiguous(), *narrow, tables, pos)
    assert pa.LAUNCHES == before


def test_gpt_cuda_backend_matches_torch_backend(cuda):
    from ray_tpu_torch.models.gpt import GPT, GPTConfig, gpt_init

    cfg = dataclasses.replace(GPTConfig.tiny(), dtype=torch.float32,
                              attention_backend="cuda")
    ref = gpt_init(dataclasses.replace(cfg, attention_backend="torch"),
                   seed=0, device=cuda)
    model = GPT(cfg, cuda)
    model.load_state_dict(ref.state_dict())
    B, S, bs, NB = 2, 24, 8, 5
    tables = torch.arange(1, 1 + B * NB, dtype=torch.int32,
                          device=cuda).reshape(B, NB)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(1))
    lengths = torch.tensor([24, 13], dtype=torch.int32, device=cuda)
    out = {}
    for name, m in (("cuda", model), ("torch", ref)):
        shape = (cfg.n_layer, 1 + B * NB, bs, cfg.n_head, cfg.head_dim)
        ck, cv = torch.zeros(shape, device=cuda), torch.zeros(shape, device=cuda)
        logits, _, _ = m.prefill(ck, cv, tokens, lengths, tables)
        step, _, _ = m.decode_step(ck, cv, logits.argmax(-1).int(), lengths,
                                   tables)
        out[name] = torch.cat([logits, step])
    assert (out["cuda"] - out["torch"]).abs().max().item() <= 1e-4


# ---- flash attention: B1 (forward), B2 (dK/dV) and B3 (dQ), at TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,D,causal", [(128, 64, True), (200, 64, True),
                                        (96, 32, False), (64, 128, True),
                                        (17, 64, False)])
def test_flash_kernels_match_plain(cuda, dtype, S, D, causal):
    from ray_tpu_torch.ops import attention as at

    gen = torch.Generator(device=cuda).manual_seed(S + D)
    q, k, v, do = (torch.randn(2, 3, S, D, generator=gen, device=cuda)
                   .to(dtype) for _ in range(4))
    scale = D ** -0.5
    before = dict(at.LAUNCHES)
    o, lse = at.flash_forward_cuda(q, k, v, causal=causal, scale=scale)
    o_ref, lse_ref = at.flash_forward_reference(q, k, v, causal=causal,
                                                scale=scale)
    torch.cuda.synchronize()
    _assert_close(o, o_ref, dtype)
    _assert_close(lse, lse_ref, dtype)
    # the backward from the same saved tensors on both sides
    grads = at.flash_backward_cuda(q, k, v, o_ref, lse_ref, do,
                                   causal=causal, scale=scale)
    refs = at.flash_backward_reference(q, k, v, o_ref, lse_ref, do,
                                       causal=causal, scale=scale)
    torch.cuda.synchronize()
    for got, want in zip(grads, refs):
        _assert_close(got, want, dtype)
    assert {n: at.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_dkv": 1, "flash_bwd_dq": 1}


def test_flash_attention_autograd_on_cuda(cuda):
    from ray_tpu_torch.ops.attention import flash_attention

    gen = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(2, 8, 80, 64, generator=gen, device=cuda)
    k, v = (torch.randn(2, 2, 80, 64, generator=gen, device=cuda)
            for _ in range(2))
    out = {}
    for backend in ("cuda", "torch"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = flash_attention(*leaves, causal=True, backend=backend)
        (o * o).sum().backward()
        out[backend] = [o.detach()] + [t.grad for t in leaves]
    for got, want in zip(out["cuda"], out["torch"]):
        _assert_close(got, want, torch.float32)
