"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked ``gpu``: every test skips without an NVIDIA card of
compute capability 9.0 or more (the kernels are built for sm_90a and have
no CPU mode). ``chip_smoke.py`` runs the same comparisons at the serving
path's full shapes.

Tolerances on the same inputs: f32 1e-5 (online vs one-shot softmax
order); bf16 1e-2 + 2 bf16 ulps of the value (the kernel rounds exp2 and
the probabilities to bf16 like the TPU kernel). The quantized variants
read the same bytes and scales as their plain versions and run an f32
softmax, so they take the tolerance of q's dtype (bf16: the q pre-scale
and the output rounding; B5's tensor-core path with a bf16 q adds fp16's
2^-11 rounding of each p * vscale, well inside it)."""
from __future__ import annotations

import dataclasses
import math

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


def _prefill_inputs(dev, dtype, starts, S, lens, Hkv, G, hd, bs, seed=9):
    """A chunk of S queries per sequence at true positions starts[b] + i,
    rows past lens[b] padded with position 0, over a shuffled paged pool
    of just the blocks each context needs."""
    used = [-(-(s + S) // bs) for s in starts]
    gen, k, v, tables = _case(dev, dtype, len(starts), Hkv, G, hd, bs,
                              max(used), used, seed)
    q = torch.randn(len(starts), S, Hkv * G, hd, generator=gen,
                    device=dev).to(dtype)
    ar = torch.arange(S, device=dev)
    valid = ar[None, :] < torch.tensor(lens, device=dev)[:, None]
    pos = torch.tensor(starts, device=dev)[:, None] + ar[None, :]
    pos = torch.where(valid, pos, 0).to(torch.int32)
    return q, k, v, tables, pos, valid


# after the first four cases, the edges of B5's 64-row x 64-token tiles:
# chunks that are not a multiple of 64 rows; contexts whose tiles span
# several pool blocks, the last one partly past the frontier; G = 4 with
# a window that crosses kv-tile boundaries; block sizes other than the
# engine's 16, below, above and not dividing the 64-token tile; head dims
# that pad (40 -> 64, 96 -> 128) and the widest the bf16 tiles take
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,starts,lens,gqa,window,bs,hd", [
    (45, [0, 5, 40], [45, 30, 12], 1, None, 16, 64),
    (45, [0, 5, 40], [45, 30, 12], 2, None, 16, 64),
    (45, [0, 5, 40], [45, 30, 12], 4, 24, 16, 64),
    (45, [0, 5, 40], [45, 30, 12], 1, 7, 16, 64),
    (100, [0, 70, 200], [100, 100, 77], 1, None, 16, 64),
    (100, [3, 130, 0], [100, 64, 100], 4, 50, 16, 64),
    (80, [0, 33, 150], [80, 80, 80], 2, None, 8, 64),
    (70, [0, 100, 250], [70, 70, 1], 1, 100, 128, 64),
    (90, [5, 60, 121], [90, 45, 90], 2, 70, 12, 64),
    (65, [0, 64, 200], [65, 65, 65], 1, None, 32, 32),
    (65, [0, 64, 200], [65, 65, 65], 2, 40, 16, 40),
    (65, [17, 64, 3], [65, 30, 65], 1, None, 16, 96),
    (65, [0, 129, 7], [65, 65, 65], 1, None, 16, 128),
    # groups that are not a power of two (Llama-125M's 3) and 6: a 16-row
    # fragment of (query, group) rows straddles queries; fresh, ragged
    # and windowed, block sizes 16 and 32
    (45, [0, 0, 0], [45, 45, 20], 3, None, 16, 64),
    (100, [3, 130, 0], [100, 64, 100], 3, None, 32, 64),
    (90, [5, 60, 121], [90, 45, 90], 3, 70, 16, 64),
    (45, [0, 0, 0], [45, 33, 45], 6, None, 32, 64),
    (100, [0, 70, 200], [100, 100, 77], 6, 50, 16, 64),
])
def test_prefill_kernel_matches_plain(cuda, dtype, S, starts, lens, gqa,
                                      window, bs, hd):
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.ops.kv_cache import paged_prefill_attention

    q, k, v, tables, pos, valid = _prefill_inputs(cuda, dtype, starts, S,
                                                  lens, 2, gqa, hd, bs)
    before = pa.LAUNCHES["paged_prefill"]
    got = pa.paged_prefill_attention_cuda(q, k, v, tables, pos, window=window)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_prefill"] == before + 1
    want = paged_prefill_attention(q, k, v, tables, pos, window=window)
    _assert_close(got[valid], want[valid], dtype)  # padding rows discarded


def test_prefill_wrapper_takes_heads_up_to_256(cuda):
    """A pool not held at ``pool_head_dim`` is refused before any launch;
    hd 100 in its padded pool (104), and a bf16 q and an f32 q at 256
    (both on B5's CUDA-core walk), run and match their plain versions
    (heads above 256: ``test_paged_kernels_above_256_match_plain``)."""
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.ops.kv_cache import paged_prefill_attention

    before = dict(pa.LAUNCHES)
    q, k, v, tables, pos, _ = _prefill_inputs(  # not padded to 104
        cuda, torch.bfloat16, [0], 8, [8], 1, 1, 100, 16)
    with pytest.raises(ValueError, match="pool_head_dim"):
        pa.paged_prefill_attention_cuda(q, k, v, tables, pos)
    assert pa.LAUNCHES == before
    q, k, v, tables, pos, _ = _prefill_inputs(
        cuda, torch.bfloat16, [0], 8, [8], 1, 1, 100, 16)
    k, v = _padded_pool(k, v)
    got = pa.paged_prefill_attention_cuda(q, k, v, tables, pos)
    torch.cuda.synchronize()
    assert got.shape == q.shape
    _assert_close(got, paged_prefill_attention(q, k, v, tables, pos),
                  torch.bfloat16)
    q, k, v, tables, pos, _ = _prefill_inputs(
        cuda, torch.bfloat16, [0], 8, [8], 1, 1, 256, 16)
    for dtype in (torch.bfloat16, torch.float32):
        args = (q.to(dtype), k.to(dtype), v.to(dtype), tables, pos)
        got = pa.paged_prefill_attention_cuda(*args)
        torch.cuda.synchronize()
        _assert_close(got, paged_prefill_attention(*args), dtype)
    assert pa.LAUNCHES["paged_prefill"] == before["paged_prefill"] + 3


def _padded_pool(k, v, kind=None):
    """A pool layer as ``PagedKVCache`` holds it: K and V zero-padded to
    ``pool_head_dim`` (quantized after padding, with ``kind``)."""
    from ray_tpu_torch.ops.kv_cache import pad_head, pool_head_dim

    width = pool_head_dim(k.shape[-1], kind is not None)
    k, v = pad_head(k, width), pad_head(v, width)
    return _quantized(k, v, kind) if kind else (k, v)


# ---- Queue C 2: B4/B4q and B5/B5q at head dims that are not a multiple
# of the 16-byte row piece: the pool padded at allocation, q padded by the
# wrapper at the true scale
@pytest.mark.parametrize("kind", [None, "int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [100, 72])
def test_paged_kernels_at_unaligned_head_dims_match_plain(cuda, kind, dtype,
                                                          hd):
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.ops.kv_cache import (
        paged_attention,
        paged_prefill_attention,
    )

    suffix = f"_{kind}" if kind else ""
    pool_dtype = torch.float32 if kind else dtype
    lengths = [1, 17, 64, 200]
    gen, k, v, tables = _case(cuda, pool_dtype, 4, 2, 2, hd, 16, 16,
                              [-(-n // 16) for n in lengths], seed=hd)
    k, v = _padded_pool(k, v, kind)
    q = torch.randn(4, 4, hd, generator=gen, device=cuda).to(dtype)
    pos = torch.tensor([n - 1 for n in lengths], dtype=torch.int32,
                       device=cuda)
    before = dict(pa.LAUNCHES)
    got = pa.paged_attention_cuda(q, k, v, tables, pos)
    torch.cuda.synchronize()
    assert got.shape == q.shape
    _assert_close(got, paged_attention(q, k, v, tables, pos), dtype)

    q, k, v, tables, pos, valid = _prefill_inputs(
        cuda, pool_dtype, [0, 5, 40], 45, [45, 30, 12], 2, 2, hd, 16)
    k, v = _padded_pool(k, v, kind)
    q = q.to(dtype)
    got = pa.paged_prefill_attention_cuda(q, k, v, tables, pos, window=24)
    torch.cuda.synchronize()
    want = paged_prefill_attention(q, k, v, tables, pos, window=24)
    _assert_close(got[valid], want[valid], dtype)
    assert {n: pa.LAUNCHES[n] - before[n] for n in before
            if pa.LAUNCHES[n] != before[n]} == {
        "paged_decode" + suffix: 1, "paged_prefill" + suffix: 1}


# B5 with head dims wider than the tensor-core tiles (129-256): the
# CUDA-core walk, instantiated for a bf16 q and for an f32 q, chunks of 32
# rows, any block size
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,starts,lens,gqa,window,bs,hd", [
    (45, [0, 5, 40], [45, 30, 12], 1, None, 16, 256),
    (45, [0, 5, 40], [45, 30, 12], 2, 24, 16, 256),
    (70, [0, 100, 250], [70, 70, 1], 4, None, 8, 136),
    (33, [17, 64, 3], [33, 30, 33], 1, 7, 32, 192),
])
def test_wide_head_prefill_matches_plain(cuda, dtype, S, starts, lens, gqa,
                                        window, bs, hd):
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.ops.kv_cache import paged_prefill_attention

    q, k, v, tables, pos, valid = _prefill_inputs(
        cuda, dtype, starts, S, lens, 2, gqa, hd, bs)
    before = pa.LAUNCHES["paged_prefill"]
    got = pa.paged_prefill_attention_cuda(q, k, v, tables, pos, window=window)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_prefill"] == before + 1
    want = paged_prefill_attention(q, k, v, tables, pos, window=window)
    _assert_close(got[valid], want[valid], dtype)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_head_quantized_prefill_matches_plain(cuda, kind, dtype):
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.ops.kv_cache import paged_prefill_attention

    q, k, v, tables, pos, valid = _prefill_inputs(
        cuda, torch.float32, [0, 5, 40], 45, [45, 30, 12], 2, 2, 256, 16)
    k, v = _quantized(k, v, kind)
    q = q.to(dtype)
    before = pa.LAUNCHES[f"paged_prefill_{kind}"]
    got = pa.paged_prefill_attention_cuda(q, k, v, tables, pos)
    torch.cuda.synchronize()
    assert pa.LAUNCHES[f"paged_prefill_{kind}"] == before + 1
    want = paged_prefill_attention(q, k, v, tables, pos)
    _assert_close(got[valid], want[valid], dtype)


# ---- the quantized variants of B4 and B5: int8 / fp8-e4m3 pools with f32
# scales, against the same plain versions on the same QuantizedKV pool


def _quantized(k, v, kind):
    from ray_tpu_torch.ops.quantization import QuantizedKV, quantize_kv

    return tuple(QuantizedKV(*quantize_kv(x, kind)) for x in (k, v))


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gqa", [1, 2, 3, 6])
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
                                        (2, 24), (3, None), (3, 24),
                                        (6, None)])
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


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("k_mult", [1e3, 1e-3])
def test_quantized_prefill_kernel_large_and_small_scales(cuda, kind, k_mult):
    """Pools whose scales span many decades: K scaled by k_mult (q by its
    inverse, so the scores keep unit size while the K scale plane is large
    or small), V by a factor per token from 1e-3 to 1e3, so one kv tile
    mixes large and small V scales. The kernel folds V's scales into P
    relative to the largest it has seen; compared in units of the largest
    |v|, as the rounding of every product scales with it."""
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.ops.kv_cache import paged_prefill_attention

    dtype = torch.bfloat16
    q, k, v, tables, pos, valid = _prefill_inputs(
        cuda, torch.float32, [0, 40, 150], 100, [100, 100, 60], 2, 2, 64, 16,
        seed=11)
    gen = torch.Generator(device=cuda).manual_seed(12)
    v_mult = 10.0 ** (6 * torch.rand(*v.shape[:3], 1, generator=gen,
                                     device=cuda) - 3)
    k, v = _quantized(k * k_mult, v * v_mult, kind)
    q = (q / k_mult).to(dtype)
    got = pa.paged_prefill_attention_cuda(q, k, v, tables, pos, window=None)
    torch.cuda.synchronize()
    want = paged_prefill_attention(q, k, v, tables, pos)
    unit = v_mult.max()
    assert torch.isfinite(got[valid]).all()
    _assert_close(got[valid].float() / unit, want[valid].float() / unit,
                  dtype)


def test_quantized_wrappers_refuse_bad_pools_on_cuda(cuda):
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.ops.kv_cache import paged_attention
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
    with pytest.raises(ValueError, match="pool_head_dim"):
        pa.paged_attention_cuda(q[..., :8].contiguous(), *narrow, tables, pos)
    assert pa.LAUNCHES == before
    # head dim 8 in a 1-byte pool held at pool_head_dim 16 computes
    narrow = _padded_pool(torch.randn(3, 16, 2, 8, device=cuda),
                          torch.randn(3, 16, 2, 8, device=cuda), "fp8")
    q8 = q[..., :8].contiguous()
    got = pa.paged_attention_cuda(q8, *narrow, tables, pos)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_decode_fp8"] == before["paged_decode_fp8"] + 1
    _assert_close(got, paged_attention(q8, *narrow, tables, pos),
                  torch.float32)


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


def _llama_tiny(groups, **kw):
    from ray_tpu_torch.models.llama import LlamaConfig

    shape = {} if groups == 2 else dict(n_head=6, n_kv_head=2, d_model=96)
    return dataclasses.replace(LlamaConfig.tiny(), **shape, **kw)


@pytest.mark.parametrize("groups", [2, 3])
def test_llama_cuda_backend_matches_torch_backend(cuda, groups):
    """Tiny Llama (f32) at G 2 and 3: prefill and a decode step through
    B5/B4 against the plain backend on the same weights (1e-4), then one
    bf16 training step through B1-B3 (the kv heads repeated) against the
    plain backend at the training phase's bars (loss 1e-2, gradients 2e-2
    relative L2)."""
    from ray_tpu_torch.benchmarks.gpt_mfu import bench_batch
    from ray_tpu_torch.models.llama import Llama, llama_init
    from ray_tpu_torch.ops import attention as at
    from ray_tpu_torch.ops import paged_attention as pa

    cfg = _llama_tiny(groups, dtype=torch.float32, attention_backend="cuda")
    ref = llama_init(dataclasses.replace(cfg, attention_backend="torch"),
                     seed=0, device=cuda)
    model = Llama(cfg, cuda).load_weights(ref.weights())
    B, S, bs, NB = 2, 24, 8, 5
    tables = torch.arange(1, 1 + B * NB, dtype=torch.int32,
                          device=cuda).reshape(B, NB)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(1))
    lengths = torch.tensor([24, 13], dtype=torch.int32, device=cuda)
    out = {}
    before = dict(pa.LAUNCHES)
    for name, m in (("cuda", model), ("torch", ref)):
        shape = (cfg.n_layer, 1 + B * NB, bs, cfg.n_kv_head, cfg.head_dim)
        ck, cv = torch.zeros(shape, device=cuda), torch.zeros(shape, device=cuda)
        logits, _, _ = m.prefill(ck, cv, tokens, lengths, tables)
        step, _, _ = m.decode_step(ck, cv, logits.argmax(-1).int(), lengths,
                                   tables)
        out[name] = torch.cat([logits, step])
    assert {n: pa.LAUNCHES[n] - before[n] for n in before
            if pa.LAUNCHES[n] != before[n]} == {
        "paged_prefill": cfg.n_layer, "paged_decode": cfg.n_layer}
    assert (out["cuda"] - out["torch"]).abs().max().item() <= 1e-4

    cfg = _llama_tiny(groups, attention_backend="cuda")  # bf16 activations
    models = {"cuda": llama_init(cfg, seed=0, device=cuda, train=True)}
    models["torch"] = Llama(dataclasses.replace(cfg, attention_backend="torch"),
                            cuda, train=True)
    models["torch"].load_state_dict(models["cuda"].state_dict())
    batch = bench_batch(cfg, 2, 64, 5, cuda)
    loss, grads = {}, {}
    before = dict(at.LAUNCHES)
    for name, m in models.items():
        value = m.loss(batch)
        value.backward()
        loss[name] = value.item()
        grads[name] = {n: p.grad for n, p in m.named_parameters()}
    assert {n: at.LAUNCHES[n] - before[n] for n in before} == dict.fromkeys(
        before, cfg.n_layer)
    assert abs(loss["cuda"] - loss["torch"]) <= 1e-2
    for n, want in grads["torch"].items():
        rel = ((grads["cuda"][n] - want).float().norm()
               / want.float().norm().clamp(min=1e-30)).item()
        assert rel <= 2e-2, (n, rel)


# ---- flash attention: B1 (forward), B2 (dK/dV) and B3 (dQ), at TOL


# the tile edges of B1's tensor-core path: one row, a tile short by one,
# one row past a tile, and the training length, at every head dim
_FLASH_EDGES = [(S, D, causal) for S in (1, 63, 65, 1024)
                for D in (32, 64, 128) for causal in (True, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,D,causal", [(128, 64, True), (200, 64, True),
                                        (96, 32, False), (64, 128, True),
                                        (17, 64, False)] + _FLASH_EDGES)
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


def test_flash_attention_autograd_bf16_gqa_on_cuda(cuda):
    """bf16 through autograd, so the backward runs B2/B3's tensor-core
    tiles, with 4 query heads per kv head (the gradient of the repeated
    k/v sums back over each group). The two backends' forwards differ by
    bf16 ulps (online vs one-shot softmax), and each backward starts from
    its own o and lse, so the gradients are held by relative L2 norm, at
    the training phase's bar (2e-2), and the output elementwise."""
    from ray_tpu_torch.ops import attention as at

    gen = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(2, 8, 200, 64, generator=gen, device=cuda).bfloat16()
    k, v = (torch.randn(2, 2, 200, 64, generator=gen, device=cuda).bfloat16()
            for _ in range(2))
    g = torch.randn(2, 8, 200, 64, generator=gen, device=cuda).bfloat16()
    out = {}
    for backend in ("cuda", "torch"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = dict(at.LAUNCHES)
        o = at.flash_attention(*leaves, causal=True, backend=backend)
        o.backward(g)
        launched = {n: at.LAUNCHES[n] - before[n] for n in before}
        want = 1 if backend == "cuda" else 0
        assert launched == dict.fromkeys(launched, want)
        out[backend] = [o.detach()] + [t.grad for t in leaves]
    _assert_close(out["cuda"][0], out["torch"][0], torch.bfloat16)
    for got, want in zip(out["cuda"][1:], out["torch"][1:]):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        rel = ((got.float() - want.float()).norm()
               / want.float().norm()).item()
        assert rel <= 2e-2, rel


@pytest.mark.parametrize("S,D,causal", [(200, 64, True), (1024, 64, True),
                                        (130, 32, False), (200, 128, True)])
def test_flash_backward_large_scores(cuda, S, D, causal):
    """q times 8: most p underflow to 0 and the rest sit near 1, so the
    bf16 rounding of s - lse and of ds dominates the gradients. B2/B3 from
    the plain forward's o and lse against their plain versions. The
    tensor-core scores differ from the plain f32 product in their last
    bits, so now and then a ds rounds to the neighbouring bf16 value: that
    moves a gradient entry by one ulp of a summed term, and here the terms
    (|ds| up to about 20) reach the gradient's largest magnitude while the
    sum may cancel to far less. Each entry is held within TOL of its plain
    value or within one bf16 ulp (2^-7) of the gradient's largest entry,
    whichever is wider (measured on an NVIDIA H100 80GB HBM3, 700.00 W:
    at most 0.27% of it)."""
    from ray_tpu_torch.ops import attention as at

    gen = torch.Generator(device=cuda).manual_seed(S + D)
    q, k, v, do = (torch.randn(2, 3, S, D, generator=gen, device=cuda)
                   for _ in range(4))
    q, k, v, do = (t.bfloat16() for t in (8 * q, k, v, do))
    kw = dict(causal=causal, scale=D ** -0.5)
    o, lse = at.flash_forward_reference(q, k, v, **kw)
    grads = at.flash_backward_cuda(q, k, v, o, lse, do, **kw)
    refs = at.flash_backward_reference(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    atol, rtol = TOL[torch.bfloat16]
    for got, want in zip(grads, refs):
        want = want.float()
        diff = (got.float() - want).abs()
        bar = torch.clamp(atol + rtol * want.abs(),
                          min=2 ** -7 * want.abs().max().item())
        assert bool((diff <= bar).all()), diff.max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_is_deterministic(cuda, dtype):
    """Two launches of B2 and of B3 on the same inputs give the same bits:
    no atomics, a fixed summation order."""
    from ray_tpu_torch.ops import attention as at

    gen = torch.Generator(device=cuda).manual_seed(11)
    q, k, v, do = (torch.randn(4, 12, 1024, 64, generator=gen, device=cuda)
                   .to(dtype) for _ in range(4))
    kw = dict(causal=True, scale=64 ** -0.5)
    o, lse = at.flash_forward_cuda(q, k, v, **kw)
    delta = at.attention_delta(o, do)
    args = (q, k, v, lse, delta, do)
    runs = [(*at.flash_bwd_dkv_cuda(*args, **kw),
             at.flash_bwd_dq_cuda(*args, **kw)) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_flash_wrappers_refuse_misaligned_tensors(cuda):
    """The tensor-core kernels copy q, k, v and dO in 16-byte pieces: a
    contiguous view that starts off a 16-byte boundary is refused before
    any launch."""
    from ray_tpu_torch.ops import attention as at

    base = torch.zeros(2 * 8 * 64 + 1, device=cuda, dtype=torch.bfloat16)
    bad = base[1:].view(1, 2, 8, 64)
    ok = torch.zeros(1, 2, 8, 64, device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 8, device=cuda)
    before = dict(at.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        at.flash_forward_cuda(bad, ok, ok, causal=True, scale=1.0)
    for args in ((bad, ok, ok, lse, lse, ok), (ok, ok, ok, lse, lse, bad)):
        with pytest.raises(ValueError, match="16-byte"):
            at.flash_bwd_dkv_cuda(*args, causal=True, scale=1.0)
        with pytest.raises(ValueError, match="16-byte"):
            at.flash_bwd_dq_cuda(*args, causal=True, scale=1.0)
    assert at.LAUNCHES == before


# ---- B4/B4q as split-K flash-decoding: ranges of table entries, one block
# each, combined inside the launch by a thread-block cluster


def _decode_inputs(dev, dtype, lengths, Hkv, G, hd, bs, NB, seed):
    gen, k, v, tables = _case(dev, dtype, len(lengths), Hkv, G, hd, bs, NB,
                              [-(-n // bs) for n in lengths], seed)
    q = torch.randn(len(lengths), Hkv * G, hd, generator=gen,
                    device=dev).to(dtype)
    pos = torch.tensor([n - 1 for n in lengths], dtype=torch.int32,
                       device=dev)
    return q, k, v, tables, pos


def _boundary_lengths(B, Hkv, bs, NB):
    """Lengths at each split boundary +- 1 (the split count is the
    wrapper's, from these shapes), length 1 and a full table."""
    from ray_tpu_torch.ops.paged_attention import decode_splits, sm_count

    span = -(-NB // decode_splits(B, Hkv, NB, bs, sm_count(0))) * bs
    lengths = [1, span - 1, span, span + 1, 2 * span - 1, 2 * span + 1,
               NB * bs]
    assert len(lengths) == B
    return [min(n, NB * bs) for n in lengths]


def _check_decode(dev, dtype, q, k, v, tables, pos, key):
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.ops.kv_cache import paged_attention

    before = dict(pa.LAUNCHES)
    got = pa.paged_attention_cuda(q, k, v, tables, pos)
    torch.cuda.synchronize()
    assert {n: pa.LAUNCHES[n] - before[n] for n in before
            if pa.LAUNCHES[n] != before[n]} == {key: 1}
    _assert_close(got, paged_attention(q, k, v, tables, pos), dtype)


# block sizes 8, 16, 32 at G 1, 2, 4, 8; head dims 64, 128, 256; groups
# that are not a power of two (3) or wider than the 8 rows a pass holds
# (12); head dims that leave lanes idle (40) or use one lane a row (8)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,G,hd,NB", [
    (16, 1, 64, 64), (8, 2, 64, 64), (32, 4, 64, 32), (16, 8, 64, 64),
    (16, 1, 128, 64), (8, 4, 128, 48), (16, 2, 256, 64), (32, 8, 256, 32),
    (16, 3, 64, 64), (16, 12, 128, 40), (16, 1, 40, 64), (32, 2, 8, 20),
    (32, 3, 64, 32), (16, 6, 64, 64),
])
def test_split_decode_kernel_matches_plain(cuda, dtype, bs, G, hd, NB):
    Hkv = 2
    lengths = _boundary_lengths(7, Hkv, bs, NB)
    args = _decode_inputs(cuda, dtype, lengths, Hkv, G, hd, bs, NB,
                          seed=bs + G + hd)
    _check_decode(cuda, dtype, *args, "paged_decode")


# long contexts that really split: several ring tiles per range
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths,Hkv,G,hd,bs,NB", [
    ([4096], 12, 1, 64, 16, 256),
    ([4096, 2500], 2, 4, 128, 16, 256),
    ([4000, 17], 1, 8, 256, 32, 128),
])
def test_long_context_decode_kernel_matches_plain(cuda, dtype, lengths, Hkv,
                                                  G, hd, bs, NB):
    args = _decode_inputs(cuda, dtype, lengths, Hkv, G, hd, bs, NB, seed=21)
    _check_decode(cuda, dtype, *args, "paged_decode")


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths,Hkv,G,hd,bs,NB", [
    (None, 2, 1, 64, 16, 64),
    (None, 2, 4, 128, 8, 64),
    (None, 2, 2, 256, 32, 32),
    ([4096], 12, 1, 64, 16, 256),
    ([4096, 1000], 2, 8, 128, 16, 256),
    # Llama-125M's group (3: the four-row register path, its fourth row
    # masked) and 6, across the split boundaries, block sizes 16 and 32
    (None, 4, 3, 64, 16, 64),
    (None, 2, 3, 64, 32, 32),
    (None, 2, 6, 64, 16, 64),
])
def test_quantized_split_decode_kernel_matches_plain(cuda, kind, dtype,
                                                     lengths, Hkv, G, hd, bs,
                                                     NB):
    lengths = lengths or _boundary_lengths(7, Hkv, bs, NB)
    q, k, v, tables, pos = _decode_inputs(cuda, torch.float32, lengths, Hkv,
                                          G, hd, bs, NB, seed=hd + G)
    k, v = _quantized(k, v, kind)
    _check_decode(cuda, dtype, q.to(dtype), k, v, tables, pos,
                  f"paged_decode_{kind}")


@pytest.mark.parametrize("nsplit", [1, 2, 3, 5, 8])
def test_decode_kernel_at_every_split_count(cuda, nsplit):
    """The split count forced past the wrapper's choice: the result stays
    within TOL of the plain version, and the wrapper records the count it
    launched with."""
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.ops.kv_cache import paged_attention

    q, k, v, tables, pos = _decode_inputs(
        cuda, torch.bfloat16, [1024, 700, 129, 1], 4, 2, 64, 16, 64, seed=8)
    got = pa.paged_attention_cuda(q, k, v, tables, pos, nsplit=nsplit)
    torch.cuda.synchronize()
    assert pa.SPLITS["paged_decode"] == nsplit
    _assert_close(got, paged_attention(q, k, v, tables, pos), torch.bfloat16)


@pytest.mark.parametrize("kind", [None, "int8", "fp8"])
def test_decode_kernel_is_deterministic(cuda, kind):
    """Two calls on the same inputs give the same bits: the cluster
    combines the ranges in rank order, no atomics."""
    from ray_tpu_torch.ops import paged_attention as pa

    q, k, v, tables, pos = _decode_inputs(
        cuda, torch.float32, [4096, 1500, 700, 1], 12, 2, 64, 16, 256, seed=5)
    if kind:
        k, v = _quantized(k, v, kind)
    else:
        k, v = k.bfloat16(), v.bfloat16()
    q = q.bfloat16()
    runs = [pa.paged_attention_cuda(q, k, v, tables, pos) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("kind", [None, "int8", "fp8"])
def test_decode_kernel_is_one_launch(cuda, kind):
    """One call is one kernel on the device (no combine pass, no memset),
    and it records into a CUDA graph (no host sync, no allocation that
    depends on data) whose replay gives the eager result."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.ops import paged_attention as pa

    q, k, v, tables, pos = _decode_inputs(
        cuda, torch.float32, [1024, 900, 30, 512], 12, 1, 64, 16, 64, seed=6)
    if kind:
        k, v = _quantized(k, v, kind)
    else:
        k, v = k.bfloat16(), v.bfloat16()
    q = q.bfloat16()
    want = pa.paged_attention_cuda(q, k, v, tables, pos)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pa.paged_attention_cuda(q, k, v, tables, pos)
        torch.cuda.synchronize()
    kernels = [(e.key, e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and kernels[0][1] == 1, kernels
    assert "paged_decode" in kernels[0][0], kernels

    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        pa.paged_attention_cuda(q, k, v, tables, pos)  # warm the binding
        with torch.cuda.graph(graph, stream=stream):
            out = pa.paged_attention_cuda(q, k, v, tables, pos)
    torch.cuda.current_stream().wait_stream(stream)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


# ---- Queue C: the flash kernels at head dims they are not built for pad
# to the next built width (exact); 129-255 pad to 256, above 256 refused


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 48, 80])
def test_flash_kernels_pad_narrow_heads(cuda, dtype, D):
    from ray_tpu_torch.ops import attention as at

    gen = torch.Generator(device=cuda).manual_seed(D)
    q, k, v, do = (torch.randn(2, 3, 100, D, generator=gen, device=cuda)
                   .to(dtype) for _ in range(4))
    kw = dict(causal=True, scale=D ** -0.5)
    before = dict(at.LAUNCHES)
    o, lse = at.flash_forward_cuda(q, k, v, **kw)
    o_ref, lse_ref = at.flash_forward_reference(q, k, v, **kw)
    grads = at.flash_backward_cuda(q, k, v, o_ref, lse_ref, do, **kw)
    refs = at.flash_backward_reference(q, k, v, o_ref, lse_ref, do, **kw)
    torch.cuda.synchronize()
    assert {n: at.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_dkv": 1, "flash_bwd_dq": 1}
    _assert_close(o, o_ref, dtype)
    _assert_close(lse, lse_ref, dtype)
    for got, want in zip(grads, refs):
        assert got.shape == want.shape
        _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,D,causal", [(100, 160, True), (100, 160, False),
                                        (65, 256, True), (130, 256, False),
                                        (1, 256, True),
                                        (70, 264, True), (70, 264, False),
                                        (65, 320, True), (65, 320, False),
                                        (40, 512, True), (40, 512, False)])
def test_flash_kernels_at_wide_heads_match_plain(cuda, dtype, S, D, causal):
    """B1-B3 at head dims 129-256 (the CUDA-core tiles of 32 rows; 160
    zero-padded to 256 at the true scale) and above 256 (the same tiles
    in column chunks of 256, unpadded) against their plain versions at
    the true D."""
    from ray_tpu_torch.ops import attention as at

    gen = torch.Generator(device=cuda).manual_seed(D + S)
    q, k, v, do = (torch.randn(2, 3, S, D, generator=gen, device=cuda)
                   .to(dtype) for _ in range(4))
    kw = dict(causal=causal, scale=D ** -0.5)
    before = dict(at.LAUNCHES)
    o, lse = at.flash_forward_cuda(q, k, v, **kw)
    o_ref, lse_ref = at.flash_forward_reference(q, k, v, **kw)
    grads = at.flash_backward_cuda(q, k, v, o_ref, lse_ref, do, **kw)
    refs = at.flash_backward_reference(q, k, v, o_ref, lse_ref, do, **kw)
    torch.cuda.synchronize()
    assert {n: at.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_dkv": 1, "flash_bwd_dq": 1}
    _assert_close(o, o_ref, dtype)
    _assert_close(lse, lse_ref, dtype)
    for got, want in zip(grads, refs):
        assert got.shape == want.shape
        _assert_close(got, want, dtype)


# ---- heads above 256: B4/B4q and B5/B5q in column chunks of 256, every
# pool, pools at pool_head_dim as the engine allocates them
@pytest.mark.parametrize("kind", [None, "int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,G", [(288, 3), (512, 1)])
def test_paged_kernels_above_256_match_plain(cuda, kind, dtype, hd, G):
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.ops.kv_cache import (
        paged_attention,
        paged_prefill_attention,
    )

    suffix = f"_{kind}" if kind else ""
    pool_dtype = torch.float32 if kind else dtype
    lengths = _boundary_lengths(7, 2, 16, 24)
    q, k, v, tables, pos = _decode_inputs(cuda, pool_dtype, lengths, 2, G,
                                          hd, 16, 24, seed=hd)
    k, v = _padded_pool(k, v, kind)
    before = dict(pa.LAUNCHES)
    got = pa.paged_attention_cuda(q.to(dtype), k, v, tables, pos)
    torch.cuda.synchronize()
    _assert_close(got, paged_attention(q.to(dtype), k, v, tables, pos),
                  dtype)
    q, k, v, tables, pos, valid = _prefill_inputs(
        cuda, pool_dtype, [0, 5, 40], 45, [45, 30, 12], 2, G, hd, 16)
    k, v = _padded_pool(k, v, kind)
    for window in (None, 24):
        got = pa.paged_prefill_attention_cuda(q.to(dtype), k, v, tables, pos,
                                              window=window)
        torch.cuda.synchronize()
        want = paged_prefill_attention(q.to(dtype), k, v, tables, pos,
                                       window=window)
        _assert_close(got[valid], want[valid], dtype)
    assert {n: pa.LAUNCHES[n] - before[n] for n in before
            if pa.LAUNCHES[n] != before[n]} == {
        "paged_decode" + suffix: 1, "paged_prefill" + suffix: 2}


def test_gpt_tiny_trains_on_cuda_with_padded_heads(cuda):
    """GPTConfig.tiny() (head dim 16) through B1-B3 with padded heads: the
    loss and every gradient of one step against the plain backend on the
    same weights, at the training phase's bars (loss 1e-2, gradient 2e-2
    relative L2), then a few AdamW steps with a falling loss."""
    from ray_tpu_torch.benchmarks.gpt_mfu import (
        bench_batch,
        make_optimizer,
        train_step,
    )
    from ray_tpu_torch.models.gpt import GPT, GPTConfig, gpt_init
    from ray_tpu_torch.ops import attention as at

    cfg = dataclasses.replace(GPTConfig.tiny(), attention_backend="cuda")
    assert cfg.head_dim not in at.HEAD_DIMS
    models = {"cuda": gpt_init(cfg, seed=0, device=cuda, train=True)}
    models["torch"] = GPT(dataclasses.replace(cfg, attention_backend="torch"),
                          cuda, train=True)
    models["torch"].load_state_dict(models["cuda"].state_dict())
    batch = bench_batch(cfg, 2, 64, 5, cuda)
    loss, grads = {}, {}
    before = dict(at.LAUNCHES)
    for name, m in models.items():
        value = m.loss(batch)
        value.backward()
        loss[name] = value.item()
        grads[name] = {n: p.grad for n, p in m.named_parameters()}
    assert {n: at.LAUNCHES[n] - before[n] for n in before} == dict.fromkeys(
        before, cfg.n_layer)
    assert abs(loss["cuda"] - loss["torch"]) <= 1e-2
    for n, want in grads["torch"].items():
        rel = ((grads["cuda"][n] - want).float().norm()
               / want.float().norm().clamp(min=1e-30)).item()
        assert rel <= 2e-2, (n, rel)
    model = models["cuda"]
    model.zero_grad(set_to_none=True)
    opt = make_optimizer(model)
    losses = [train_step(model, opt, batch).item() for _ in range(4)]
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]


# ---- the engine's decode step as a CUDA graph (serve/llm/decode.py) and
# the lag-1 pipeline on the card

LOGIT_TOL = 0.1  # chip_smoke.py's bar for logits of two bf16 paths


def _graph_executor(dev, kind, num_blocks=64):
    """An executor over a small bf16 GPT at GPT-2's head dim (64), its
    pool holding three sequences prefilled from their prompts."""
    import numpy as np

    from ray_tpu_torch.models.gpt import GPTConfig
    from ray_tpu_torch.serve.llm.executor import SingleDeviceExecutor
    from ray_tpu_torch.serve.llm.kv_cache import KVCacheConfig, PagedKVCache

    cfg = GPTConfig(vocab_size=512, max_seq_len=256, n_layer=2, n_head=4,
                    d_model=256, d_mlp=1024, quantization=kind)
    cache = PagedKVCache(KVCacheConfig(
        n_layer=cfg.n_layer, n_kv_head=cfg.n_head, head_dim=cfg.head_dim,
        num_blocks=num_blocks, block_size=16, dtype=cfg.dtype, device=dev,
        quantization=kind))
    ex = SingleDeviceExecutor(cfg, cache, seed=0)
    rng = np.random.default_rng(0)
    lengths = np.array([40, 7, 100, 1], np.int32)  # row 3: padding
    tokens = rng.integers(0, 512, (4, 128)).astype(np.int32)
    tables = np.zeros((4, 8), np.int32)
    tables[:3] = np.arange(1, 25, dtype=np.int32).reshape(3, 8)
    ids = ex.sync_tokens(ex.prefill(tokens, lengths, tables))
    return ex, ids, lengths, tables


def _sample_args(B, sampled):
    import numpy as np

    temp = np.zeros(B, np.float32)
    if sampled:
        temp[:3] = [0.8, 0.0, 1.2]
    return {"seeds": np.arange(B, dtype=np.int64) + 7, "temperature": temp,
            "top_k": np.zeros(B, np.int32),
            "top_p": np.full(B, 0.9 if sampled else 1.0, np.float32)}


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("kind", [None, "int8", "fp8"])
def test_decode_graph_matches_eager_step(cuda, kind, sampled):
    """A decode step replayed from its captured graph gives the eager
    step's ids on the same inputs, and a graph of the logits step gives
    the eager logits within the engine bar; each replay launches its 2 B4
    kernels on the device (from a profiler trace), the wrapper counting
    only the capture's eager warm-up run."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.benchmarks.engine_profile import paged_launches
    from ray_tpu_torch.ops import paged_attention as pa

    ex, first, lengths, tables = _graph_executor(cuda, kind)
    g = ex.stage_decode(first, lengths, tables, _sample_args(4, sampled))
    assert g.sampled == sampled
    eager = ex.fns.step(g.inputs, sampled).clone()
    key = "paged_decode" + (f"_{kind}" if kind else "")
    before = pa.LAUNCHES[key]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graphed = g.run().clone()
        again = g.run().clone()
        torch.cuda.synchronize()
    assert g.graph is not None and ex.fns.graphs_captured == 1
    assert torch.equal(graphed, eager) and torch.equal(again, eager)
    n_layer = ex.model.cfg.n_layer
    assert pa.LAUNCHES[key] == before + n_layer  # the warm-up run
    # on the device: the warm-up run, then each replay
    assert paged_launches(prof) == {key: 3 * n_layer}

    # the logits of the same step, eager and from a graph
    model, cache = ex.model, ex.cache
    args = (g.inputs["tokens"], g.inputs["positions"], g.inputs["tables"])
    want, _, _ = model.decode_step(cache.k, cache.v, *args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        model.decode_step(cache.k, cache.v, *args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=ex.fns.pool):
        out, _, _ = model.decode_step(cache.k, cache.v, *args)
    graph.replay()
    torch.cuda.synchronize()
    assert (out - want).abs().max().item() <= LOGIT_TOL


@pytest.mark.parametrize("kind", [None, "int8"])
def test_two_lag1_steps_feed_on_the_device(cuda, kind):
    """Step N+1 fed from step N's ids on the device (never synced first)
    gives the ids of two eager steps fed from the host, and each sync
    reads its own step's ids."""
    ex, first, lengths, tables = _graph_executor(cuda, kind)
    ref, _, _, _ = _graph_executor(cuda, kind)
    sample = _sample_args(4, True)
    step1 = ex.decode_step(first, lengths, tables, sample=sample)
    step2 = ex.decode_step(step1, lengths + 1, tables, sample=sample)
    got1, got2 = ex.sync_tokens(step1), ex.sync_tokens(step2)
    want1 = ref.sync_tokens(ref.decode_step(first, lengths, tables,
                                            sample=sample))
    want2 = ref.sync_tokens(ref.decode_step(want1, lengths + 1, tables,
                                            sample=sample))
    assert (got1[:3] == want1[:3]).all() and (got2[:3] == want2[:3]).all()
    assert ex.fns.replays == 2 and ex.fns.graphs_captured == 1


@pytest.mark.parametrize("prefix_caching", [False, True])
def test_engine_decode_steps_make_no_host_sync(cuda, prefix_caching):
    """A warm engine pass runs every decode step from a captured graph,
    with no host sync inside a dispatch (``set_sync_debug_mode("error")``
    around each), and gives the first pass's streams. With prefix caching
    on (the default) the second pass hits the first's full prompt blocks
    (2 of [5] * 40, 5 of [7] * 90) and prefills only their suffixes at
    true starts; its streams still equal the cold pass's, since each
    row's attention (B5) and every matmul row is computed alone, so its
    values do not depend on the chunk around it. A hit block is freed
    without being allocated in that pass, so ``freed_total`` exceeds
    ``allocated_total`` by the hits, as in the JAX cache."""
    from ray_tpu_torch.models.gpt import GPTConfig
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    cfg = GPTConfig(vocab_size=512, max_seq_len=256, n_layer=2, n_head=4,
                    d_model=256, d_mlp=1024)
    eng = LLMEngine(EngineConfig(model="gpt", model_config=cfg, num_blocks=128,
                                 prefix_caching=prefix_caching),
                    auto_step=False)
    reqs = [([1, 2, 3], {}), ([5] * 40, {"temperature": 0.9, "seed": 3}),
            ([7] * 90, {})]

    def run():
        streams = [eng.submit(p, max_new_tokens=24, **kw) for p, kw in reqs]
        while eng.step():
            pass
        return [list(s) for s in streams]

    first = run()
    graphs, steps = eng.fns.graphs_captured, eng.num_decode_steps
    replays = eng.fns.replays
    dispatch = eng.executor.decode_step

    def strict(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    eng.executor.decode_step = strict
    assert run() == first
    hits = 7 if prefix_caching else 0
    st = eng.stats()
    assert st["prefix_hit_blocks"] == hits and st["cow_blocks"] == 0
    assert eng.fns.graphs_captured == graphs  # nothing captured again
    assert eng.fns.replays - replays == eng.num_decode_steps - steps > 0
    assert any(r.get("sync_lag") == 1 for r in eng.debug_dump()["steps"])
    c = eng.cache
    assert c.used_blocks == 0 and c.reserved_blocks == 0
    assert c.available_blocks == c.cfg.usable_blocks
    snap = c.debug_snapshot()
    assert snap["freed_total"] == snap["allocated_total"] + hits
