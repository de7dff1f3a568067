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


def test_prefill_wrapper_refuses_wide_bf16_heads(cuda):
    from ray_tpu_torch.ops import paged_attention as pa

    q, k, v, tables, pos, _ = _prefill_inputs(
        cuda, torch.bfloat16, [0], 8, [8], 1, 1, 256, 16)
    before = dict(pa.LAUNCHES)
    with pytest.raises(ValueError, match="head_dim up to 128"):
        pa.paged_prefill_attention_cuda(q, k, v, tables, pos)
    assert pa.LAUNCHES == before
    # an f32 q keeps the CUDA-core walk, which takes heads up to 256
    got = pa.paged_prefill_attention_cuda(q.float(), k.float(), v.float(),
                                          tables, pos)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()


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
