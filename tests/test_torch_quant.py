"""Quantized serving in the port (``ray_tpu_torch.ops.quantization`` and
the quantized pool, model and engine paths) against the JAX package.

Quantization itself is held bit for bit: data and scales of
``quantize_kv`` / ``quantize_weight`` / ``quantize_params`` (an all-zero
row included), the dequant ``QuantizedTensor.to`` against JAX's
``astype``, and the data and scale planes a quantized ``write_kv`` lands.
The plain quantized attentions (the yardsticks of the quantized B4/B5
kernels) match the Pallas kernels in interpret mode on the same
``QuantizedKV`` pool at the f32 tolerance of ``test_torch_ops.py``; the
model's prefill and decode over a quantized pool match JAX's at the f32
tolerance of ``test_torch_gpt.py`` (the same pool bytes, scales within
1e-5 relative); the engine's streams equal the JAX
quantized engine's. Tiny f32 config, inputs from numpy seeds.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

KINDS = ["int8", "fp8"]
TOL_OPS = 1e-5  # f32 attention, one-shot vs online softmax order
TOL_GPT = 1e-4  # f32 through two layers
BUCKETS = dict(block_size=8, num_blocks=64, batch_buckets=(4,),
               length_buckets=(32,))


@pytest.fixture(autouse=True)
def _cpu(jax_cpu):
    return jax_cpu


def _t(x) -> torch.Tensor:
    """numpy / JAX array -> torch, fp8 (ml_dtypes) carried as its bytes."""
    x = np.ascontiguousarray(np.asarray(x))
    if x.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(x.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(x.copy())


def _same_bits(port: torch.Tensor, ref) -> None:
    ref = ref if isinstance(ref, torch.Tensor) else _t(ref)
    assert port.dtype == ref.dtype and port.shape == ref.shape
    view = torch.uint8 if port.element_size() == 1 else torch.int32
    assert torch.equal(port.contiguous().view(view), ref.view(view))


def _jax_kv(x, kind):
    from ray_tpu.ops.quantization import quantize_kv

    import jax.numpy as jnp
    return quantize_kv(jnp.asarray(x), kind)


def _configs():
    import jax.numpy as jnp
    from ray_tpu.models.gpt import GPTConfig as JaxGPTConfig

    from ray_tpu_torch.models.gpt import GPTConfig

    jcfg = dataclasses.replace(JaxGPTConfig.tiny(), dtype=jnp.float32,
                               attention="xla", attention_backend="xla")
    tcfg = dataclasses.replace(GPTConfig.tiny(), dtype=torch.float32,
                               attention_backend="torch")
    return jcfg, tcfg


@pytest.fixture(scope="module")
def weights():
    import jax
    from ray_tpu.models.gpt import gpt_init

    jcfg, tcfg = _configs()
    tree = jax.tree.map(np.asarray, gpt_init(jax.random.PRNGKey(1), jcfg))
    return jcfg, tcfg, tree


def test_resolve_quantization_validates():
    from ray_tpu_torch.ops.quantization import quant_dtype, resolve_quantization

    assert resolve_quantization(None) is None
    assert resolve_quantization("") is None
    assert resolve_quantization("int8") == "int8"
    assert resolve_quantization("fp8") == "fp8"
    with pytest.raises(ValueError, match="int4"):
        resolve_quantization("int4")
    assert quant_dtype("int8") == torch.int8
    assert quant_dtype("fp8") == torch.float8_e4m3fn


@pytest.mark.parametrize("kind", KINDS)
def test_quantize_kv_and_weight_bit_identical(kind):
    import jax.numpy as jnp
    from ray_tpu.ops.quantization import quantize_weight

    from ray_tpu_torch.ops import quantization as q

    rng = np.random.default_rng(0)
    x = (rng.normal(size=(5, 8, 2, 16)) * 3).astype(np.float32)
    x[1, 2, 0] = 0.0  # an all-zero row: unit scale, zero data
    data, scale = q.quantize_kv(_t(x), kind)
    jdata, jscale = _jax_kv(x, kind)
    _same_bits(data, jdata)
    _same_bits(scale, jscale)
    assert not data[1, 2, 0].view(torch.uint8).any()
    assert scale[1, 2, 0].item() == np.float32(1) / np.float32(q.quant_max(kind))
    w = rng.normal(size=(24, 40)).astype(np.float32) * 0.02
    w[:, 3] = 0.0
    for axis in (0, 1):
        got = q.quantize_weight(_t(w), axis, kind)
        want = quantize_weight(jnp.asarray(w), axis, kind)
        _same_bits(got.data, want.data)
        _same_bits(got.scale, want.scale)
    # bf16 input quantizes from its f32 value, as JAX's astype(f32)
    xb = _t(x).to(torch.bfloat16)
    data, scale = q.quantize_kv(xb, kind)
    jdata, jscale = _jax_kv(jnp.asarray(x).astype(jnp.bfloat16), kind)
    _same_bits(data, jdata)
    _same_bits(scale, jscale)


@pytest.mark.parametrize("kind", KINDS)
def test_quantize_params_and_convert_bit_identical(weights, kind):
    """The port quantizing converted f32 weights over ``gpt_quant_axes``
    gives the bytes of JAX's ``quantize_params``, which ``convert`` carries
    across unchanged; ``QuantizedTensor.to`` equals JAX ``astype``."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.models.gpt import gpt_quant_axes
    from ray_tpu.ops.quantization import QuantizedTensor as JaxQT
    from ray_tpu.ops.quantization import quantize_params

    from ray_tpu_torch.convert import gpt_params_from_numpy
    from ray_tpu_torch.models.gpt import gpt_quant_axes as port_axes
    from ray_tpu_torch.ops import quantization as q

    jcfg, tcfg, tree = weights
    jq = quantize_params(jax.tree.map(jnp.asarray, tree),
                         gpt_quant_axes(jcfg), kind)
    jq_np = jax.tree.map(np.asarray, jq)
    ours = q.quantize_params(gpt_params_from_numpy(tree, tcfg),
                             port_axes(tcfg), kind)
    carried = gpt_params_from_numpy(jq_np, tcfg)
    assert set(ours) == set(carried)
    n_quant = 0
    for name, got in ours.items():
        other = carried[name]
        if isinstance(got, q.QuantizedTensor):
            n_quant += 1
            _same_bits(got.data, other.data)
            _same_bits(got.scale, other.scale)
        else:
            assert torch.equal(got, other), name
    assert n_quant == 2 + 4 * tcfg.n_layer  # wte, wpe, four matmuls a layer
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        got = ours["blocks.1.mlp_in_w"].to(dtype)
        want = jq["blocks"]["mlp_in_w"].astype(jdt)[1]
        _same_bits(got.float(), np.asarray(want.astype(jnp.float32)))
        assert isinstance(jq["wte"], JaxQT)
        got = ours["wte"].rows(torch.tensor([3, 0, 7])).to(dtype)
        want = jq["wte"].astype(jdt)[jnp.asarray([3, 0, 7])]
        _same_bits(got.float(), np.asarray(want.astype(jnp.float32)))


def _tables(rng, lengths, bs, NB):
    ids = 1 + rng.permutation(len(lengths) * NB)
    rows, nxt = [], 0
    for n in lengths:
        need = -(-n // bs)
        rows.append(list(ids[nxt:nxt + need]) + [0] * (NB - need))
        nxt += need
    return np.asarray(rows, np.int32)


def _pools(rng, kind, num_blocks, bs, Hkv, hd):
    """A quantized pool pair: (JAX QuantizedKV k, v), (port k, v)."""
    from ray_tpu.ops.quantization import QuantizedKV as JaxKV

    from ray_tpu_torch.ops.quantization import QuantizedKV

    jax_side, port_side = [], []
    for _ in range(2):
        x = rng.normal(size=(num_blocks, bs, Hkv, hd)).astype(np.float32)
        data, scale = _jax_kv(x, kind)
        jax_side.append(JaxKV(data, scale))
        port_side.append(QuantizedKV(_t(data), _t(scale)))
    return jax_side, port_side


@pytest.mark.parametrize("kind", KINDS)
def test_quantized_write_and_gather_kv_match_jax(kind):
    import jax.numpy as jnp
    from ray_tpu.ops.kv_cache import gather_kv, write_kv

    from ray_tpu_torch.ops import kv_cache as port

    rng = np.random.default_rng(2)
    bs, NB, Hkv, hd = 4, 3, 2, 16
    tables = _tables(rng, [10, 7], bs, NB)
    (jk, jv), (tk, tv) = _pools(rng, kind, 1 + 2 * NB, bs, Hkv, hd)
    # a layer view: leading-axis indexing slices data and scale together
    assert tk.ndim == 4 and tuple(tk.shape) == tuple(jk.shape)
    assert tk[2].shape == tk.data.shape[1:] and torch.equal(
        tk[2].scale, tk.scale[2])
    pos = np.broadcast_to(np.arange(6, dtype=np.int32) + 3, (2, 6)).copy()
    valid = np.array([[1, 1, 1, 1, 1, 1], [1, 1, 1, 1, 0, 0]], bool)
    kk, vv = (rng.normal(size=(2, 6, Hkv, hd)).astype(np.float32)
              for _ in range(2))
    kk[0, 1, 1] = 0.0
    jk, jv = write_kv(jk, jv, jnp.asarray(kk), jnp.asarray(vv),
                      jnp.asarray(pos), jnp.asarray(tables),
                      valid=jnp.asarray(valid))
    port.write_kv(tk, tv, _t(kk), _t(vv), _t(pos), _t(tables),
                  valid=_t(valid))
    dk = rng.normal(size=(2, Hkv, hd)).astype(np.float32)
    dpos = np.array([9, 6], np.int32)
    jk, jv = write_kv(jk, jv, jnp.asarray(dk), jnp.asarray(-dk),
                      jnp.asarray(dpos), jnp.asarray(tables))
    port.write_kv(tk, tv, _t(dk), _t(-dk), _t(dpos), _t(tables))
    for got, want in ((tk, jk), (tv, jv)):
        # block 0 takes every padding write (order unspecified)
        _same_bits(got.data[1:], np.asarray(want.data)[1:])
        _same_bits(got.scale[1:], np.asarray(want.scale)[1:])
    gk, gv = gather_kv(jk, jv, jnp.asarray(tables))
    pk, pv = port.gather_kv(tk, tv, _t(tables))
    live = np.repeat(tables != 0, bs, axis=1)
    _same_bits(pk[_t(live)], np.asarray(gk)[live])
    _same_bits(pv[_t(live)], np.asarray(gv)[live])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("gqa", [1, 2])
def test_quantized_paged_attention_plain_matches_jax(kind, gqa):
    import jax.numpy as jnp
    from ray_tpu.ops.kv_cache import paged_attention
    from ray_tpu.ops.paged_attention import paged_attention_pallas

    from ray_tpu_torch.ops.kv_cache import paged_attention as port

    rng = np.random.default_rng(10 + gqa)
    lengths = [1, 6, 18, 32]
    Hkv, hd, bs, NB = 2, 16, 8, 4
    tables = _tables(rng, lengths, bs, NB)
    (jk, jv), (tk, tv) = _pools(rng, kind, 1 + len(lengths) * NB, bs, Hkv,
                                hd)
    q = rng.normal(size=(len(lengths), Hkv * gqa, hd)).astype(np.float32)
    pos = np.asarray(lengths, np.int32) - 1
    out = port(_t(q), tk, tv, _t(tables), _t(pos)).numpy()
    args = (jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(pos))
    for ref in (paged_attention(*args),
                paged_attention_pallas(*args, interpret=True)):
        assert float(np.max(np.abs(out - np.asarray(ref)))) <= TOL_OPS


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("gqa,window", [(1, None), (2, None), (2, 5)])
def test_quantized_paged_prefill_plain_matches_jax(kind, gqa, window):
    import jax.numpy as jnp
    from ray_tpu.ops.kv_cache import paged_prefill_attention
    from ray_tpu.ops.paged_attention import paged_prefill_attention_pallas

    from ray_tpu_torch.ops.kv_cache import paged_prefill_attention as port

    rng = np.random.default_rng(20 + gqa)
    starts = np.array([0, 3, 9], np.int32)
    S = 12
    lens = np.array([12, 7, 10], np.int32)
    Hkv, hd, bs, NB = 2, 16, 8, 3
    tables = _tables(rng, list(starts + S), bs, NB)
    (jk, jv), (tk, tv) = _pools(rng, kind, 1 + len(starts) * NB, bs, Hkv,
                                hd)
    q = rng.normal(size=(3, S, Hkv * gqa, hd)).astype(np.float32)
    pos = starts[:, None] + np.arange(S, dtype=np.int32)[None, :]
    pos = np.where(np.arange(S)[None, :] < lens[:, None], pos, 0)
    pos = pos.astype(np.int32)
    out = port(_t(q), tk, tv, _t(tables), _t(pos), window=window).numpy()
    args = (jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(pos))
    for ref in (paged_prefill_attention(*args, window=window),
                paged_prefill_attention_pallas(*args, window=window,
                                               q_block=8, interpret=True)):
        assert float(np.max(np.abs(out - np.asarray(ref)))) <= TOL_OPS


@pytest.mark.parametrize("kind", KINDS)
def test_quantized_prefill_and_decode_match_jax(weights, kind):
    """Fresh prefill (which must attend the quantized pool, not the fresh
    k/v), chunked prefill and a decode step of the quantized model: logits
    and the written data and scale planes against JAX's."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.models.gpt import gpt_decode_step, gpt_prefill, gpt_quant_axes
    from ray_tpu.ops.quantization import QuantizedKV as JaxKV
    from ray_tpu.ops.quantization import quant_dtype, quantize_params

    from ray_tpu_torch.convert import gpt_params_from_numpy
    from ray_tpu_torch.models.gpt import GPT
    from ray_tpu_torch.ops.quantization import QuantizedKV

    jcfg, tcfg, tree = weights
    jcfg = dataclasses.replace(jcfg, quantization=kind)
    tcfg = dataclasses.replace(tcfg, quantization=kind)
    jq = quantize_params(jax.tree.map(jnp.asarray, tree),
                         gpt_quant_axes(jcfg), kind)
    model = GPT(tcfg, "cpu").load_weights(
        gpt_params_from_numpy(jax.tree.map(np.asarray, jq), tcfg))
    rng = np.random.default_rng(5)
    B, S1, S2, bs, NB = 2, 16, 8, 8, 5
    tables = (1 + rng.permutation(B * NB)).reshape(B, NB).astype(np.int32)
    shape = (jcfg.n_layer, 1 + B * NB, bs, jcfg.n_head, jcfg.head_dim)

    def jax_pool():
        return JaxKV(jnp.zeros(shape, quant_dtype(kind)),
                     jnp.zeros(shape[:-1], jnp.float32))

    def port_pool():
        return QuantizedKV(_t(np.zeros(shape, np.asarray(
            jnp.zeros((), quant_dtype(kind))).dtype)),
            torch.zeros(shape[:-1]))

    jk, jv = jax_pool(), jax_pool()
    tk, tv = port_pool(), port_pool()

    def both(jax_out, port_out):
        (jl, jk2, jv2), (tl, tk2, tv2) = jax_out, port_out
        assert float(np.max(np.abs(tl.numpy() - np.asarray(jl)))) <= TOL_GPT
        for got, want in ((tk2, jk2), (tv2, jv2)):
            # the same quantized bytes; the scales carry the f32 noise of
            # the k/v they came from (matmul sums in another order)
            _same_bits(got.data[:, 1:], np.asarray(want.data)[:, 1:])
            ws = np.asarray(want.scale)[:, 1:]
            err = np.abs(got.scale[:, 1:].numpy() - ws)
            assert bool((err <= 1e-5 * np.abs(ws)).all())  # unwritten: 0
        return jk2, jv2

    toks = rng.integers(0, jcfg.vocab_size, (B, S1)).astype(np.int32)
    lens = np.array([16, 11], np.int32)
    jk, jv = both(
        gpt_prefill(jq, jk, jv, jnp.asarray(toks), jnp.asarray(lens),
                    jnp.asarray(tables), jcfg),
        model.prefill(tk, tv, _t(toks), _t(lens), _t(tables)))
    toks2 = rng.integers(0, jcfg.vocab_size, (B, S2)).astype(np.int32)
    lens2 = np.array([8, 5], np.int32)
    jk, jv = both(
        gpt_prefill(jq, jk, jv, jnp.asarray(toks2), jnp.asarray(lens2),
                    jnp.asarray(tables), jcfg, start=jnp.asarray(lens)),
        model.prefill(tk, tv, _t(toks2), _t(lens2), _t(tables),
                      start=_t(lens)))
    step = rng.integers(0, jcfg.vocab_size, B).astype(np.int32)
    pos = (lens + lens2).astype(np.int32)
    both(
        gpt_decode_step(jq, jk, jv, jnp.asarray(step), jnp.asarray(pos),
                        jnp.asarray(tables), jcfg),
        model.decode_step(tk, tv, _t(step), _t(pos), _t(tables)))


def _run(engine, requests, max_new_tokens=8):
    streams = [engine.submit(p, max_new_tokens=max_new_tokens, **kw)
               for p, kw in requests]
    while engine.step():
        pass
    return [list(s) for s in streams]


@pytest.mark.parametrize("kind", KINDS)
def test_quantized_engine_streams_match_jax_engine(weights, kind):
    """Greedy streams and one sampled stream of the port's quantized
    engine equal the JAX quantized engine's, whether the port quantizes
    the converted f32 weights itself or is handed JAX's quantized ones;
    the pool is whole at the end and holds 1-byte data plus f32 scales."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.models.gpt import gpt_quant_axes
    from ray_tpu.ops.quantization import quantize_params
    from ray_tpu.serve.llm import EngineConfig as JaxEngineConfig
    from ray_tpu.serve.llm import LLMEngine as JaxLLMEngine

    from ray_tpu_torch.convert import gpt_params_from_numpy
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    jcfg, tcfg, tree = weights
    rng = np.random.default_rng(0)
    requests = [(rng.integers(0, 512, n).tolist(), kw) for n, kw in (
        (5, {}), (19, {"temperature": 0.8, "top_p": 0.9, "seed": 11}),
        (12, {}), (9, {}))]
    jax_engine = JaxLLMEngine(
        JaxEngineConfig(model="gpt", model_config=jcfg, prefix_caching=False,
                        attention_backend="xla", quantization=kind,
                        prefill_chunk_tokens=8, **BUCKETS),
        params=jax.tree.map(jnp.asarray, tree), auto_step=False)
    want = _run(jax_engine, requests)
    jax_engine.shutdown()
    jq = jax.tree.map(np.asarray, quantize_params(
        jax.tree.map(jnp.asarray, tree), gpt_quant_axes(jcfg), kind))
    for params in (gpt_params_from_numpy(tree, tcfg),
                   gpt_params_from_numpy(jq, tcfg)):
        engine = LLMEngine(
            EngineConfig(model="gpt", model_config=tcfg, device="cpu",
                         quantization=kind, prefill_chunk_tokens=8,
                         **BUCKETS),
            params=params, auto_step=False)
        assert engine.executor.quantization == kind
        assert engine.model_cfg.quantization == kind
        assert _run(engine, requests) == want
        c = engine.cache
        assert c.available_blocks == c.cfg.usable_blocks and c.reserved_blocks == 0
        n = tcfg.n_layer * BUCKETS["num_blocks"] * BUCKETS["block_size"] \
            * tcfg.n_head
        assert c.nbytes() == 2 * n * (tcfg.head_dim + 4)


@pytest.mark.parametrize("kind", KINDS)
def test_quantized_engine_random_weights_quantize_f32_init(kind):
    """With no params the executor quantizes an f32 init from the seed,
    not the bf16 serving copy; the weights take about a quarter of the f32
    bytes (int8 / fp8 data plus per-channel scales)."""
    from ray_tpu_torch.models.gpt import GPTConfig, gpt_init, gpt_quant_axes
    from ray_tpu_torch.ops.quantization import QuantizedTensor, quantize_params
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    cfg = GPTConfig.tiny()  # bf16 serving
    engine = LLMEngine(EngineConfig(model="gpt", model_config=cfg,
                                    device="cpu", seed=3, quantization=kind,
                                    **BUCKETS),
                       auto_step=False)
    f32 = gpt_init(dataclasses.replace(cfg, dtype=torch.float32), 3, "cpu")
    want = quantize_params(f32.weights(), gpt_quant_axes(cfg), kind)
    got = engine.executor.model.weights()
    nbytes = 0
    for name, w in got.items():
        if isinstance(w, QuantizedTensor):
            assert torch.equal(w.data.view(torch.uint8),
                               want[name].data.view(torch.uint8)), name
            assert torch.equal(w.scale, want[name].scale), name
            nbytes += w.nbytes()
        else:
            nbytes += w.numel() * w.element_size()
    f32_bytes = sum(w.numel() * 4 for w in f32.weights().values())
    assert nbytes < 0.3 * f32_bytes
    assert len(engine.generate([1, 2, 3], max_new_tokens=4)) == 4


@pytest.mark.parametrize("kind", KINDS)
def test_perplexity_ratio_on_dequantized_weights(weights, kind):
    """Teacher-forced loss on the port's dequantized weights stays within
    5% perplexity of f32 (the JAX package's perplexity gate)."""
    from ray_tpu_torch.convert import gpt_params_from_numpy
    from ray_tpu_torch.models.gpt import GPT, gpt_quant_axes
    from ray_tpu_torch.ops.quantization import QuantizedTensor, quantize_params

    _, tcfg, tree = weights
    params = gpt_params_from_numpy(tree, tcfg)
    deq = {name: (w.to(torch.float32) if isinstance(w, QuantizedTensor)
                  else w)
           for name, w in quantize_params(params, gpt_quant_axes(tcfg),
                                          kind).items()}
    rng = np.random.default_rng(0)
    batch = {"tokens": _t(rng.integers(0, tcfg.vocab_size, (4, 33)))}
    with torch.no_grad():
        base = GPT(tcfg, "cpu").load_weights(params).loss(batch).item()
        quant = GPT(tcfg, "cpu").load_weights(deq).loss(batch).item()
    assert float(np.exp(quant - base)) <= 1.05
