"""The port's Mixture-of-Experts (``ray_tpu_torch.ops.moe``, Llama with
``num_experts > 0``) against the JAX package's on the CPU, on the same
numpy-seeded inputs and converted weights.

- ``moe_forward``: y and the aux loss within 1e-5 at f32 (top_k 1 and 2,
  T not divisible by E, capacity factor 0.5 with drops), and a bf16 case
  within BF16_TOL; the routing (``moe_route``) equal to the one the
  reference computes inline (``ray_tpu/ops/moe.py:66-78``);
  ``moe_reference_dense`` and the index dispatch with no drops against
  it; the gradients in x, router, w_in and w_out against ``jax.grad``.
- Llama ``tiny_moe``: the config field by field, the loss (fused and
  unfused, with remat) and every gradient, the logits and the summed aux
  loss against ``llama_loss`` / ``llama_forward``; fresh and chunked
  prefill, decode and verify logits against ``llama_prefill`` /
  ``llama_decode_step`` / ``llama_verify_step`` with padding rows and
  columns in the batch (they are routed and take capacity).
- The engine: ``EngineConfig(model="llama", model_config=tiny_moe)``
  streams equal the JAX engine's under the same schedule (MoE routing
  depends on the batch): greedy and sampled requests joining a part-empty
  bucket, int8 (the experts unquantized, the quant axes JAX's),
  ``speculative_k=4``, and a prefix hit.
- Conversion: the MoE tree both ways.

Every test carries a ``timeout`` ceiling."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

TOL = 1e-5       # f32: the op, its aux loss and its gradients
MODEL_TOL = 1e-4  # f32 logits and pool of the serving paths (GPT's bar)
# bf16: |y| < 4 here, where a bf16 ulp is 2^-6; both sides round the
# expert products and the combine in different orders: two ulps
BF16_TOL = 2 * 2.0 ** -6
BUCKETS = dict(block_size=8, num_blocks=64, batch_buckets=(4,),
               length_buckets=(32,))


@pytest.fixture(autouse=True)
def _cpu(jax_cpu):
    return jax_cpu


def _moe_cfgs(top_k=2, capacity_factor=1.25, dtype="f32", D=32, H=48, E=4):
    import jax.numpy as jnp
    from ray_tpu.ops.moe import MoEConfig as JaxMoEConfig

    from ray_tpu_torch.ops.moe import MoEConfig

    kw = dict(d_model=D, d_hidden=H, num_experts=E, top_k=top_k,
              capacity_factor=capacity_factor)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    return JaxMoEConfig(**kw, dtype=jdt), MoEConfig(**kw, dtype=tdt)


def _moe_params(jcfg, seed=0):
    import jax
    from ray_tpu.ops.moe import moe_init

    tree = jax.tree.map(np.asarray, moe_init(jax.random.PRNGKey(seed), jcfg))
    return tree, {n: torch.from_numpy(v.copy()) for n, v in tree.items()}


def _x(T, D, seed=1):
    return np.random.default_rng(seed).normal(size=(T, D)).astype(np.float32)


def _jax_route(params, x, cfg):
    """The reference's routing, as ``moe_forward`` computes it inline."""
    import jax
    import jax.numpy as jnp

    T = x.shape[0]
    E, k = cfg.num_experts, cfg.top_k
    capacity = max(1, int(cfg.capacity_factor * k * T / E))
    probs = jax.nn.softmax(x.astype(jnp.float32) @ params["router"], axis=-1)
    gate_vals, expert_idx = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.sum(gate_vals, axis=-1, keepdims=True)
    onehot = jax.nn.one_hot(expert_idx, E, dtype=jnp.int32)
    flat = onehot.reshape(T * k, E)
    pos = jnp.sum((jnp.cumsum(flat, axis=0) - flat).reshape(T, k, E)
                  * onehot, axis=-1)
    keep = pos < capacity
    return {"experts": expert_idx, "slots": pos, "keep": keep,
            "gates": gate_vals * keep.astype(gate_vals.dtype),
            "capacity": capacity}


def _err(a, b):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


# (top_k, capacity_factor, T, dtype): T 37 and 40 are not multiples of E
OP_CASES = [(2, 1.25, 37, "f32"), (1, 1.25, 16, "f32"),
            (2, 0.5, 40, "f32"), (2, 1.25, 64, "bf16")]


@pytest.mark.timeout(60)
@pytest.mark.parametrize("top_k,cf,T,dtype", OP_CASES)
def test_moe_forward_matches_jax(top_k, cf, T, dtype):
    import jax.numpy as jnp
    from ray_tpu.ops.moe import moe_forward as jax_forward

    from ray_tpu_torch.ops.moe import moe_forward, moe_route

    jcfg, tcfg = _moe_cfgs(top_k, cf, dtype)
    tree, params = _moe_params(jcfg)
    x = _x(T, jcfg.d_model)
    xin = x if dtype == "f32" else x.astype(jnp.bfloat16)
    want_y, want_aux = jax_forward(tree, jnp.asarray(xin), jcfg)
    tx = torch.from_numpy(x).to(tcfg.dtype)
    y, aux = moe_forward(params, tx, tcfg)
    assert y.dtype == tcfg.dtype and y.shape == (T, jcfg.d_model)
    tol = TOL if dtype == "f32" else BF16_TOL
    assert _err(y, want_y) <= tol
    assert abs(aux.item() - float(want_aux)) <= TOL
    dropped = int((~moe_route(tx, params["router"], tcfg).keep).sum())
    if cf < 1:
        assert dropped > 0
    # aux=False: the same y, no loss
    y2, none = moe_forward(params, tx, tcfg, aux=False)
    assert none is None and torch.equal(y2, y)


@pytest.mark.timeout(60)
@pytest.mark.parametrize("top_k,cf,T,dtype", OP_CASES)
def test_moe_route_matches_jax(top_k, cf, T, dtype):
    import jax.numpy as jnp

    from ray_tpu_torch.ops.moe import moe_route

    jcfg, tcfg = _moe_cfgs(top_k, cf, dtype)
    tree, params = _moe_params(jcfg, seed=2)
    x = _x(T, jcfg.d_model, seed=3)
    xin = x if dtype == "f32" else x.astype(jnp.bfloat16)
    want = _jax_route(tree, jnp.asarray(xin), jcfg)
    got = moe_route(torch.from_numpy(x).to(tcfg.dtype), params["router"],
                    tcfg)
    assert got.capacity == want["capacity"]
    for name in ("experts", "slots", "keep"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(want[name]))
    assert _err(got.gates, want["gates"]) <= TOL
    assert got.probs.dtype == torch.float32


@pytest.mark.timeout(60)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moe_reference_dense_and_undropped_dispatch(dtype):
    """``moe_reference_dense`` against the reference's; with capacity
    for every pair (capacity factor E / k: C = T) the index dispatch
    equals it."""
    import jax.numpy as jnp
    from ray_tpu.ops.moe import moe_reference_dense as jax_dense

    from ray_tpu_torch.ops.moe import (
        moe_forward,
        moe_reference_dense,
        moe_route,
    )

    jcfg, tcfg = _moe_cfgs(2, 2.0, dtype)
    tree, params = _moe_params(jcfg, seed=4)
    x = _x(29, jcfg.d_model, seed=5)
    xin = x if dtype == "f32" else x.astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(tcfg.dtype)
    dense = moe_reference_dense(params, tx, tcfg)
    tol = TOL if dtype == "f32" else BF16_TOL
    assert _err(dense, jax_dense(tree, jnp.asarray(xin), jcfg)) <= tol
    assert bool(moe_route(tx, params["router"], tcfg).keep.all())
    y, _ = moe_forward(params, tx, tcfg)
    assert _err(y, dense.float().numpy()) <= tol


@pytest.mark.timeout(60)
@pytest.mark.parametrize("top_k,cf", [(2, 1.25), (1, 0.5)])
def test_moe_grads_match_jax(top_k, cf):
    """d/d(x, router, w_in, w_out) of sum(y * w) + aux at f32."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.ops.moe import moe_forward as jax_forward

    from ray_tpu_torch.ops.moe import moe_forward

    jcfg, tcfg = _moe_cfgs(top_k, cf)
    tree, params = _moe_params(jcfg, seed=6)
    T = 37
    x = _x(T, jcfg.d_model, seed=7)
    w = np.random.default_rng(8).normal(size=(T, jcfg.d_model)).astype(
        np.float32)

    def jloss(p, xx):
        y, aux = jax_forward(p, xx, jcfg)
        return jnp.sum(y * w) + aux

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    tp = {n: v.clone().requires_grad_(True) for n, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe_forward(tp, tx, tcfg)
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    assert _err(tx.grad, jg_x) <= TOL
    for name in ("router", "w_in", "w_out"):
        assert _err(tp[name].grad, jg_p[name]) <= TOL, name


# ------------------------------------------------------------------ model

def _configs(**kw):
    import jax.numpy as jnp
    from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig

    from ray_tpu_torch.models.llama import LlamaConfig

    jkw = {k: v for k, v in kw.items() if k != "attention_backend"}
    jcfg = dataclasses.replace(JaxLlamaConfig.tiny_moe(), dtype=jnp.float32,
                               **kw)
    tcfg = dataclasses.replace(LlamaConfig.tiny_moe(), dtype=torch.float32,
                               attention_backend="torch", **jkw)
    return jcfg, tcfg


def _jax_tree(jcfg, seed=0):
    import jax
    from ray_tpu.models.llama import llama_init

    return jax.tree.map(np.asarray, llama_init(jax.random.PRNGKey(seed),
                                               jcfg))


def _port_model(tree, tcfg, train=False):
    from ray_tpu_torch.convert import llama_params_from_numpy
    from ray_tpu_torch.models.llama import Llama

    return Llama(tcfg, "cpu", train=train).load_weights(
        llama_params_from_numpy(tree, tcfg))


@pytest.mark.timeout(30)
def test_tiny_moe_config_matches_jax():
    from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig

    from ray_tpu_torch.models.llama import Llama, LlamaConfig, block_shapes

    mine, ref = LlamaConfig.tiny_moe(), JaxLlamaConfig.tiny_moe()
    for f in dataclasses.fields(mine):
        if f.name not in ("dtype", "attention_backend"):
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    assert set(block_shapes(mine)) == {
        "ln1_scale", "wq", "wk", "wv", "wo", "ln2_scale", "moe_router",
        "moe_w_in", "moe_w_out"}
    served = Llama(mine, "cpu")  # bf16 serving: the router stays f32
    assert served.blocks[0].moe_router.dtype == torch.float32
    assert served.blocks[0].moe_w_in.dtype == torch.bfloat16
    assert tuple(served.blocks[0].moe_w_out.shape) == (4, 128, 64)


@pytest.mark.timeout(90)
@pytest.mark.parametrize("attention,fused_loss,masked,remat", [
    ("flash", True, True, False),
    ("xla", False, False, True),
])
def test_tiny_moe_loss_and_grads_match_jax(attention, fused_loss, masked,
                                           remat):
    import jax
    import jax.numpy as jnp
    from ray_tpu.models.llama import llama_forward, llama_loss

    from ray_tpu_torch.convert import llama_params_to_numpy

    jcfg, tcfg = _configs(attention=attention, fused_loss=fused_loss,
                          remat=remat)
    tree = _jax_tree(jcfg, seed=1)
    rng = np.random.default_rng(2)
    B, S = 2, 24
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S + 1))
             .astype(np.int32)}
    if masked:
        batch["mask"] = (rng.random((B, S + 1)) > 0.3).astype(np.float32)
    want, jgrads = jax.value_and_grad(llama_loss)(tree, batch, jcfg)
    model = _port_model(tree, tcfg, train=True)
    loss = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert abs(loss.item() - float(want)) <= TOL
    grads = llama_params_to_numpy(
        {n: p.grad for n, p in model.named_parameters()}, tcfg)
    jgrads = jax.tree.map(np.asarray, jgrads)
    for name in ("wte", "ln_f_scale", "lm_head"):
        assert _err(grads[name], jgrads[name]) <= TOL, name
    assert set(grads["blocks"]) == set(jgrads["blocks"])
    for name, g in jgrads["blocks"].items():
        assert _err(grads["blocks"][name], g) <= TOL, name
    tokens = batch["tokens"][:, :-1]
    with torch.no_grad():
        logits, aux = model(torch.from_numpy(tokens), return_aux=True)
    jlogits, jaux = llama_forward(tree, jnp.asarray(tokens), jcfg,
                                  return_aux=True)
    assert _err(logits, jlogits) <= MODEL_TOL
    assert abs(aux.item() - float(jaux)) <= TOL and aux.item() > 0


@pytest.mark.timeout(90)
def test_tiny_moe_serving_paths_match_jax():
    """Fresh prefill, chunked prefill at ragged starts, a decode step and
    a verify window on a batch of 3 (two sequences and a padding row:
    length 1, all-garbage table, token 0, as the engines stage it) with
    padding columns: logits of the real rows and the written pool."""
    import jax.numpy as jnp
    from ray_tpu.models.llama import (
        llama_decode_step,
        llama_prefill,
        llama_verify_step,
    )

    jcfg, tcfg = _configs(attention="xla", attention_backend="xla")
    tree = _jax_tree(jcfg)
    model = _port_model(tree, tcfg)
    rng = np.random.default_rng(5)
    B, S1, S2, W, bs, NB = 3, 16, 8, 5, 8, 6
    num_blocks = 1 + 2 * NB
    tables = np.zeros((B, NB), np.int32)
    tables[:2] = (1 + rng.permutation(2 * NB)).reshape(2, NB)
    shape = (jcfg.n_layer, num_blocks, bs, jcfg.n_kv_head, jcfg.head_dim)
    jk = jv = jnp.zeros(shape, jnp.float32)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    T = torch.from_numpy

    def both(jax_out, port_out, rows=2):
        (jl, jk2, jv2), (tl, tk2, tv2) = jax_out, port_out
        assert _err(tl[:rows], np.asarray(jl)[:rows]) <= MODEL_TOL
        assert _err(tk2[:, 1:], np.asarray(jk2)[:, 1:]) <= MODEL_TOL
        assert _err(tv2[:, 1:], np.asarray(jv2)[:, 1:]) <= MODEL_TOL
        return jk2, jv2

    toks = rng.integers(0, jcfg.vocab_size, (B, S1)).astype(np.int32)
    lens = np.array([16, 11, 1], np.int32)
    toks[1, 11:] = 0
    toks[2] = 0
    jk, jv = both(
        llama_prefill(tree, jk, jv, jnp.asarray(toks), jnp.asarray(lens),
                      jnp.asarray(tables), jcfg),
        model.prefill(tk, tv, T(toks), T(lens), T(tables)))
    toks2 = rng.integers(0, jcfg.vocab_size, (B, S2)).astype(np.int32)
    lens2 = np.array([8, 5, 1], np.int32)
    toks2[1, 5:] = 0
    toks2[2] = 0
    starts = np.array([16, 11, 0], np.int32)
    jk, jv = both(
        llama_prefill(tree, jk, jv, jnp.asarray(toks2), jnp.asarray(lens2),
                      jnp.asarray(tables), jcfg, start=jnp.asarray(starts)),
        model.prefill(tk, tv, T(toks2), T(lens2), T(tables),
                      start=T(starts)))
    step = rng.integers(0, jcfg.vocab_size, B).astype(np.int32)
    pos = np.array([24, 16, 0], np.int32)
    jk, jv = both(
        llama_decode_step(tree, jk, jv, jnp.asarray(step), jnp.asarray(pos),
                          jnp.asarray(tables), jcfg),
        model.decode_step(tk, tv, T(step), T(pos), T(tables)))
    window = rng.integers(0, jcfg.vocab_size, (B, W)).astype(np.int32)
    dlen = np.array([4, 2, 0], np.int32)
    window[1, 3:] = 0
    window[2] = 0
    vstarts = np.array([25, 17, 0], np.int32)
    jl, _, _ = llama_verify_step(tree, jk, jv, jnp.asarray(window),
                                 jnp.asarray(vstarts), jnp.asarray(dlen),
                                 jnp.asarray(tables), jcfg)
    tl, _, _ = model.verify_step(tk, tv, T(window), T(vstarts), T(dlen),
                                 T(tables))
    for row, d in enumerate(dlen[:2]):
        assert _err(tl[row, :d + 1], np.asarray(jl)[row, :d + 1]) <= MODEL_TOL


@pytest.mark.timeout(60)
@pytest.mark.parametrize("kind", [None, "int8"])
def test_moe_convert_round_trip_and_quant_axes(kind):
    """The MoE tree converts both ways bit for bit; the quant axes equal
    JAX's ``llama_quant_axes`` (the experts and router -1); a quantized
    model holds the experts in cfg.dtype and their values equal the f32
    weights cast, as the reference's ``astype`` at use."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.models.llama import llama_quant_axes as jax_axes
    from ray_tpu.ops.quantization import quantize_params

    from ray_tpu_torch.convert import (
        llama_params_from_numpy,
        llama_params_to_numpy,
    )
    from ray_tpu_torch.models.llama import Llama, llama_quant_axes
    from ray_tpu_torch.ops import quantization as q

    jcfg, tcfg = _configs()
    tree = _jax_tree(jcfg, seed=3)
    back = llama_params_to_numpy(_port_model(tree, tcfg).weights(), tcfg)
    assert set(back["blocks"]) == set(tree["blocks"])
    for name, arr in tree["blocks"].items():
        np.testing.assert_array_equal(back["blocks"][name], arr)
    jaxes = jax_axes(jcfg)
    axes = llama_quant_axes(tcfg)
    for name, ax in jaxes["blocks"].items():
        for i in range(tcfg.n_layer):
            want = ax if ax < 0 else ax - 1  # JAX stacks the layers
            assert axes[f"blocks.{i}.{name}"] == want, name
    if kind is None:
        return
    jq = jax.tree.map(np.asarray, quantize_params(
        jax.tree.map(jnp.asarray, tree), jaxes, kind))
    carried = llama_params_from_numpy(jq, tcfg)
    ours = q.quantize_params(llama_params_from_numpy(tree, tcfg), axes, kind)
    for name, got in ours.items():
        quantized = isinstance(got, q.QuantizedTensor)
        assert quantized == isinstance(carried[name], q.QuantizedTensor)
        assert quantized != ("moe_" in name or "scale" in name), name
        if quantized:
            assert torch.equal(got.data, carried[name].data), name
    bf16 = dataclasses.replace(tcfg, dtype=torch.bfloat16, quantization=kind)
    model = Llama(bf16, "cpu").load_weights(carried)
    w_in = model.blocks[0].moe_w_in
    assert w_in.dtype == torch.bfloat16 and not isinstance(
        w_in, q.QuantizedTensor)
    assert torch.equal(w_in, torch.from_numpy(
        tree["blocks"]["moe_w_in"][0].copy()).to(torch.bfloat16))
    assert model.blocks[0].moe_router.dtype == torch.float32


@pytest.mark.timeout(30)
def test_llama_125m_moe_matches_jax_shapes():
    """``llama_125m_moe``: the parameters the JAX init gives the same
    config, shape for shape; 370,109,184 of them, 143,616,768 active a
    token (attention, router, 2 of 8 experts, embeddings and head)."""
    import jax
    import ray_tpu.models.llama as jllama

    from ray_tpu_torch.models.families import llama_125m_moe
    from ray_tpu_torch.models.llama import Llama, llama_active_params

    cfg = llama_125m_moe()
    fields = {f.name for f in dataclasses.fields(jllama.LlamaConfig)}
    jcfg = jllama.LlamaConfig(**{k: v for k, v in
                                 dataclasses.asdict(cfg).items()
                                 if k in fields and k != "dtype"})
    shapes = jax.eval_shape(lambda k: jllama.llama_init(k, jcfg),
                            jax.random.PRNGKey(0))
    jax_count = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    model = Llama(cfg, torch.device("meta"), train=True)
    assert sum(p.numel() for p in model.parameters()) == jax_count \
        == 370_109_184
    assert llama_active_params(cfg) == 143_616_768
    dense = dataclasses.replace(cfg, num_experts=0)
    assert llama_active_params(dense) == 124_668_672


# ----------------------------------------------------------------- engine

_ENGINE_WEIGHTS: dict = {}


def _engine_weights():
    if not _ENGINE_WEIGHTS:
        import dataclasses as dc

        from ray_tpu_torch.convert import llama_params_from_numpy

        jcfg, tcfg = _configs(attention="xla")
        tcfg = dc.replace(tcfg, attention_backend="auto")
        tree = _jax_tree(jcfg, seed=7)
        _ENGINE_WEIGHTS.update(jcfg=jcfg, tcfg=tcfg, tree=tree,
                               state=llama_params_from_numpy(tree, tcfg))
    return _ENGINE_WEIGHTS


def _jax_engine(**kw):
    import jax
    import jax.numpy as jnp
    from ray_tpu.serve.llm import EngineConfig, LLMEngine

    w = _engine_weights()
    kw = {**BUCKETS, "prefix_caching": False, **kw}
    return LLMEngine(EngineConfig(model="llama", model_config=w["jcfg"],
                                  attention_backend="xla", **kw),
                     params=jax.tree.map(jnp.asarray, w["tree"]),
                     auto_step=False)


def _port_engine(**kw):
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    w = _engine_weights()
    kw = {**BUCKETS, "prefix_caching": False, **kw}
    return LLMEngine(EngineConfig(model="llama", model_config=w["tcfg"],
                                  device="cpu", **kw),
                     params=w["state"], auto_step=False)


def _staggered(engine, requests, gap=2):
    """Submit the requests one at a time, ``gap`` steps apart, then step
    until idle: the same schedule on either engine."""
    streams = []
    for prompt, kw in requests:
        streams.append(engine.submit(prompt, **kw))
        for _ in range(gap):
            engine.step()
    while engine.step():
        pass
    return [list(s) for s in streams]


def _pool_whole(eng):
    snap = eng.cache.debug_snapshot()
    assert snap["used_blocks"] == 0 and snap["reserved_blocks"] == 0, snap
    assert snap["freed_total"] == snap["allocated_total"], snap


@pytest.mark.timeout(120)
@pytest.mark.parametrize("kind", [None, "int8"])
def test_moe_engine_streams_match_jax(kind):
    """Three requests joining two steps apart (the bucket of 4 never
    full: padding rows are routed), greedy and sampled (greedy under
    int8), chunked prefill of 8 tokens: the port's streams equal the JAX
    engine's; the quantized engine holds the experts unquantized."""
    from ray_tpu_torch.ops.quantization import QuantizedTensor

    rng = np.random.default_rng(11)
    shapes = [(13, {}), (21, {"temperature": 0.8, "top_p": 0.9, "seed": 4}),
              (5, {"temperature": 1.1, "top_k": 30, "seed": 9})]
    if kind:
        shapes = [(n, {}) for n, _ in shapes]
    requests = [(rng.integers(0, 512, n).tolist(),
                 {"max_new_tokens": 10, **kw}) for n, kw in shapes]
    jeng = _jax_engine(quantization=kind, prefill_chunk_tokens=8)
    want = _staggered(jeng, requests)
    jeng.shutdown()
    eng = _port_engine(quantization=kind, prefill_chunk_tokens=8)
    got = _staggered(eng, requests)
    assert got == want
    assert all(len(s) == 10 for s in want)
    _pool_whole(eng)
    blk = eng.executor.model.blocks[0]
    assert not isinstance(blk.moe_w_in, QuantizedTensor)
    assert isinstance(blk.wq, QuantizedTensor) == (kind is not None)


class _OracleDrafter:
    """Proposes a request's known continuation (its spec-off stream),
    the fourth draft corrupted: three accepted, one rejected a window."""

    def __init__(self, streams: dict):
        self.streams = streams  # tuple(prompt) -> tokens

    def propose(self, prompt, generated, k):
        ref = self.streams[tuple(prompt)][len(generated):]
        out = list(ref[:k])
        if len(out) == k:
            out[-1] = (out[-1] + 1) % 512
        return out


@pytest.mark.timeout(120)
def test_moe_engine_spec_matches_jax():
    """speculative_k = 4 with a drafter that knows the spec-off streams
    (windows of 3 accepted drafts and a rejected one), greedy and
    sampled: the streams and speculation counters equal the JAX engine's
    on the same schedule, and the spec-off streams (lossless)."""
    rng = np.random.default_rng(12)
    requests = [(rng.integers(0, 512, 11).tolist(), {"max_new_tokens": 12}),
                (rng.integers(0, 512, 9).tolist(),
                 {"max_new_tokens": 8, "temperature": 0.8, "seed": 3})]
    keys = ("spec_steps", "spec_drafted_tokens", "spec_accepted_tokens",
            "spec_committed_tokens")
    off = _staggered(_port_engine(), requests, gap=1)
    drafter = _OracleDrafter({tuple(p): o for (p, _), o in
                              zip(requests, off)})
    jeng = _jax_engine(speculative_k=4, drafter=drafter)
    want = _staggered(jeng, requests, gap=1)
    jstats = jeng.stats()
    jeng.shutdown()
    eng = _port_engine(speculative_k=4, drafter=drafter)
    assert _staggered(eng, requests, gap=1) == want
    stats = eng.stats()
    assert {k: stats[k] for k in keys} == {k: jstats[k] for k in keys}
    assert stats["spec_steps"] > 0 and stats["spec_accepted_tokens"] > 0
    _pool_whole(eng)


@pytest.mark.timeout(120)
def test_moe_engine_prefix_hit_matches_jax():
    """With the prefix cache on: a 24-token prompt, then two prompts
    sharing its first 16 (two blocks hit, the rest prefilled at a true
    start): streams and prefix counters equal the JAX engine's."""
    rng = np.random.default_rng(13)
    base = rng.integers(0, 512, 24).tolist()
    requests = [(base, {"max_new_tokens": 6}),
                (base[:16] + rng.integers(0, 512, 5).tolist(),
                 {"max_new_tokens": 6}),
                (base[:16] + rng.integers(0, 512, 3).tolist(),
                 {"max_new_tokens": 6, "temperature": 0.9, "seed": 2})]
    keys = ("prefix_hit_tokens", "prefix_hit_blocks", "prefill_tokens_total")
    jeng = _jax_engine(prefix_caching=True)
    want = _staggered(jeng, requests, gap=4)
    jstats = jeng.stats()
    jeng.shutdown()
    eng = _port_engine(prefix_caching=True)
    assert _staggered(eng, requests, gap=4) == want
    stats = eng.stats()
    assert {k: stats[k] for k in keys} == {k: jstats[k] for k in keys}
    assert stats["prefix_hit_blocks"] >= 2
