"""The port's Llama family (``ray_tpu_torch.models.llama``, the rotary and
RMSNorm ops of ``ops/layers.py``) against ``ray_tpu.models.llama`` on the
same converted weights and numpy-seeded inputs: the layers (1e-6), the
loss and every gradient (1e-5 / 1e-4, as ``test_torch_train.py`` holds
GPT), the forward logits, fresh and chunked prefill at true offsets and a
decode step, logits and the written pool (1e-4, the GPT tests' bar), the
quantized weights bit for bit, the conversion both ways, and each
family's full width against the JAX init's parameter shapes. Tiny f32
configs: ``LlamaConfig.tiny()`` (4 query heads on 2 kv heads, G = 2) and
a variant with 6 on 2 (G = 3); head dim 16 either way."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

TOL = 1e-4
B, S = 2, 24


@pytest.fixture(autouse=True)
def _cpu(jax_cpu):
    return jax_cpu


def _configs(groups=2, **kw):
    import jax.numpy as jnp
    from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig

    from ray_tpu_torch.models.llama import LlamaConfig

    shape = {} if groups == 2 else dict(n_head=6, n_kv_head=2, d_model=96)
    jkw = {k: v for k, v in kw.items() if k != "attention_backend"}
    jcfg = dataclasses.replace(JaxLlamaConfig.tiny(), dtype=jnp.float32,
                               **shape, **kw)
    tcfg = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32,
                               attention_backend="torch", **shape, **jkw)
    assert tcfg.kv_groups == groups and tcfg.head_dim == 16
    return jcfg, tcfg


def _jax_params(jcfg, seed=0):
    import jax
    from ray_tpu.models.llama import llama_init

    return jax.tree.map(np.asarray, llama_init(jax.random.PRNGKey(seed), jcfg))


def _port_model(tree, tcfg, train=False):
    from ray_tpu_torch.convert import llama_params_from_numpy
    from ray_tpu_torch.models.llama import Llama

    return Llama(tcfg, "cpu", train=train).load_weights(
        llama_params_from_numpy(tree, tcfg))


def _err(port, ref):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    return float(np.max(np.abs(np.asarray(port) - np.asarray(ref))))


def test_layers_match_jax():
    import jax.numpy as jnp
    from ray_tpu.ops import layers as jl

    from ray_tpu_torch.ops import layers as tl

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32) * 3
    scale = rng.normal(size=(16,)).astype(np.float32)
    assert _err(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
                jl.rms_norm(jnp.asarray(x), jnp.asarray(scale))) <= 1e-6
    cos, sin = tl.rope_cache(40, 16, 500.0)
    jcos, jsin = jl.rope_cache(40, 16, 500.0)
    assert _err(cos, jcos) <= 1e-6 and _err(sin, jsin) <= 1e-6
    tx = torch.from_numpy(x)
    assert _err(tl.rope(tx, cos[:7], sin[:7]),
                jl.rope(jnp.asarray(x), jcos[:7], jsin[:7])) <= 1e-6
    pos = rng.integers(0, 40, (2, 7)).astype(np.int32)
    assert _err(tl.rope(tx, cos, sin, torch.from_numpy(pos)),
                jl.rope(jnp.asarray(x), jcos, jsin, jnp.asarray(pos))) <= 1e-6
    # bf16 in, bf16 out (computed in f32)
    assert tl.rope(tx.bfloat16(), cos, sin, torch.from_numpy(pos)).dtype \
        == torch.bfloat16


def test_config_matches_jax_and_refuses_what_is_not_ported():
    from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig

    from ray_tpu_torch.models.llama import Llama, LlamaConfig

    mine, ref = LlamaConfig.tiny(), JaxLlamaConfig.tiny()
    for f in dataclasses.fields(mine):
        if f.name not in ("dtype", "attention_backend"):
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    assert (mine.head_dim, mine.kv_groups) == (ref.head_dim, ref.kv_groups)
    with pytest.raises(ValueError, match="multiple of n_kv_head"):
        LlamaConfig(n_head=6, n_kv_head=4)
    # MoE is ported: tiny_moe is the JAX config field by field
    moe, ref_moe = LlamaConfig.tiny_moe(), JaxLlamaConfig.tiny_moe()
    for f in dataclasses.fields(moe):
        if f.name not in ("dtype", "attention_backend"):
            assert getattr(moe, f.name) == getattr(ref_moe, f.name), f.name
    assert Llama(moe, "cpu").moe.num_experts == ref_moe.num_experts
    with pytest.raises(ValueError, match="not ported yet"):
        Llama(dataclasses.replace(mine, attention="ring"), "cpu")


@pytest.mark.parametrize("groups,attention,fused_loss,masked,remat", [
    (2, "flash", True, True, False),
    (3, "xla", False, False, True),
])
def test_loss_forward_and_grads_match_jax(groups, attention, fused_loss,
                                          masked, remat):
    import jax
    import jax.numpy as jnp
    from ray_tpu.models.llama import llama_forward, llama_loss

    from ray_tpu_torch.convert import llama_params_to_numpy

    jcfg, tcfg = _configs(groups, attention=attention, fused_loss=fused_loss,
                          remat=remat)
    tree = _jax_params(jcfg, seed=1)
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S + 1))
             .astype(np.int32)}
    if masked:  # token-aligned [B, S + 1]: shifts with the targets
        batch["mask"] = (rng.random((B, S + 1)) > 0.3).astype(np.float32)
    want, jgrads = jax.value_and_grad(llama_loss)(tree, batch, jcfg)
    model = _port_model(tree, tcfg, train=True)
    loss = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert loss.dtype == torch.float32
    assert abs(loss.item() - float(want)) <= 1e-5
    grads = llama_params_to_numpy(
        {n: p.grad for n, p in model.named_parameters()}, tcfg)
    jgrads = jax.tree.map(np.asarray, jgrads)
    for name in ("wte", "ln_f_scale", "lm_head"):
        assert _err(grads[name], jgrads[name]) <= 1e-4, name
    assert set(grads["blocks"]) == set(jgrads["blocks"])
    for name, g in jgrads["blocks"].items():
        assert _err(grads["blocks"][name], g) <= 1e-4, name
    tokens = batch["tokens"][:, :-1]
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens))
    assert logits.dtype == torch.float32
    assert _err(logits, llama_forward(tree, jnp.asarray(tokens), jcfg)) <= TOL


@pytest.mark.parametrize("groups,jax_backend", [(2, "xla"), (3, "xla"),
                                                (3, "pallas")])
def test_prefill_chunk_decode_match_jax(groups, jax_backend):
    import jax.numpy as jnp
    from ray_tpu.models.llama import llama_decode_step, llama_prefill

    jcfg, tcfg = _configs(groups, attention="xla",
                          attention_backend=jax_backend)
    tree = _jax_params(jcfg)
    model = _port_model(tree, tcfg)
    rng = np.random.default_rng(5)
    S1, S2, bs, NB = 16, 8, 8, 5
    num_blocks = 1 + B * NB
    tables = (1 + rng.permutation(B * NB)).reshape(B, NB).astype(np.int32)
    shape = (jcfg.n_layer, num_blocks, bs, jcfg.n_kv_head, jcfg.head_dim)
    jk = jv = jnp.zeros(shape, jnp.float32)
    tk, tv = torch.zeros(shape), torch.zeros(shape)

    def both(jax_out, port_out):
        (jl, jk2, jv2), (tl, tk2, tv2) = jax_out, port_out
        assert _err(tl, jl) <= TOL
        assert _err(tk2[:, 1:], np.asarray(jk2)[:, 1:]) <= TOL  # 0: sink
        assert _err(tv2[:, 1:], np.asarray(jv2)[:, 1:]) <= TOL
        return jk2, jv2

    toks = rng.integers(0, jcfg.vocab_size, (B, S1)).astype(np.int32)
    lens = np.array([16, 11], np.int32)
    jk, jv = both(
        llama_prefill(tree, jk, jv, jnp.asarray(toks), jnp.asarray(lens),
                      jnp.asarray(tables), jcfg),
        model.prefill(tk, tv, torch.from_numpy(toks), torch.from_numpy(lens),
                      torch.from_numpy(tables)))
    # chunked prefill at ragged true-position starts
    toks2 = rng.integers(0, jcfg.vocab_size, (B, S2)).astype(np.int32)
    lens2 = np.array([8, 5], np.int32)
    jk, jv = both(
        llama_prefill(tree, jk, jv, jnp.asarray(toks2), jnp.asarray(lens2),
                      jnp.asarray(tables), jcfg, start=jnp.asarray(lens)),
        model.prefill(tk, tv, torch.from_numpy(toks2),
                      torch.from_numpy(lens2), torch.from_numpy(tables),
                      start=torch.from_numpy(lens)))
    step = rng.integers(0, jcfg.vocab_size, B).astype(np.int32)
    pos = (lens + lens2).astype(np.int32)
    both(llama_decode_step(tree, jk, jv, jnp.asarray(step), jnp.asarray(pos),
                           jnp.asarray(tables), jcfg),
         model.decode_step(tk, tv, torch.from_numpy(step),
                           torch.from_numpy(pos), torch.from_numpy(tables)))


def test_convert_round_trip_and_seeded_init():
    from ray_tpu_torch.convert import llama_params_to_numpy
    from ray_tpu_torch.models.llama import (
        LlamaConfig,
        llama_init,
        llama_num_params,
    )

    jcfg, tcfg = _configs()
    tree = _jax_params(jcfg, seed=3)
    back = llama_params_to_numpy(_port_model(tree, tcfg).weights(), tcfg)
    for name in ("wte", "ln_f_scale", "lm_head"):
        np.testing.assert_array_equal(back[name], tree[name])
    assert set(back["blocks"]) == set(tree["blocks"])
    for name, arr in tree["blocks"].items():
        np.testing.assert_array_equal(back["blocks"][name], arr)
    a = llama_init(tcfg, seed=4, device="cpu").weights()
    b = llama_init(tcfg, seed=4, device="cpu").weights()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["lm_head"], llama_init(tcfg, 5, "cpu").lm_head)
    served = llama_init(LlamaConfig.tiny(), device="cpu")  # bf16 serving
    assert served.blocks[0].wq.dtype == torch.bfloat16
    assert served.blocks[0].ln1_scale.dtype == torch.float32
    n = sum(np.asarray(x).size for x in [tree["wte"], tree["ln_f_scale"],
                                         tree["lm_head"]]) + sum(
        arr.size for arr in tree["blocks"].values())
    assert llama_num_params(tcfg) == n


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantize_params_and_convert_bit_identical(kind):
    """The port quantizing converted f32 weights over ``llama_quant_axes``
    gives the bytes of JAX's ``quantize_params`` over its
    ``llama_quant_axes``, which ``convert`` carries across unchanged; the
    RMSNorm scales stay f32."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.models.llama import llama_quant_axes
    from ray_tpu.ops.quantization import quantize_params

    from ray_tpu_torch.convert import llama_params_from_numpy
    from ray_tpu_torch.models.llama import Llama
    from ray_tpu_torch.models.llama import llama_quant_axes as port_axes
    from ray_tpu_torch.ops import quantization as q

    jcfg, tcfg = _configs(3)
    tree = _jax_params(jcfg, seed=2)
    jq = jax.tree.map(np.asarray, quantize_params(
        jax.tree.map(jnp.asarray, tree), llama_quant_axes(jcfg), kind))
    ours = q.quantize_params(llama_params_from_numpy(tree, tcfg),
                             port_axes(tcfg), kind)
    carried = llama_params_from_numpy(jq, tcfg)
    assert set(ours) == set(carried)
    n_quant = 0
    for name, got in ours.items():
        other = carried[name]
        if isinstance(got, q.QuantizedTensor):
            n_quant += 1
            for a, b in ((got.data, other.data), (got.scale, other.scale)):
                assert a.dtype == b.dtype and a.shape == b.shape, name
                view = torch.uint8 if a.element_size() == 1 else torch.int32
                assert torch.equal(a.contiguous().view(view), b.view(view))
        else:
            assert "scale" in name and torch.equal(got, other), name
    assert n_quant == 2 + 6 * tcfg.n_layer  # wte, lm_head, 6 matmuls a layer
    assert tuple(ours["lm_head"].scale.shape) == (1, tcfg.vocab_size)
    assert tuple(ours["wte"].scale.shape) == (tcfg.vocab_size, 1)
    model = Llama(dataclasses.replace(tcfg, quantization=kind),
                  "cpu").load_weights(carried)
    assert model.blocks[1].ln2_scale.dtype == torch.float32
    assert isinstance(model.lm_head, q.QuantizedTensor)


@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_family_full_width_matches_jax_shapes(name):
    """Each registered family's full width (``Family.full``: GPT-2 125M,
    Llama-125M) holds the parameters the JAX init gives the same config,
    shape for shape (the port's model on the meta device, JAX's through
    ``eval_shape``); the pool holds its kv heads; ``serve/llm/decode.py``
    re-exports the registry."""
    import jax
    import ray_tpu.models.gpt as jgpt
    import ray_tpu.models.llama as jllama

    from ray_tpu_torch.models import families
    from ray_tpu_torch.serve.llm import decode

    assert decode.FAMILIES is families.FAMILIES
    fam = families.family(name)
    cfg = fam.full()
    jax_cfg_cls = jgpt.GPTConfig if name == "gpt" else jllama.LlamaConfig
    init = jgpt.gpt_init if name == "gpt" else jllama.llama_init
    fields = {f.name for f in dataclasses.fields(jax_cfg_cls)}
    jcfg = jax_cfg_cls(**{k: v for k, v in dataclasses.asdict(cfg).items()
                          if k in fields and k != "dtype"})
    shapes = jax.eval_shape(lambda k: init(k, jcfg), jax.random.PRNGKey(0))
    jax_count = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    model = fam.model(cfg, torch.device("meta"), train=True)
    port_count = sum(p.numel() for p in model.parameters())
    assert port_count == jax_count == {"gpt": 124_475_904,
                                       "llama": 124_668_672}[name]
    assert families.kv_heads(cfg) == (12 if name == "gpt" else 4)
