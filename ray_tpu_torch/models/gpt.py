"""GPT-2 family (counterpart of ``ray_tpu/models/gpt.py``): the training
paths ``hidden`` / ``forward`` / ``loss`` (``gpt_hidden`` / ``gpt_forward``
/ ``gpt_loss``) and the KV-cached serving paths ``prefill`` /
``decode_step`` (``gpt_prefill`` / ``gpt_decode_step``).

Weights, two policies:
- serving (``GPT(cfg)``): the matmul weights, biases and embeddings are
  held once in ``cfg.dtype``, without gradients (the JAX package casts its
  f32 masters to ``cfg.dtype`` at every use, which gives the same values);
  the layer-norm parameters stay f32, as the JAX layer norm reads its
  masters in f32.
- training (``GPT(cfg, train=True)``): every parameter is an f32 master
  that requires grad, cast to ``cfg.dtype`` at each use, as in JAX.
- quantized serving (``cfg.quantization`` "int8" | "fp8"): the matmul
  weights and embeddings are ``QuantizedTensor``s (per-channel, axes of
  ``gpt_quant_axes``), dequantized in ``cfg.dtype`` at each use as JAX's
  ``astype`` does; biases and layer norms stay as above. No dequantized
  copy is kept. Training ignores the knob.
Activations run in ``cfg.dtype``; layer norm and softmax compute in f32;
logits and the loss are f32. Linear weights keep the JAX layout
``[in, out]`` (``x @ w``).

The paged pool ``[n_layer, num_blocks, block_size, n_head, head_dim]`` is
written IN PLACE; ``prefill`` and ``decode_step`` still return it, so the
call contract is the JAX one: ``(logits or sampled ids, cache_k, cache_v)``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.ops.attention import flash_attention, mha_reference
from ray_tpu_torch.ops.kv_cache import scatter_kv, write_slots
from ray_tpu_torch.ops.layers import gelu, layer_norm
from ray_tpu_torch.ops.loss import fused_lm_head_loss
from ray_tpu_torch.ops.paged_attention import (
    decode_attention,
    prefill_attention,
    resolve_backend,
)
from ray_tpu_torch.ops.quantization import (
    QuantizedTensor,
    quant_dtype,
    resolve_quantization,
)
from ray_tpu_torch.ops.sampling import sample_tokens


@dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304  # 50257 padded to a multiple of 128
    max_seq_len: int = 1024
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    d_mlp: int = 3072
    dtype: Any = torch.bfloat16
    # training / full-sequence attention: flash (FlashAttention, kernels
    # B1-B3) | xla (the plain mha_reference; the JAX name is kept). The
    # JAX config's ``scan_layers`` has no eager counterpart: the port
    # always runs the layers as a Python loop.
    attention: str = "flash"
    # kernel backend of every attention: auto | torch | cuda ("auto" = the
    # CUDA kernels for tensors on a card, the plain versions on the CPU)
    attention_backend: str = "auto"
    remat: bool = False       # recompute each block in the backward
    fused_loss: bool = True   # chunked lm-head + CE, no [B, S, V] logits
    # serving quantization (int8 | fp8 | None): quantized weights (see the
    # module docstring) and a quantized paged pool; set by
    # EngineConfig.quantization. Training paths ignore it.
    quantization: str | None = None

    @staticmethod
    def gpt2_small() -> "GPTConfig":
        return GPTConfig()

    @staticmethod
    def tiny(vocab_size: int = 512) -> "GPTConfig":
        """Test-size config."""
        return GPTConfig(
            vocab_size=vocab_size, max_seq_len=128, n_layer=2, n_head=4,
            d_model=64, d_mlp=256,
        )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head


def _linear(x, w, b):
    """``x @ w + b`` for w in the JAX ``[in, out]`` layout, the bias added
    in the product's epilogue (one launch instead of two). f32 masters are
    cast to x's dtype here; serving weights already have it (no copy)."""
    out = torch.addmm(b.to(x.dtype), x.reshape(-1, w.shape[0]), w.to(x.dtype))
    return out.reshape(*x.shape[:-1], w.shape[1])


def _embed(table, idx, dtype):
    """Rows ``idx`` of an embedding table in ``dtype``. A quantized table
    gathers rows of data and scale, then dequantizes: the same values as
    JAX's dequantize-then-gather."""
    if isinstance(table, QuantizedTensor):
        return table.rows(idx).to(dtype)
    return table[idx].to(dtype)


# parameters held in f32 whatever cfg.dtype is (see module docstring)
_F32_PARAMS = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias",
               "ln_f_scale", "ln_f_bias")
_TOP = ("wte", "wpe", "ln_f_scale", "ln_f_bias")
# amax reduction axis of each quantized weight: the matmul's contraction
# axis (per-output-channel scales); wte and wpe reduce over embed, so one
# scale per vocab row serves the gather and the tied lm head
_QUANT_AXES = {"wte": 1, "wpe": 1, "qkv_w": 0, "proj_w": 0, "mlp_in_w": 0,
               "mlp_out_w": 0}


def gpt_quant_axes(cfg: GPTConfig) -> dict:
    """Per-weight amax reduction axis for serving quantization, keyed by
    state-dict name (``ops/quantization.quantize_params``); -1 keeps a
    weight in full precision (biases, layer norms). The JAX tree stacks
    the blocks, so its block axes are these plus one."""
    axes = {name: _QUANT_AXES.get(name, -1) for name in _TOP}
    for i in range(cfg.n_layer):
        for name in Block.SHAPES:
            axes[f"blocks.{i}.{name}"] = _QUANT_AXES.get(name, -1)
    return axes


def _param(shape, name: str, cfg, device, train: bool,
           quant_axes: dict = _QUANT_AXES, f32_params=_F32_PARAMS):
    """An uninitialized weight under the module docstring's policies:
    ``quant_axes`` names the weights a quantized serving model holds as
    ``QuantizedTensor``s (with their amax axis), ``f32_params`` those held
    in f32 whatever ``cfg.dtype`` is."""
    kind = None if train else resolve_quantization(cfg.quantization)
    if kind is not None and name in quant_axes:
        axis = quant_axes[name]
        return QuantizedTensor(
            torch.empty(shape, dtype=quant_dtype(kind), device=device),
            torch.empty([1 if i == axis else n for i, n in enumerate(shape)],
                        dtype=torch.float32, device=device),
        )
    dtype = torch.float32 if train or name in f32_params else cfg.dtype
    return nn.Parameter(
        torch.empty(shape, dtype=dtype, device=device), requires_grad=train
    )


@torch.no_grad()
def load_weights(current: dict, state: dict) -> None:
    """Copy ``state`` (tensors or QuantizedTensors by state-dict name, on
    any device) into a model's ``current`` weights (its ``weights()``),
    casting full-precision ones to their dtype; a quantized weight takes
    only a quantized value of its own dtype and shapes."""
    if set(state) != set(current):
        raise KeyError(f"weights differ: missing "
                       f"{sorted(set(current) - set(state))}, unexpected "
                       f"{sorted(set(state) - set(current))}")
    for name, value in state.items():
        cur = current[name]
        if isinstance(cur, QuantizedTensor):
            if not (isinstance(value, QuantizedTensor)
                    and value.dtype == cur.dtype
                    and value.shape == cur.shape
                    and value.scale.shape == cur.scale.shape):
                raise TypeError(
                    f"{name}: expected a {cur.dtype} QuantizedTensor of "
                    f"shape {tuple(cur.shape)}, got {type(value).__name__}"
                    f" {getattr(value, 'dtype', None)}")
            cur.data.copy_(value.data)
            cur.scale.copy_(value.scale)
        elif isinstance(value, QuantizedTensor):
            raise TypeError(f"{name} is quantized but the model holds it "
                            f"in {cur.dtype} (quantization=None)")
        else:
            cur.copy_(value)


class Block(nn.Module):
    """One transformer block's weights."""

    SHAPES = {
        "ln1_scale": ("D",), "ln1_bias": ("D",),
        "qkv_w": ("D", "3D"), "qkv_b": ("3D",),
        "proj_w": ("D", "D"), "proj_b": ("D",),
        "ln2_scale": ("D",), "ln2_bias": ("D",),
        "mlp_in_w": ("D", "M"), "mlp_in_b": ("M",),
        "mlp_out_w": ("M", "D"), "mlp_out_b": ("D",),
    }

    def __init__(self, cfg: GPTConfig, device, train: bool = False):
        super().__init__()
        dims = {"D": cfg.d_model, "3D": 3 * cfg.d_model, "M": cfg.d_mlp}
        for name, shape in self.SHAPES.items():
            setattr(self, name, _param(tuple(dims[d] for d in shape), name,
                                       cfg, device, train))


class GPT(nn.Module):
    """GPT-2 with the training paths and the engine's prefill and
    decode-step paths. ``train=True`` holds f32 masters that require grad
    (see the module docstring)."""

    def __init__(self, cfg: GPTConfig, device=None, *, train: bool = False):
        super().__init__()
        if cfg.attention not in ("flash", "xla"):
            raise ValueError(f"attention must be flash or xla, got "
                             f"{cfg.attention!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        D = cfg.d_model

        def param(shape, name):
            return _param(shape, name, cfg, self.device, train)

        self.wte = param((cfg.vocab_size, D), "wte")
        self.wpe = param((cfg.max_seq_len, D), "wpe")
        self.blocks = nn.ModuleList(
            Block(cfg, self.device, train) for _ in range(cfg.n_layer)
        )
        self.ln_f_scale = param((D,), "ln_f_scale")
        self.ln_f_bias = param((D,), "ln_f_bias")

    def weights(self) -> dict:
        """Every weight by its state-dict name: a Parameter, or in a
        quantized serving model a ``QuantizedTensor``."""
        out = {name: getattr(self, name) for name in _TOP}
        for i, bp in enumerate(self.blocks):
            for name in Block.SHAPES:
                out[f"blocks.{i}.{name}"] = getattr(bp, name)
        return out

    def load_weights(self, state: dict) -> "GPT":
        """Copy ``state`` into this model's weights (``load_weights``)."""
        load_weights(self.weights(), state)
        return self

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "GPT":
        """GPT-2 init from ``generator`` (on this model's device):
        normal(0.02), wpe normal(0.01), residual projections scaled by
        1/sqrt(2 * n_layer), biases 0, layer-norm scales 1."""
        std = 0.02
        resid = std / math.sqrt(2 * self.cfg.n_layer)

        def normal_(p, scale):
            x = torch.randn(p.shape, generator=generator, device=self.device,
                            dtype=torch.float32)
            p.copy_(x * scale)

        normal_(self.wte, std)
        normal_(self.wpe, std / 2)
        for blk in self.blocks:
            normal_(blk.qkv_w, std)
            normal_(blk.proj_w, resid)
            normal_(blk.mlp_in_w, std)
            normal_(blk.mlp_out_w, resid)
            for name in ("qkv_b", "proj_b", "mlp_in_b", "mlp_out_b",
                         "ln1_bias", "ln2_bias"):
                getattr(blk, name).zero_()
            blk.ln1_scale.fill_(1.0)
            blk.ln2_scale.fill_(1.0)
        self.ln_f_scale.fill_(1.0)
        self.ln_f_bias.zero_()
        return self

    # ---- block pieces (models/gpt.py _attn_qkv / _attn_residual /
    # _mlp_residual) ----

    def _attn_qkv(self, x, bp: Block):
        B, S, _ = x.shape
        H, hd = self.cfg.n_head, self.cfg.head_dim
        h = layer_norm(x, bp.ln1_scale, bp.ln1_bias)
        qkv = _linear(h, bp.qkv_w, bp.qkv_b)
        q, k, v = qkv.split(self.cfg.d_model, dim=-1)
        return (q.reshape(B, S, H, hd), k.reshape(B, S, H, hd),
                v.reshape(B, S, H, hd))

    @staticmethod
    def _attn_residual(x, attn, bp: Block):
        return x + _linear(attn, bp.proj_w, bp.proj_b)

    @staticmethod
    def _mlp_residual(x, bp: Block):
        h = layer_norm(x, bp.ln2_scale, bp.ln2_bias)
        h = gelu(_linear(h, bp.mlp_in_w, bp.mlp_in_b))
        return x + _linear(h, bp.mlp_out_w, bp.mlp_out_b)

    def _logits(self, h):
        # tied lm head in f32: bf16 values are exact in f32, so this is the
        # JAX head's bf16 inputs with an f32 accumulator and f32 output
        # (a training model's f32 master wte is cast to cfg.dtype first, a
        # quantized wte dequantized in cfg.dtype)
        wte = self.wte.to(self.cfg.dtype)
        return torch.matmul(h.float(), wte.float().t())

    # ---- training paths (models/gpt.py gpt_hidden / gpt_forward /
    # gpt_loss) ----

    def _block(self, x, bp: Block):
        """One transformer block over the full sequence, x [B, S, D]."""
        B, S, D = x.shape
        q, k, v = (t.transpose(1, 2) for t in self._attn_qkv(x, bp))
        if self.cfg.attention == "flash":
            attn = flash_attention(q, k, v, causal=True,
                                   backend=self.cfg.attention_backend)
        else:
            attn = mha_reference(q, k, v, causal=True)
        x = self._attn_residual(x, attn.transpose(1, 2).reshape(B, S, D), bp)
        return self._mlp_residual(x, bp)

    def hidden(self, tokens):
        """tokens [B, S] -> final hidden states [B, S, D] in cfg.dtype, after
        the final layer norm (everything but the lm head)."""
        S = tokens.shape[1]
        dt = self.cfg.dtype
        x = _embed(self.wte, tokens.long(), dt) + _embed(self.wpe, slice(S), dt)
        for bp in self.blocks:
            if self.cfg.remat:
                x = checkpoint(self._block, x, bp, use_reentrant=False)
            else:
                x = self._block(x, bp)
        return layer_norm(x, self.ln_f_scale, self.ln_f_bias)

    def forward(self, tokens):
        """tokens [B, S] -> logits [B, S, vocab] f32."""
        return self._logits(self.hidden(tokens))

    def loss(self, batch: dict):
        """Next-token cross-entropy (f32 scalar). batch: {"tokens": [B, S+1]}
        or {"inputs": [B, S], "targets": [B, S]}, with an optional "mask":
        [B, S] target-aligned, or [B, S+1] token-aligned (shifted with the
        targets)."""
        mask = batch.get("mask")
        if "tokens" in batch:
            tokens = batch["tokens"]
            inputs, targets = tokens[:, :-1], tokens[:, 1:]
            if mask is not None and mask.shape[-1] == tokens.shape[-1]:
                mask = mask[:, 1:]
        else:
            inputs, targets = batch["inputs"], batch["targets"]
        if self.cfg.fused_loss:
            x = self.hidden(inputs)
            B, S, D = x.shape
            return fused_lm_head_loss(
                x.reshape(B * S, D), self.wte, targets.reshape(B * S),
                None if mask is None else mask.reshape(B * S).float(),
            )
        logits = self.forward(inputs)
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, targets.long()[..., None])[..., 0]
        ll = picked - lse
        if mask is not None:
            mask = mask.float()
            return -(ll * mask).sum() / mask.sum().clamp(min=1.0)
        return -ll.mean()

    # ---- KV-cached serving paths ----

    @torch.no_grad()
    def prefill(self, cache_k, cache_v, tokens, lengths, block_tables,
                start=None, sample=None):
        """Prompt pass over right-padded chunks, writing every valid
        position's K/V into the pool. tokens [B, S], lengths [B] (valid
        prefix per row), block_tables [B, NB] int32; ``start`` [B] gives
        each row's first true position (chunked prefill), None = 0.
        Returns (last-valid-token logits [B, V] f32, or sampled ids [B]
        int32 with ``sample``; cache_k; cache_v)."""
        cfg = self.cfg
        B, S = tokens.shape
        D = cfg.d_model
        dt = cfg.dtype
        dev = self.device
        tokens = tokens.long()
        ar = torch.arange(S, dtype=torch.int32, device=dev)
        if start is None:
            pos = ar[None, :].expand(B, S)
            x = _embed(self.wte, tokens, dt) + _embed(self.wpe, slice(S), dt)
        else:
            pos = start.to(torch.int32)[:, None] + ar[None, :]
            # padding columns can run past the table; they are masked
            emb_pos = pos.clamp(max=cfg.max_seq_len - 1).long()
            x = _embed(self.wte, tokens, dt) + _embed(self.wpe, emb_pos, dt)
        valid = ar[None, :] < lengths[:, None]
        backend = resolve_backend(cfg.attention_backend, dev)
        attn_pos = torch.where(valid, pos, 0).to(torch.int32).contiguous()
        slots = write_slots(pos, block_tables, cache_k.shape[2], valid)
        for layer, bp in enumerate(self.blocks):
            k_layer, v_layer = cache_k[layer], cache_v[layer]
            q, kk, vv = self._attn_qkv(x, bp)
            scatter_kv(k_layer, v_layer, kk, vv, slots)
            if (start is None and backend == "torch"
                    and cfg.quantization is None):
                # fresh prompt, plain path: attention over the chunk alone.
                # Not under quantization: that would attend the fresh,
                # unquantized k/v, where every other path (and JAX) reads
                # the quantized values back from the pool
                attn = mha_reference(
                    q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
                    causal=True,
                ).transpose(1, 2).reshape(B, S, D)
            else:
                attn = prefill_attention(
                    q.contiguous(), k_layer, v_layer, block_tables, attn_pos,
                    backend=backend,
                ).reshape(B, S, D)
            x = self._attn_residual(x, attn, bp)
            x = self._mlp_residual(x, bp)
        h = layer_norm(x, self.ln_f_scale, self.ln_f_bias)
        h_last = h[torch.arange(B, device=dev), (lengths - 1).long()]
        logits = self._logits(h_last)
        if sample is None:
            return logits, cache_k, cache_v
        return sample_tokens(logits, sample), cache_k, cache_v

    @torch.no_grad()
    def decode_step(self, cache_k, cache_v, tokens, positions, block_tables,
                    sample=None):
        """One decode step: tokens [B] (each sequence's newest token) at
        positions [B] int32; writes its K/V, attends the paged context
        (mask includes self). Padding rows use block 0 and position 0.
        Returns (next-token logits [B, V] f32 or sampled ids; cache_k;
        cache_v)."""
        B = tokens.shape[0]
        D = self.cfg.d_model
        dt = self.cfg.dtype
        backend = resolve_backend(self.cfg.attention_backend, self.device)
        x = (_embed(self.wte, tokens.long(), dt)
             + _embed(self.wpe, positions.long(), dt))[:, None, :]
        slots = write_slots(positions, block_tables, cache_k.shape[2])
        for layer, bp in enumerate(self.blocks):
            k_layer, v_layer = cache_k[layer], cache_v[layer]
            q, kk, vv = self._attn_qkv(x, bp)  # [B, 1, H, hd]
            scatter_kv(k_layer, v_layer, kk[:, 0], vv[:, 0], slots)
            attn = decode_attention(
                q[:, 0].contiguous(), k_layer, v_layer, block_tables,
                positions, backend=backend,
            )
            x = self._attn_residual(x, attn.reshape(B, 1, D), bp)
            x = self._mlp_residual(x, bp)
        h = layer_norm(x[:, 0], self.ln_f_scale, self.ln_f_bias)
        logits = self._logits(h)
        if sample is None:
            return logits, cache_k, cache_v
        return sample_tokens(logits, sample), cache_k, cache_v


def gpt_init(cfg: GPTConfig, seed: int = 0, device=None, *,
             train: bool = False) -> GPT:
    """A GPT with seeded random weights, built on ``device`` (f32 masters
    with gradients when ``train``)."""
    model = GPT(cfg, device, train=train)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    return model.init_weights(gen)


def gpt_num_params(cfg: GPTConfig) -> int:
    """Parameter count (counted on the meta device: nothing allocated)."""
    return sum(p.numel() for p in GPT(cfg, "meta").parameters())
