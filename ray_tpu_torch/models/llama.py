"""Llama family (counterpart of ``ray_tpu/models/llama.py``): RMSNorm,
rotary embeddings, grouped-query attention (GQA), a SwiGLU MLP (or, with
``num_experts > 0``, a Mixtral-style top-k expert MLP, ``ops/moe.py``)
and an untied lm head. The training paths ``hidden`` / ``forward`` / ``loss``
(``llama_hidden`` / ``llama_forward`` / ``llama_loss``) and the KV-cached
serving paths ``prefill`` / ``decode_step`` / ``verify_step``
(``llama_prefill`` / ``llama_decode_step`` / ``llama_verify_step``).

Weights follow ``models/gpt.py``'s policies: a serving model holds its
matmul weights and embeddings once in ``cfg.dtype`` (or as
``QuantizedTensor``s under ``cfg.quantization``, axes of
``llama_quant_axes``), a training model f32 masters cast at each use; the
RMSNorm scales stay f32 in both. Llama has no biases: every projection is
a plain ``x @ w`` in the JAX ``[in, out]`` layout.

MoE (``num_experts > 0``): a block holds ``moe_router`` [D, E],
``moe_w_in`` [E, D, M] and ``moe_w_out`` [E, M, D] in place of
``mlp_in`` / ``mlp_out``. The router stays f32 (the reference routes on
``x.astype(f32) @ router``); the experts are never quantized (their
``llama_quant_axes`` entry is -1, as the reference's), so a quantized
serving model holds them in ``cfg.dtype``, the value the reference's
``astype`` gives at use. The training paths carry the load-balance aux
loss summed over the layers (``hidden`` returns it, ``forward`` with
``return_aux``, ``loss`` adds it); the serving paths route every row and
column of the bucket, padding included, as the reference does, and drop
the aux loss.

GQA: the pool holds the ``n_kv_head`` heads; the paged attentions group
the ``kv_groups`` query heads of each kv head, and the training path
repeats the kv heads before the flash kernels, as JAX does (``jnp.repeat``
along the head axis is ``repeat_interleave``).

The rotary tables are built once per model on its device at
``max_seq_len`` and indexed per row by position (a graph-captured decode
step may not build them). A fresh prompt's positions are 0..S-1, the
first S rows of the same table, so every path reads the values JAX's
``rope_cache(S)`` gives.

Not ported yet: ``attention="ring"`` and expert parallelism (the
reference's ``moe_logical_axes``; every expert of a port's model sits on
its one device) wait for the multi-GPU work. The JAX config's
``scan_layers`` has no eager counterpart.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.gpt import _embed, _param, load_weights
from ray_tpu_torch.ops.attention import flash_attention, mha_reference
from ray_tpu_torch.ops.kv_cache import scatter_kv, write_slots
from ray_tpu_torch.ops.layers import rms_norm, rope, rope_cache
from ray_tpu_torch.ops.loss import fused_lm_head_loss, mm_f32
from ray_tpu_torch.ops.moe import MoEConfig, moe_forward, moe_route
from ray_tpu_torch.ops.paged_attention import (
    decode_attention,
    prefill_attention,
    resolve_backend,
)
from ray_tpu_torch.ops.sampling import sample_tokens, verify_tokens


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    max_seq_len: int = 2048
    n_layer: int = 8
    n_head: int = 8
    n_kv_head: int = 4
    d_model: int = 512
    d_mlp: int = 1408  # ~8/3 * d_model rounded to 128 (SwiGLU sizing)
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16
    # training / full-sequence attention: flash (kernels B1-B3) | xla (the
    # plain mha_reference; the JAX name is kept) | ring (not ported yet)
    attention: str = "flash"
    # kernel backend of every attention: auto | torch | cuda
    attention_backend: str = "auto"
    # serving quantization (int8 | fp8 | None), set by
    # EngineConfig.quantization; training paths ignore it
    quantization: str | None = None
    remat: bool = False       # recompute each block in the backward
    fused_loss: bool = True   # chunked lm-head + CE, no [B, S, V] logits
    # MoE (0 = dense SwiGLU)
    num_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_coeff: float = 0.01

    @staticmethod
    def tiny(vocab_size: int = 512) -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=vocab_size, max_seq_len=128, n_layer=2, n_head=4,
            n_kv_head=2, d_model=64, d_mlp=128,
        )

    @staticmethod
    def tiny_moe(vocab_size: int = 512) -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=vocab_size, max_seq_len=128, n_layer=2, n_head=4,
            n_kv_head=2, d_model=64, d_mlp=128, num_experts=4, top_k=2,
        )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @property
    def kv_groups(self) -> int:
        return self.n_head // self.n_kv_head

    def __post_init__(self):
        if self.n_head % self.n_kv_head:
            raise ValueError("n_head must be a multiple of n_kv_head")


# amax reduction axis of each quantized weight (its matmul's contraction
# axis, per-output-channel scales): wte reduces over embed (one scale per
# vocab row for the gather), the untied lm head [D, V] over D
_QUANT_AXES = {"wte": 1, "lm_head": 0, "wq": 0, "wk": 0, "wv": 0, "wo": 0,
               "mlp_in": 0, "mlp_out": 0}
_F32_PARAMS = ("ln1_scale", "ln2_scale", "ln_f_scale", "moe_router")
_TOP = ("wte", "ln_f_scale", "lm_head")
_ATTN_SHAPES = {
    "ln1_scale": ("D",), "wq": ("D", "Q"), "wk": ("D", "KV"),
    "wv": ("D", "KV"), "wo": ("Q", "D"), "ln2_scale": ("D",),
}
_MLP_SHAPES = {"mlp_in": ("D", "2M"), "mlp_out": ("M", "D")}
_MOE_SHAPES = {"moe_router": ("D", "E"), "moe_w_in": ("E", "D", "M"),
               "moe_w_out": ("E", "M", "D")}


def block_shapes(cfg: LlamaConfig) -> dict:
    """Each block weight's shape by name, in symbolic dims: the dense
    SwiGLU pair, or the MoE router and experts when ``num_experts > 0``."""
    return {**_ATTN_SHAPES,
            **(_MOE_SHAPES if cfg.num_experts else _MLP_SHAPES)}


class LlamaBlock(nn.Module):
    """One transformer block's weights (``block_shapes``; dense SwiGLU:
    ``mlp_in`` packs the gate and up projections, gate first)."""

    def __init__(self, cfg: LlamaConfig, device, train: bool = False):
        super().__init__()
        hd = cfg.head_dim
        dims = {"D": cfg.d_model, "Q": cfg.n_head * hd,
                "KV": cfg.n_kv_head * hd, "M": cfg.d_mlp, "2M": 2 * cfg.d_mlp,
                "E": cfg.num_experts}
        for name, shape in block_shapes(cfg).items():
            setattr(self, name, _param(tuple(dims[d] for d in shape), name,
                                       cfg, device, train, _QUANT_AXES,
                                       _F32_PARAMS))


def llama_quant_axes(cfg: LlamaConfig) -> dict:
    """Per-weight amax reduction axis for serving quantization, keyed by
    state-dict name (``ops/quantization.quantize_params``); -1 keeps a
    weight in full precision (the RMSNorm scales, and an MoE block's
    router and experts, as the reference's). The JAX tree stacks
    the blocks, so its block axes are these plus one."""
    axes = {name: _QUANT_AXES.get(name, -1) for name in _TOP}
    for i in range(cfg.n_layer):
        for name in block_shapes(cfg):
            axes[f"blocks.{i}.{name}"] = _QUANT_AXES.get(name, -1)
    return axes


def _mm(x, w):
    """``x @ w`` in x's dtype (an f32 master cast, a quantized weight
    dequantized; a serving weight is used as it is)."""
    return torch.matmul(x, w.to(x.dtype))


class Llama(nn.Module):
    """Llama with the training paths and the engine's prefill and
    decode-step paths. ``train=True`` holds f32 masters that require grad
    (see the module docstring)."""

    def __init__(self, cfg: LlamaConfig, device=None, *, train: bool = False):
        super().__init__()
        if cfg.attention not in ("flash", "xla"):
            raise ValueError(f"attention={cfg.attention!r} is not ported "
                             f"yet; flash or xla")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.moe = MoEConfig(
            d_model=cfg.d_model, d_hidden=cfg.d_mlp,
            num_experts=cfg.num_experts, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor,
            aux_loss_coeff=cfg.aux_loss_coeff, dtype=cfg.dtype,
        ) if cfg.num_experts else None
        # a list to which every MoE layer call appends its ``moe_route``
        # (the route the call dispatched), or None: how a check reads the
        # routes of any path (recorded again in a checkpointed backward)
        self.route_log: list | None = None
        D, V = cfg.d_model, cfg.vocab_size

        def param(shape, name):
            return _param(shape, name, cfg, self.device, train, _QUANT_AXES,
                          _F32_PARAMS)

        self.wte = param((V, D), "wte")
        self.blocks = nn.ModuleList(
            LlamaBlock(cfg, self.device, train) for _ in range(cfg.n_layer)
        )
        self.ln_f_scale = param((D,), "ln_f_scale")
        self.lm_head = param((D, V), "lm_head")
        cos, sin = rope_cache(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta,
                              device=self.device)
        self.register_buffer("cos", cos, persistent=False)
        self.register_buffer("sin", sin, persistent=False)

    def weights(self) -> dict:
        """Every weight by its state-dict name: a Parameter, or in a
        quantized serving model a ``QuantizedTensor``."""
        out = {name: getattr(self, name) for name in _TOP}
        for i, bp in enumerate(self.blocks):
            for name in block_shapes(self.cfg):
                out[f"blocks.{i}.{name}"] = getattr(bp, name)
        return out

    def load_weights(self, state: dict) -> "Llama":
        """Copy ``state`` into this model's weights (``gpt.load_weights``)."""
        load_weights(self.weights(), state)
        return self

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Llama":
        """``llama_init``'s distribution from ``generator`` (on this
        model's device): normal(0.02), the residual projections ``wo`` and
        ``mlp_out`` scaled by 1/sqrt(2 * n_layer), RMSNorm scales 1; an
        MoE block's router normal(0.02), ``moe_w_in`` normal(D^-0.5) and
        ``moe_w_out`` normal(M^-0.5)."""
        std = 0.02
        resid = std / math.sqrt(2 * self.cfg.n_layer)

        def normal_(p, scale):
            x = torch.randn(p.shape, generator=generator, device=self.device,
                            dtype=torch.float32)
            p.copy_(x * scale)

        normal_(self.wte, std)
        D, M = self.cfg.d_model, self.cfg.d_mlp
        dense = self.moe is None
        for blk in self.blocks:
            # a dense block draws in the order its seeds always gave
            for name in ("wq", "wk", "wv", "mlp_in")[:4 if dense else 3]:
                normal_(getattr(blk, name), std)
            normal_(blk.wo, resid)
            if dense:
                normal_(blk.mlp_out, resid)
            else:
                normal_(blk.moe_router, std)
                normal_(blk.moe_w_in, D ** -0.5)
                normal_(blk.moe_w_out, M ** -0.5)
            blk.ln1_scale.fill_(1.0)
            blk.ln2_scale.fill_(1.0)
        self.ln_f_scale.fill_(1.0)
        normal_(self.lm_head, std)
        return self

    # ---- block pieces (models/llama.py _attn_qkv / _swiglu /
    # _ffn_residual) ----

    def _attn_qkv(self, x, bp: LlamaBlock, positions=None):
        """rms_norm, the q/k/v projections and RoPE at ``positions`` [B, S]
        (None: 0..S-1). Returns q [B, S, Hq, hd] and k, v [B, S, Hkv, hd]:
        kv heads not repeated, as the pool holds them."""
        B, S, _ = x.shape
        cfg = self.cfg
        Hq, Hkv, hd = cfg.n_head, cfg.n_kv_head, cfg.head_dim
        h = rms_norm(x, bp.ln1_scale)
        q = _mm(h, bp.wq).reshape(B, S, Hq, hd)
        k = _mm(h, bp.wk).reshape(B, S, Hkv, hd)
        v = _mm(h, bp.wv).reshape(B, S, Hkv, hd)
        if positions is None:
            cos, sin = self.cos[:S], self.sin[:S]
        else:
            cos, sin = self.cos, self.sin
        return rope(q, cos, sin, positions), rope(k, cos, sin, positions), v

    def _ffn_residual(self, x, bp: LlamaBlock, aux: bool = True):
        """ln2, the SwiGLU MLP (``_swiglu``: gate first in ``mlp_in``) or
        the MoE layer over every row and column of x [B, S, D] flattened,
        and the residual. Returns (x, aux loss): an f32 scalar for an MoE
        block, None for a dense one or with ``aux=False``."""
        h = rms_norm(x, bp.ln2_scale)
        if self.moe is None:
            gate, up = _mm(h, bp.mlp_in).chunk(2, dim=-1)
            return x + _mm(F.silu(gate) * up, bp.mlp_out), None
        B, S, D = x.shape
        flat = h.reshape(B * S, D)
        if self.route_log is not None:
            with torch.no_grad():
                self.route_log.append(moe_route(flat, bp.moe_router,
                                                self.moe))
        out, loss = moe_forward(
            {"router": bp.moe_router, "w_in": bp.moe_w_in,
             "w_out": bp.moe_w_out}, flat, self.moe, aux=aux)
        return x + out.reshape(B, S, D), loss

    def _logits(self, h):
        """The untied lm head: ``cfg.dtype`` operands, f32 accumulation and
        result (JAX's ``preferred_element_type=float32``). On the card a
        bf16 head is read as it is held, with no per-call f32 copy."""
        dt = self.cfg.dtype
        lead = h.shape[:-1]
        x, w = h.reshape(-1, h.shape[-1]).to(dt), self.lm_head.to(dt)
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            out = torch.matmul(x.float(), w.float())  # differentiable
        else:
            out = mm_f32(x, w)
        return out.reshape(*lead, out.shape[-1])

    # ---- training paths ----

    def _block(self, x, bp: LlamaBlock):
        """One transformer block over the full sequence, x [B, S, D].
        Returns (x, aux loss or None)."""
        B, S, D = x.shape
        q, k, v = (t.transpose(1, 2) for t in self._attn_qkv(x, bp))
        if self.cfg.attention == "flash":
            # repeats the kv heads up front (GQA), as the JAX block does
            attn = flash_attention(q, k, v, causal=True,
                                   backend=self.cfg.attention_backend)
        else:
            attn = mha_reference(q, k, v, causal=True)
        x = x + _mm(attn.transpose(1, 2).reshape(B, S, D), bp.wo)
        return self._ffn_residual(x, bp)

    def hidden(self, tokens):
        """tokens [B, S] -> (final hidden states [B, S, D] in cfg.dtype
        after the final RMSNorm, the MoE aux loss summed over the layers:
        an f32 scalar, None for a dense model), as ``llama_hidden``."""
        x = _embed(self.wte, tokens.long(), self.cfg.dtype)
        aux_sum = None
        for bp in self.blocks:
            if self.cfg.remat:
                x, aux = checkpoint(self._block, x, bp, use_reentrant=False)
            else:
                x, aux = self._block(x, bp)
            if aux is not None:
                aux_sum = aux if aux_sum is None else aux_sum + aux
        return rms_norm(x, self.ln_f_scale), aux_sum

    def forward(self, tokens, return_aux: bool = False):
        """tokens [B, S] -> logits [B, S, vocab] f32 (and, with
        ``return_aux``, the summed aux loss: 0 for a dense model)."""
        x, aux = self.hidden(tokens)
        logits = self._logits(x)
        if not return_aux:
            return logits
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return logits, aux

    def loss(self, batch: dict):
        """Next-token cross-entropy (f32 scalar) plus the summed MoE aux
        loss (a dense model adds nothing); batch as ``GPT.loss`` takes it
        (``tokens`` [B, S+1], or ``inputs`` / ``targets``, with an optional
        target- or token-aligned ``mask``)."""
        mask = batch.get("mask")
        if "tokens" in batch:
            tokens = batch["tokens"]
            inputs, targets = tokens[:, :-1], tokens[:, 1:]
            if mask is not None and mask.shape[-1] == tokens.shape[-1]:
                mask = mask[:, 1:]
        else:
            inputs, targets = batch["inputs"], batch["targets"]
        x, aux = self.hidden(inputs)
        if self.cfg.fused_loss:
            B, S, D = x.shape
            ce = fused_lm_head_loss(
                x.reshape(B * S, D), self.lm_head.t(), targets.reshape(B * S),
                None if mask is None else mask.reshape(B * S).float(),
            )
        else:
            logits = self._logits(x)
            lse = torch.logsumexp(logits, dim=-1)
            picked = logits.gather(-1, targets.long()[..., None])[..., 0]
            ll = picked - lse
            if mask is not None:
                mask = mask.float()
                ce = -(ll * mask).sum() / mask.sum().clamp(min=1.0)
            else:
                ce = -ll.mean()
        return ce if aux is None else ce + aux

    # ---- KV-cached serving paths ----

    def _chunk_hidden(self, cache_k, cache_v, tokens, lengths, block_tables,
                      start):
        """The prompt-chunk body shared by ``prefill`` and ``verify_step``:
        RoPE at the true positions (``start`` [B] + 0..S-1, or 0..S-1),
        clamped to the table on padding columns, every valid position's
        K/V written; returns the final hidden states [B, S, D] (after the
        final RMSNorm). An MoE block routes all B x S rows, padding rows
        and columns included, as the reference does: they take expert
        capacity ahead of later rows."""
        cfg = self.cfg
        B, S = tokens.shape
        D = cfg.d_model
        dev = self.device
        ar = torch.arange(S, dtype=torch.int32, device=dev)
        if start is None:
            pos = ar[None, :].expand(B, S)
            rope_pos = pos
        else:
            pos = start.to(torch.int32)[:, None] + ar[None, :]
            # padding columns can run past the table; they are masked
            rope_pos = pos.clamp(max=cfg.max_seq_len - 1)
        x = _embed(self.wte, tokens.long(), cfg.dtype)
        valid = ar[None, :] < lengths[:, None]
        backend = resolve_backend(cfg.attention_backend, dev)
        attn_pos = torch.where(valid, pos, 0).to(torch.int32).contiguous()
        slots = write_slots(pos, block_tables, cache_k.shape[2], valid)
        for layer, bp in enumerate(self.blocks):
            k_layer, v_layer = cache_k[layer], cache_v[layer]
            q, kk, vv = self._attn_qkv(x, bp, rope_pos)
            scatter_kv(k_layer, v_layer, kk, vv, slots)
            if (start is None and backend == "torch"
                    and cfg.quantization is None):
                # fresh prompt, plain path: attention over the chunk alone
                # (mha_reference repeats the kv heads); see GPT.prefill
                attn = mha_reference(
                    q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
                    causal=True,
                ).transpose(1, 2).reshape(B, S, D)
            else:
                attn = prefill_attention(
                    q.contiguous(), k_layer, v_layer, block_tables, attn_pos,
                    backend=backend,
                ).reshape(B, S, D)
            x = x + _mm(attn, bp.wo)
            x, _ = self._ffn_residual(x, bp, aux=False)
        return rms_norm(x, self.ln_f_scale)

    @torch.no_grad()
    def prefill(self, cache_k, cache_v, tokens, lengths, block_tables,
                start=None, sample=None):
        """Prompt pass over right-padded chunks (``GPT.prefill``'s
        contract), RoPE at the true positions. Returns (last-valid-token
        logits [B, V] f32, or sampled ids [B] int32 with ``sample``;
        cache_k; cache_v)."""
        B = tokens.shape[0]
        h = self._chunk_hidden(cache_k, cache_v, tokens, lengths,
                               block_tables, start)
        h_last = h[torch.arange(B, device=self.device), (lengths - 1).long()]
        logits = self._logits(h_last)
        if sample is None:
            return logits, cache_k, cache_v
        return sample_tokens(logits, sample), cache_k, cache_v

    @torch.no_grad()
    def verify_step(self, cache_k, cache_v, tokens, starts, draft_len,
                    block_tables, sample=None):
        """Speculative-decoding verify pass over a [B, W] window
        (``llama_verify_step``; ``GPT.verify_step``'s contract): RoPE at
        the clamped true positions, GQA over the pool's kv heads, the
        untied head at every column. Returns (packed verdicts [B, W + 1]
        int32; cache_k; cache_v), or with ``sample=None`` the window's
        logits [B, W, V] f32."""
        h = self._chunk_hidden(cache_k, cache_v, tokens, draft_len + 1,
                               block_tables, starts)
        logits = self._logits(h)
        if sample is None:
            return logits, cache_k, cache_v
        return (verify_tokens(logits, starts, tokens, draft_len, sample),
                cache_k, cache_v)

    @torch.no_grad()
    def decode_step(self, cache_k, cache_v, tokens, positions, block_tables,
                    sample=None):
        """One decode step (``GPT.decode_step``'s contract): RoPE at each
        row's true position, K/V written, attention over the paged context
        of the kv heads; an MoE block routes all B rows, padding included.
        No host read and no allocation that depends on the data: a CUDA
        graph can capture it."""
        B = tokens.shape[0]
        D = self.cfg.d_model
        backend = resolve_backend(self.cfg.attention_backend, self.device)
        x = _embed(self.wte, tokens.long(), self.cfg.dtype)[:, None, :]
        pos2d = positions[:, None]
        slots = write_slots(positions, block_tables, cache_k.shape[2])
        for layer, bp in enumerate(self.blocks):
            k_layer, v_layer = cache_k[layer], cache_v[layer]
            q, kk, vv = self._attn_qkv(x, bp, pos2d)  # [B, 1, H*, hd]
            scatter_kv(k_layer, v_layer, kk[:, 0], vv[:, 0], slots)
            attn = decode_attention(
                q[:, 0].contiguous(), k_layer, v_layer, block_tables,
                positions, backend=backend,
            )
            x = x + _mm(attn.reshape(B, 1, D), bp.wo)
            x, _ = self._ffn_residual(x, bp, aux=False)
        logits = self._logits(rms_norm(x[:, 0], self.ln_f_scale))
        if sample is None:
            return logits, cache_k, cache_v
        return sample_tokens(logits, sample), cache_k, cache_v


def llama_init(cfg: LlamaConfig, seed: int = 0, device=None, *,
               train: bool = False) -> Llama:
    """A Llama with seeded random weights, built on ``device`` (f32 masters
    with gradients when ``train``)."""
    model = Llama(cfg, device, train=train)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    return model.init_weights(gen)


def llama_num_params(cfg: LlamaConfig) -> int:
    """Parameter count (counted on the meta device: nothing allocated)."""
    return sum(p.numel() for p in Llama(cfg, "meta").parameters())


def llama_active_params(cfg: LlamaConfig) -> int:
    """Parameters one token's forward uses: all of them for a dense model;
    for an MoE model, all but the experts a token is not routed to
    (``num_experts - top_k`` of ``moe_w_in`` and ``moe_w_out`` a layer)."""
    skipped = (cfg.n_layer * max(cfg.num_experts - cfg.top_k, 0)
               * 2 * cfg.d_model * cfg.d_mlp)
    return llama_num_params(cfg) - skipped
