"""Mixture-of-Experts layer (counterpart of ``ray_tpu/ops/moe.py``):
top-k gating, capacity-bounded dispatch, expert GELU MLPs, the
gate-weighted combine and the Switch load-balance loss, on one device
(every expert local; expert parallelism is not ported).

The semantics are the reference's (``moe_route`` is its routing, factored
out): an f32 router softmax, ``top_k`` with the gates renormalised over
the k choices, ``capacity = max(1, int(capacity_factor * k * T / E))``,
each (token, choice) placed in its expert's buffer by an exclusive cumsum
in token-major, then choice, order, overflow dropped with its gate
zeroed, the experts ``gelu(x @ w_in) @ w_out`` in ``cfg.dtype``, the
combine in ``cfg.dtype`` and the aux loss of Switch eq. 4.

Dispatch and combine go by index, not by the reference's one-hot
einsums (its ``[T, k, E, C]`` dispatch tensor is 2.7 GB a layer at a
16 x 1024 training batch, and the einsums multiply mostly zeros): every
kept (token, choice) is copied to its row ``e * C + slot`` of a static
``[E * C + 1, D]`` buffer whose last row takes the dropped pairs, the two
expert products run as batched matmuls over ``[E, C, .]``, and each
token gathers its k rows back and sums them weighted by its gates cast
to ``cfg.dtype`` (products and sum in f32, rounded once: the value of an
einsum in ``cfg.dtype`` that accumulates in f32). Dispatch is exact; the
combine differs from the einsum only in the order of accumulation.

Nothing here reads a device value on the host or makes a shape that
depends on the data (no ``nonzero``, no boolean indexing, ``one_hot``
with its class count), so a CUDA graph can capture the layer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from ray_tpu_torch.ops.layers import gelu


@dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_hidden: int
    num_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_coeff: float = 0.01
    dtype: Any = torch.bfloat16


def moe_capacity(cfg: MoEConfig, tokens: int) -> int:
    """Slots per expert for a batch of ``tokens`` (the reference's
    Python expression: static given the shape)."""
    return max(1, int(cfg.capacity_factor * cfg.top_k * tokens
                      / cfg.num_experts))


def moe_init(generator: torch.Generator, cfg: MoEConfig,
             device=None) -> dict:
    """The reference's distributions, f32: router normal(0.02), ``w_in``
    normal(D^-0.5), ``w_out`` normal(H^-0.5), drawn from ``generator``."""
    E, D, H = cfg.num_experts, cfg.d_model, cfg.d_hidden

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32) * scale

    return {"router": normal((D, E), 0.02),
            "w_in": normal((E, D, H), D ** -0.5),
            "w_out": normal((E, H, D), H ** -0.5)}


@dataclass
class Route:
    """One batch's routing (``moe_route``), every field on x's device:
    ``probs`` [T, E] f32 router probabilities, ``experts`` [T, k] int64
    (choice 0 the most probable), ``gates`` [T, k] f32 renormalised over
    the k choices and zeroed where dropped, ``slots`` [T, k] int32 position
    in the expert's buffer, ``keep`` [T, k] bool (slot < ``capacity``)."""

    probs: torch.Tensor
    experts: torch.Tensor
    gates: torch.Tensor
    slots: torch.Tensor
    keep: torch.Tensor
    capacity: int


def moe_route(x: torch.Tensor, router: torch.Tensor,
              cfg: MoEConfig) -> Route:
    """The reference's routing of x [T, D] by ``router`` [D, E]."""
    T = x.shape[0]
    E, k = cfg.num_experts, cfg.top_k
    capacity = moe_capacity(cfg, T)
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    gate_vals, experts = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    # the reference's exclusive cumsum of the [T * k, E] one-hot, held as
    # [E, T * k] so that the scan runs along the inner axis (along the
    # outer one, 8 columns long, it is a serial scan: 6 ms a call at
    # T 16384 on an H100)
    flat = experts.reshape(1, T * k)  # token-major, then choice
    onehot = (flat == torch.arange(E, device=x.device)[:, None]).to(
        torch.int32)
    before = onehot.cumsum(dim=1, dtype=torch.int32) - onehot
    slots = before.gather(0, flat).reshape(T, k)
    keep = slots < capacity
    return Route(probs, experts, gate_vals * keep.to(gate_vals.dtype),
                 slots, keep, capacity)


def moe_forward(params: dict, x: torch.Tensor, cfg: MoEConfig,
                aux: bool = True):
    """x [T, D] -> (y [T, D] in x's dtype, aux loss f32 scalar); with
    ``aux=False`` the loss is not computed and comes back as None (the
    serving paths, where the reference's compiler drops it)."""
    T, D = x.shape
    E = cfg.num_experts
    r = moe_route(x, params["router"], cfg)
    C = r.capacity
    dt = cfg.dtype
    # row of each (token, choice) in the [E * C + 1, D] buffer; the last
    # row takes every dropped pair
    rows = torch.where(r.keep, r.experts * C + r.slots, E * C).reshape(-1)
    xb = x.to(dt)
    src = xb[:, None, :].expand(T, cfg.top_k, D).reshape(-1, D)
    buf = torch.zeros(E * C + 1, D, dtype=dt, device=x.device)
    buf = buf.index_copy(0, rows, src)
    expert_in = buf[:E * C].view(E, C, D)
    h = gelu(torch.bmm(expert_in, params["w_in"].to(dt)))
    expert_out = torch.bmm(h, params["w_out"].to(dt)).view(E * C, D)
    out = torch.cat([expert_out, expert_out.new_zeros(1, D)])
    picked = out.index_select(0, rows).view(T, cfg.top_k, D)
    gates = r.gates.to(dt).float()[..., None]
    y = (picked.float() * gates).sum(dim=1).to(dt).to(x.dtype)
    if not aux:
        return y, None
    me = r.probs.mean(dim=0)
    ce = F.one_hot(r.experts[:, 0], E).float().sum(dim=0) / T
    return y, cfg.aux_loss_coeff * E * (me * ce).sum()


def moe_reference_dense(params: dict, x: torch.Tensor,
                        cfg: MoEConfig) -> torch.Tensor:
    """Every token through every chosen expert with no capacity limit:
    the correctness oracle (top-k gating, no drops)."""
    dt = cfg.dtype
    probs = torch.softmax(x.float() @ params["router"].float(), dim=-1)
    gate_vals, experts = torch.topk(probs, cfg.top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    xb = x.to(dt)
    h = gelu(torch.einsum("td,edh->eth", xb, params["w_in"].to(dt)))
    all_out = torch.einsum("eth,ehd->etd", h, params["w_out"].to(dt))
    out = torch.zeros_like(xb)
    tok = torch.arange(x.shape[0], device=x.device)
    for j in range(cfg.top_k):
        sel = all_out[experts[:, j], tok]  # [T, D]
        out = out + sel * gate_vals[:, j, None].to(dt)
    return out.to(x.dtype)
