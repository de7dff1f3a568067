"""Token sampling (counterpart of ``ray_tpu/ops/sampling.py``).

The per-token randomness is keyed, not stateful: the token at absolute
position p of a request with seed s draws its uniform from
``fold_in(PRNGKey(s), p)`` exactly as ``jax.random`` does (threefry2x32,
partitionable mode), reproduced bit for bit in integer ops:

1. ``k = threefry2x32(key=(0, s), ctr=(0, p))``
2. ``b = threefry2x32(key=k, ctr=(0, 0))``
3. ``bits = b0 ^ b1``
4. ``u = bitcast_f32((bits >> 9) | 0x3F800000) - 1``

so a stream sampled by the port equals the JAX engine's token for token,
and the token at p is a pure function of (logits, seed, p). The draw is a
few hundred integer operations on B words, so it runs on the host in
numpy (uint32 words held in uint64, masked to 32 bits after every add
and shift) instead of as hundreds of tiny kernel launches on the card.
"""
from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32 with 20 rounds on uint64 arrays holding uint32 words;
    returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (c0 + k0) & _M32
    x1 = (c1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def keyed_uniform(seeds, positions) -> torch.Tensor:
    """``jax.random.uniform(fold_in(PRNGKey(seed), position))`` per row, as
    a [B] f32 CPU tensor in [0, 1). seeds: [B] uint32 values (any integer
    dtype); positions: [B] non-negative ints. Tensors on a card are read
    back first, which waits for the work that produced them."""
    def host(x):
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        return x.astype(np.int64).astype(np.uint64) & _M32

    s, p = host(seeds), host(positions)
    zero = np.zeros_like(s)
    k0, k1 = threefry2x32(zero, s, zero, p)
    b0, b1 = threefry2x32(k0, k1, zero, zero)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    u = bits.astype(np.uint32).view(np.float32) - np.float32(1.0)
    return torch.from_numpy(u)


def apply_allow_mask(logits: torch.Tensor, mask) -> torch.Tensor:
    """Apply a packed allow-bitmask to ``logits`` [..., V]: ``mask`` is
    [..., ceil(V/32)] uint32 words in an integer tensor (bit j of word w
    allows token w*32 + j). Disallowed tokens go to -inf; a row that allows
    nothing is left unmasked."""
    if mask is None:
        return logits
    m = torch.as_tensor(mask, device=logits.device).long() & _M32
    shifts = torch.arange(32, device=logits.device)
    bits = (m[..., None] >> shifts) & 1
    allow = bits.reshape(*m.shape[:-1], m.shape[-1] * 32)
    allow = allow[..., : logits.shape[-1]] != 0
    allow = allow | ~allow.any(dim=-1, keepdim=True)
    return logits.masked_fill(~allow, float("-inf"))


def _sampled_rows(logits, seeds, positions, temperature, top_k, top_p):
    """Temperature / top-k / top-p rows through one full descending sort;
    returns [B] int32 token ids."""
    V = logits.shape[-1]
    dev = logits.device
    u = keyed_uniform(seeds, positions).to(dev)
    temp = torch.clamp(temperature.to(dev).float(), min=1e-6)
    scaled = logits.float() / temp[:, None]
    # stable descending sort: equal logits keep index order, as lax.top_k
    srt, idx = torch.sort(scaled, dim=-1, descending=True, stable=True)
    ranks = torch.arange(V, device=dev)
    top_k = top_k.to(dev)
    k_eff = torch.where(top_k > 0, top_k, torch.full_like(top_k, V))
    srt = srt.masked_fill(ranks[None, :] >= k_eff[:, None], float("-inf"))
    probs = torch.softmax(srt, dim=-1)
    top_p = top_p.to(dev).float()
    p_eff = torch.where((top_p > 0.0) & (top_p < 1.0), top_p,
                        torch.ones_like(top_p))
    # exclusive cumulative mass below p: rank 0 always survives
    keep = (torch.cumsum(probs, dim=-1) - probs) < p_eff[:, None]
    srt = srt.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(srt, dim=-1)
    cdf = torch.cumsum(probs, dim=-1)
    pick = torch.searchsorted(cdf, u[:, None].contiguous(), right=True)
    pick = pick.clamp(max=V - 1)
    return torch.gather(idx, 1, pick)[:, 0].to(torch.int32)


def sample_tokens(
    logits: torch.Tensor, positions: torch.Tensor, sample: dict
) -> torch.Tensor:
    """One token per row of ``logits`` [B, V] f32 -> [B] int32.

    ``positions`` [B] is the absolute position of the token being sampled.
    ``sample`` holds [B] tensors ``seeds`` (uint32 values), ``temperature``
    (<= 0 -> greedy), ``top_k`` (0 or -1 -> off), ``top_p`` (>= 1 -> off)
    and optionally ``mask`` (see ``apply_allow_mask``). The controls may
    live on the CPU: when every row is greedy the decision is taken there
    and the sort is skipped."""
    logits = apply_allow_mask(logits, sample.get("mask"))
    temperature = sample["temperature"]
    greedy_rows = (temperature <= 0.0) | (sample["top_k"] == 1)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if bool(greedy_rows.all()):
        return greedy
    sampled = _sampled_rows(
        logits, sample["seeds"], positions, temperature,
        sample["top_k"], sample["top_p"],
    )
    return torch.where(greedy_rows.to(logits.device), greedy, sampled)
