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
and the token at p is a pure function of (logits, seed, p). A draw is a
few hundred integer operations on two 32-bit words, so it runs on the
host in Python integers, one row at a time (masked to 32 bits after
every add and shift), instead of as hundreds of tiny kernel launches on
the card. The engine knows every seed and position on the host before a
step, so it computes the draws there, for the rows that sample, and
stages them with the step's other inputs: a sampling step reads nothing
back from the device.
"""
from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0: int, k1: int, c0: int, c1: int) -> tuple[int, int]:
    """Threefry-2x32 with 20 rounds on uint32 words held in Python ints;
    returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (c0 + k0) & _M32
    x1 = (c1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def keyed_uniform(seeds, positions) -> torch.Tensor:
    """``jax.random.uniform(fold_in(PRNGKey(seed), position))`` per row, as
    a [B] f32 CPU tensor in [0, 1). seeds: [B] uint32 values (any integer
    dtype); positions: [B] non-negative ints; numpy arrays or CPU tensors.
    A tensor on a card raises: reading it back would wait for the device,
    so the caller computes the draws from its host values."""
    def host(x):
        if isinstance(x, torch.Tensor):
            if x.device.type != "cpu":
                raise ValueError(
                    f"keyed_uniform takes host values, got a tensor on "
                    f"{x.device}: stage the draws from the host's seeds and "
                    f"positions")
            x = x.numpy()
        return np.asarray(x).astype(np.int64).tolist()

    bits = []
    for s, p in zip(host(seeds), host(positions)):
        k0, k1 = threefry2x32(0, s & _M32, 0, p & _M32)
        b0, b1 = threefry2x32(k0, k1, 0, 0)
        bits.append(((b0 ^ b1) >> 9) | 0x3F800000)
    u = np.asarray(bits, np.uint32).view(np.float32) - np.float32(1.0)
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


def _sampled_rows(logits, u, temperature, top_k, top_p):
    """Temperature / top-k / top-p rows through one full descending sort,
    drawing row b at ``u[b]``; returns [B] int32 token ids. Every control
    lies on logits' device."""
    V = logits.shape[-1]
    dev = logits.device
    temp = torch.clamp(temperature.float(), min=1e-6)
    scaled = logits.float() / temp[:, None]
    # stable descending sort: equal logits keep index order, as lax.top_k
    srt, idx = torch.sort(scaled, dim=-1, descending=True, stable=True)
    ranks = torch.arange(V, device=dev)
    k_eff = torch.where(top_k > 0, top_k, torch.full_like(top_k, V))
    srt = srt.masked_fill(ranks[None, :] >= k_eff[:, None], float("-inf"))
    probs = torch.softmax(srt, dim=-1)
    top_p = top_p.float()
    p_eff = torch.where((top_p > 0.0) & (top_p < 1.0), top_p,
                        torch.ones_like(top_p))
    # exclusive cumulative mass below p: rank 0 always survives
    keep = (torch.cumsum(probs, dim=-1) - probs) < p_eff[:, None]
    srt = srt.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(srt, dim=-1)
    cdf = torch.cumsum(probs, dim=-1)
    pick = torch.searchsorted(cdf, u[:, None].float().contiguous(),
                              right=True)
    pick = pick.clamp(max=V - 1)
    return torch.gather(idx, 1, pick)[:, 0].to(torch.int32)


def greedy_rows(sample: dict) -> torch.Tensor:
    """[B] bool: the rows ``sample`` decodes greedily (temperature <= 0 or
    top_k == 1), on the controls' device."""
    return (sample["temperature"] <= 0.0) | (sample["top_k"] == 1)


def sample_tokens(logits: torch.Tensor, sample: dict) -> torch.Tensor:
    """One token per row of ``logits`` [B, V] f32 -> [B] int32.

    ``sample`` holds ``all_greedy``, a host bool: whether every row is
    greedy, and so whether the sort runs at all. With True no other key
    is read. Otherwise it holds [B] tensors on logits' device:
    ``temperature`` (<= 0 -> greedy), ``top_k`` (0 or -1 -> off),
    ``top_p`` (>= 1 -> off), the row's draw ``uniform`` (``keyed_uniform``
    of its seed at the position of the sampled token, staged by the
    caller) and optionally ``mask`` (see ``apply_allow_mask``). Nothing
    here reads the device back."""
    logits = apply_allow_mask(logits, sample.get("mask"))
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if sample["all_greedy"]:
        return greedy
    controls = [sample[k] for k in ("temperature", "top_k", "top_p")]
    if any(t.device != logits.device for t in controls):
        raise ValueError(
            f"sampling controls must lie on the logits' device "
            f"{logits.device}, got {[str(t.device) for t in controls]}")
    sampled = _sampled_rows(logits, sample["uniform"], *controls)
    return torch.where(greedy_rows(sample), greedy, sampled)


def verify_tokens(logits: torch.Tensor, starts: torch.Tensor,
                  draft_tokens: torch.Tensor, draft_len: torch.Tensor,
                  sample: dict) -> torch.Tensor:
    """Speculative-decoding epilogue over a [B, W] verify window
    (``verify_tokens`` of the reference).

    ``logits`` [B, W, V] f32 are the target model's outputs at window
    columns 0..W-1: column 0 held each row's last committed token (true
    position ``starts`` [B]), columns 1..``draft_len`` [B] its drafted
    candidates ``draft_tokens`` [B, W]; later columns are padding. The
    logits at column s predict the token at position starts + s + 1, and
    the target token there is ``sample_tokens`` of that column: the same
    pure function of (logits, seed, position) as a decode step, so the
    committed stream equals non-speculative decoding, greedy or sampled.

    ``sample`` is ``sample_tokens``' dict for the B * W columns: a [B]
    leaf is tiled across the window, a leaf of two or more dims ([B, W]
    draws ``uniform``, keyed at positions starts + 1 + s; the [B, W,
    words] grammar ``mask``, one allow-set per column) flattens
    row-major. Draft column s is accepted iff it equals the target drawn
    at column s - 1, in a leading run within ``draft_len``.

    Returns packed [B, W + 1] int32: column 0 the committed count c in
    1..draft_len + 1 (the accepted drafts and one corrected or bonus
    token), columns 1..W the targets; the committed tokens are
    ``packed[b, 1:1 + c]``. No host read and no shape that depends on
    the data: a CUDA graph can capture it."""
    B, W, V = logits.shape
    flat = {}
    for k, v in sample.items():
        if isinstance(v, torch.Tensor):
            v = (v.reshape(B * W, *v.shape[2:]) if v.dim() >= 2
                 else v.repeat_interleave(W, dim=0))
        flat[k] = v
    tgt = sample_tokens(logits.reshape(B * W, V), flat).reshape(B, W)
    match = draft_tokens[:, 1:].to(torch.int32) == tgt[:, :-1]
    cols = torch.arange(1, W, device=logits.device)
    within = cols[None, :] <= draft_len[:, None]
    accepted = torch.cumprod((match & within).to(torch.int32), dim=1).sum(1)
    committed = (accepted + 1).to(torch.int32)
    return torch.cat([committed[:, None], tgt], dim=1)
