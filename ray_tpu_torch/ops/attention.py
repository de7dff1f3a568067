"""Attention: the plain reference, flash attention and its three CUDA
kernels (counterpart of ``ray_tpu/ops/attention.py``).

- ``flash_forward_cuda`` launches ``csrc/flash_fwd.cu`` (kernel B1,
  replacing ``_flash_fwd_kernel``): the forward with a base-2 online
  softmax, writing o and the base-2 log-sum-exp; bf16 inputs run on the
  tensor cores, f32 inputs on the CUDA cores.
- ``flash_bwd_dkv_cuda`` launches kernel B2 of ``csrc/flash_bwd.cu``
  (replacing ``_flash_bwd_dkv_kernel``): dK and dV.
- ``flash_bwd_dq_cuda`` launches kernel B3 of the same source (replacing
  ``_flash_bwd_dq_kernel``): dQ. ``flash_backward_cuda`` runs B2 then B3,
  the TPU code's two-pass schedule, after ``delta = rowsum(dO * O)``. As
  for B1, bf16 inputs run on the tensor cores, f32 inputs on the CUDA
  cores.

Beside each is its plain version (``flash_forward_reference``,
``flash_bwd_dkv_reference``, ``flash_bwd_dq_reference``, and
``flash_backward_reference`` for both): dense, untiled, with the TPU
kernels' rounding points
(q scaled in q's dtype; with bf16 inputs ``s - m`` and ``s - lse`` rounded
to bf16 before ``exp2``; max, sums and accumulators f32; p and ds cast to
the operand dtype before their products; dQ stored in q's dtype, then
rescaled by ``scale * log2 e``). ``FlashAttention`` ties forward and
backward into one ``torch.autograd.Function`` and dispatches on the
``auto | torch | cuda`` knob: the kernels for CUDA tensors, the plain
versions for CPU tensors (or when ``torch`` is asked for). A kernel wrapper
takes CUDA tensors only and raises on a launch error; it never falls back.
Each kernel counts its launches in ``LAUNCHES``.
"""
from __future__ import annotations

import math

import torch

from ray_tpu_torch import _build
from ray_tpu_torch._device import resolve_backend

NEG_INF = -1e30
LOG2E = math.log2(math.e)
LN2 = math.log(2.0)

# launches of each kernel by its wrapper — a run resets these to 0 and
# reads them to show which kernels its path went through
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)  # head dims the CUDA kernels are built for


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain attention. q, k, v: [B, H, S, D] (kv may have fewer heads —
    grouped-query; heads must divide). Scores and softmax in f32."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    k, v = repeat_kv(q, k, v)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s_q, s_k = q.shape[2], k.shape[2]
        mask = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device).tril(
            s_k - s_q
        )
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def repeat_kv(q, k, v):
    """Grouped-query attention: repeat each kv head over its query heads."""
    if q.shape[1] == k.shape[1]:
        return k, v
    rep = q.shape[1] // k.shape[1]
    return k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)


# ------------------------------------------------------------ plain versions

def _scaled_q(q, scale):
    """q * round(scale * log2 e) in q's dtype: the base-2 pre-scaled q."""
    return q * torch.tensor(scale * LOG2E, dtype=q.dtype)


def _scores(qs, k, causal):
    """f32 scores [B, H, S, S] of the pre-scaled q, causally masked."""
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    if causal:
        mask = torch.ones(qs.shape[2], k.shape[2], dtype=torch.bool,
                          device=qs.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    return s


def _exp2(x, dtype):
    """exp2 at the kernels' precision: with bf16 inputs the argument and
    the result are rounded to bf16."""
    if dtype == torch.bfloat16:
        return torch.exp2(x.to(torch.bfloat16)).float()
    return torch.exp2(x)


def flash_forward_reference(q, k, v, *, causal: bool, scale: float):
    """Plain version of B1. q, k, v [B, H, S, D] (one dtype) ->
    (o [B, H, S, D] in q's dtype, base-2 lse [B, H, S] f32)."""
    s = _scores(_scaled_q(q, scale), k, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = _exp2(s - m, q.dtype)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    o = (acc / l_safe).to(q.dtype)
    return o, (m + torch.log2(l_safe))[..., 0]


def _probs_and_ds(q, k, v, lse, delta, do, causal, scale):
    """The pre-scaled q, p and ds that both backward kernels recompute,
    with p and ds rounded to the inputs' dtype."""
    dtype = q.dtype
    qs = _scaled_q(q, scale)
    s = _scores(qs, k, causal)
    p = _exp2(s - lse[..., None], dtype).to(dtype).float()
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta[..., None]) * LN2).to(dtype).float()
    return qs, p, ds


def attention_delta(o, do):
    """delta = rowsum(dO * O) in f32, [B, H, S]: a plain op, as it stays
    XLA on the TPU."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_bwd_dkv_reference(q, k, v, lse, delta, do, *, causal: bool,
                            scale: float):
    """Plain version of B2: (dk, dv) in k's and v's dtype."""
    qs, p, ds = _probs_and_ds(q, k, v, lse, delta, do, causal, scale)
    dv = torch.matmul(p.transpose(-1, -2), do.float()).to(v.dtype)
    dk = torch.matmul(ds.transpose(-1, -2), qs.float()).to(k.dtype)
    return dk, dv


def flash_bwd_dq_reference(q, k, v, lse, delta, do, *, causal: bool,
                           scale: float):
    """Plain version of B3: dq, stored in q's dtype and then rescaled by
    ``scale * log2 e`` (the chain rule back from the pre-scaled q)."""
    _, _, ds = _probs_and_ds(q, k, v, lse, delta, do, causal, scale)
    return _scaled_q(torch.matmul(ds, k.float()).to(q.dtype), scale)


def flash_backward_reference(q, k, v, o, lse, do, *, causal: bool,
                             scale: float):
    """Plain version of B2 and B3: (dq, dk, dv) in the inputs' dtype."""
    delta = attention_delta(o, do)
    kw = dict(causal=causal, scale=scale)
    dk, dv = flash_bwd_dkv_reference(q, k, v, lse, delta, do, **kw)
    return flash_bwd_dq_reference(q, k, v, lse, delta, do, **kw), dk, dv


# ---------------------------------------------------------- kernel wrappers

def _check(name, tensors):
    if not all(t.is_cuda for t in tensors):
        raise ValueError(
            f"{name} runs only on CUDA tensors, got devices "
            f"{[str(t.device) for t in tensors]}"
        )
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: all tensors must be on one device")
    q = tensors[0]
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype
                                          for t in tensors[:4]):
        raise TypeError(
            f"{name}: q, k, v (and dO) must share one dtype, float32 or "
            f"bfloat16; got {[t.dtype for t in tensors[:4]]}"
        )
    if q.dim() != 4 or any(t.shape != q.shape for t in tensors[:4]):
        raise ValueError(
            f"{name}: q, k, v (and dO) must be [B, H, S, D] of one shape, got "
            f"{[tuple(t.shape) for t in tensors[:4]]}"
        )
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {q.shape[-1]} not in {HEAD_DIMS}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: all tensors must be contiguous")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_forward_cuda(q, k, v, *, causal: bool, scale: float,
                       save_lse: bool = True):
    """Kernel B1; same contract as ``flash_forward_reference`` (lse is None
    unless ``save_lse``)."""
    _check("flash_fwd", (q, k, v))
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_fwd: q, k and v must start on a 16-byte "
                         "boundary (the kernel copies them in 16-byte pieces)")
    B, H, S, D = q.shape
    o = torch.empty_like(q)
    lse = (torch.empty(B, H, S, dtype=torch.float32, device=q.device)
           if save_lse else None)
    if q.numel() == 0:
        return o, lse
    fn = _build.bind("flash_fwd", "flash_fwd", "p" * 5 + "iiifiip")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr() if save_lse else None, B * H, S, D,
                scale * LOG2E, int(causal), _DTYPE_CODES[q.dtype], _stream(q))
    _build.raise_on("flash_fwd", "flash_fwd", rc)
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def _check_bwd(name, q, k, v, lse, delta, do):
    _check(name, (q, k, v, do, lse, delta))
    if any(t.data_ptr() % 16 for t in (q, k, v, do)):
        raise ValueError(f"{name}: q, k, v and dO must start on a 16-byte "
                         "boundary (the kernel copies them in 16-byte pieces)")
    rows = tuple(q.shape[:3])
    if lse.shape != rows or delta.shape != rows or \
            lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError(f"{name}: lse and delta must be [B, H, S] f32")


def flash_bwd_dkv_cuda(q, k, v, lse, delta, do, *, causal: bool,
                       scale: float):
    """Kernel B2; same contract as ``flash_bwd_dkv_reference``."""
    _check_bwd("flash_bwd_dkv", q, k, v, lse, delta, do)
    B, H, S, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dk, dv
    fn = _build.bind("flash_bwd", "flash_bwd_dkv", "p" * 8 + "iiifiip")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), B * H, S, D, scale * LOG2E, int(causal),
                _DTYPE_CODES[q.dtype], _stream(q))
    _build.raise_on("flash_bwd", "flash_bwd_dkv", rc)
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def flash_bwd_dq_cuda(q, k, v, lse, delta, do, *, causal: bool,
                      scale: float):
    """Kernel B3; same contract as ``flash_bwd_dq_reference``."""
    _check_bwd("flash_bwd_dq", q, k, v, lse, delta, do)
    B, H, S, D = q.shape
    dq = torch.empty_like(q)
    if q.numel() == 0:
        return dq
    fn = _build.bind("flash_bwd", "flash_bwd_dq", "p" * 7 + "iiifiip")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B * H, S,
                D, scale * LOG2E, int(causal), _DTYPE_CODES[q.dtype],
                _stream(q))
    _build.raise_on("flash_bwd", "flash_bwd_dq", rc)
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_backward_cuda(q, k, v, o, lse, do, *, causal: bool, scale: float):
    """Kernels B2 then B3; same contract as ``flash_backward_reference``."""
    if not o.is_cuda or o.shape != q.shape or o.dtype != q.dtype:
        raise ValueError("flash_bwd runs only on CUDA tensors, o like q")
    delta = attention_delta(o, do)
    kw = dict(causal=causal, scale=scale)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, lse, delta, do, **kw)
    return flash_bwd_dq_cuda(q, k, v, lse, delta, do, **kw), dk, dv


# ----------------------------------------------------------------- autograd

class FlashAttention(torch.autograd.Function):
    """Flash attention with the kernels' backward. Forward saves
    (q, k, v, o, lse); backward runs B2 then B3 (or their plain versions
    under the ``torch`` backend)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, backend: str):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if backend == "cuda":
            o, lse = flash_forward_cuda(q, k, v, causal=causal, scale=scale,
                                        save_lse=ctx.needs_input_grad[0]
                                        or ctx.needs_input_grad[1]
                                        or ctx.needs_input_grad[2])
        else:
            o, lse = flash_forward_reference(q, k, v, causal=causal,
                                             scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.backend = causal, scale, backend
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        fn = (flash_backward_cuda if ctx.backend == "cuda"
              else flash_backward_reference)
        dq, dk, dv = fn(q, k, v, o, lse, do, causal=ctx.causal,
                        scale=ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
    backend: str = "auto",
) -> torch.Tensor:
    """Flash attention. q [B, H, S, D], k/v [B, Hkv, S, D] (Hkv divides
    H: grouped-query, repeated up front as the TPU code does); returns
    [B, H, S, D] in q's dtype. Tile sizes belong to the kernels."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    k, v = repeat_kv(q, k, v)
    return FlashAttention.apply(q, k, v, causal, scale,
                                resolve_backend(backend, q))
