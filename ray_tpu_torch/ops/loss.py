"""Fused lm-head + cross-entropy, chunked over tokens, with the gradients
computed in the forward pass (counterpart of ``ray_tpu/ops/loss.py``).

The loss gradient with respect to the logits is closed-form
(``softmax(logits) - onehot(target)``, masked and normalized), so the
``[N, V]`` logits never exist whole: per chunk of tokens the forward
computes the logits, their log-sum-exp and target logit, forms
``dlogits`` and contracts it at once into ``dx_c = dlogits @ W`` and
``dW += dlogits^T @ x_c``. Peak memory is O(chunk * V); the backward only
scales the saved dx and dW by the upstream gradient.

The three products are plain matrix products (the JAX package leaves them
to XLA), on ``x.dtype`` operands with f32 results, as JAX's
``preferred_element_type=float32``: bf16 operands on the card go through
``torch.mm(..., out_dtype=torch.float32)``, everything else computes in f32
(exact for bf16 operands, with TF32 off).
"""
from __future__ import annotations

import torch


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an f32 result and f32 accumulation; a and b share a
    dtype. bf16 on the card keeps bf16 operands (tensor-core rate)."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class FusedLMHeadLoss(torch.autograd.Function):
    """Mean cross-entropy of ``x @ w.T`` against ``targets``; see
    ``fused_lm_head_loss``."""

    @staticmethod
    def forward(ctx, x, w, targets, mask, chunk: int):
        n, d = x.shape
        dtype = x.dtype
        wc = w.to(dtype)
        if mask is None:
            mask = torch.ones(n, dtype=torch.float32, device=x.device)
        mask = mask.float()
        loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=x.device)
        dx = torch.empty(n, d, dtype=torch.float32, device=x.device)
        for lo in range(0, n, chunk):
            xc, tc = x[lo:lo + chunk], targets[lo:lo + chunk].long()
            mc = mask[lo:lo + chunk]
            logits = mm_f32(xc, wc.t())                      # [C, V] f32
            lse = torch.logsumexp(logits, dim=-1)
            picked = logits.gather(1, tc[:, None])[:, 0]
            loss_sum += ((lse - picked) * mc).sum()
            # closed-form d(sum CE)/d(logits), unnormalized, in place of
            # the logits: (softmax - onehot) * mask
            dlogits = logits.sub_(lse[:, None]).exp_()
            dlogits[torch.arange(len(tc), device=x.device), tc] -= 1.0
            dlogits = (dlogits * mc[:, None]).to(dtype)
            dx[lo:lo + chunk] = mm_f32(dlogits, wc)
            dw += mm_f32(dlogits.t(), xc)
        cnt = mask.sum().clamp(min=1.0)
        ctx.save_for_backward((dx / cnt).to(x.dtype), (dw / cnt).to(w.dtype))
        return loss_sum / cnt

    @staticmethod
    def backward(ctx, g):
        dx, dw = ctx.saved_tensors
        gf = g.float()
        return ((gf * dx.float()).to(dx.dtype), (gf * dw.float()).to(dw.dtype),
                None, None, None)


def fused_lm_head_loss(x, w, targets, mask=None, chunk: int = 4096):
    """Mean next-token cross-entropy of ``x @ w.T`` against ``targets``.

    x: [N, D] activations (products run on x.dtype operands with f32
    results), w: [V, D] tied embedding table (cast to x.dtype; its gradient
    comes back in w's dtype), targets: [N] int, mask: [N] float or None
    (1 = count this token). Returns a scalar f32 loss (mean over unmasked
    tokens)."""
    return FusedLMHeadLoss.apply(x, w, targets, mask, chunk)
