"""Host-side draft proposal for speculative decoding (the port's copy of
``ray_tpu/serve/llm/drafter.py``).

A ``Drafter`` proposes up to k candidate next tokens for a sequence from
host-visible state alone (prompt + committed tokens as plain Python ints);
the engine packs the proposals into a [B, k+1] verify window that the
target model scores in ONE step (``executor.verify_step``: one captured
CUDA graph per verify signature on a card), and the ``verify_tokens``
epilogue (ops/sampling.py) accepts a prefix of them plus one corrected
token. The drafter is pure scheduling input: a wrong draft costs only
wasted verify work, never correctness — acceptance is exact-match
against the keyed sampler, so committed streams are byte-identical to
non-speculative decoding whatever the drafter says.

This module is device-free and numpy-free: it runs on the scheduler's
host thread between steps and holds no device memory. A learned draft
model can implement the same ``propose`` contract later; the engine
only depends on the interface below.

``NGramDrafter`` is the model-free default: prompt-lookup decoding
(Saxena; also vLLM's ngram speculator) — find the most recent earlier
occurrence of the current n-gram suffix in prompt + generated and propose
its continuation. It shines exactly where one-token-per-step decode hurts
most: repeated structure (code, templated text, greedy repetition loops),
where long continuations verify successfully and a step commits several
tokens at once.
"""
from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable


@runtime_checkable
class Drafter(Protocol):
    """Proposes candidate continuation tokens for one sequence."""

    def propose(
        self, prompt: Sequence[int], generated: Sequence[int], k: int
    ) -> list[int]:
        """Return 0..k draft token ids expected to follow
        ``prompt + generated``. Fewer than k (including none) is always
        legal — the engine clamps per-row draft length to what the step
        budget allows anyway. Must not touch device values."""
        ...


class NGramDrafter:
    """Prompt-lookup drafter: match the longest recent suffix n-gram
    (``max_n`` down to ``min_n`` tokens) against earlier context and
    propose the tokens that followed its most recent occurrence."""

    def __init__(self, max_n: int = 4, min_n: int = 1):
        if min_n < 1 or max_n < min_n:
            raise ValueError(
                f"need 1 <= min_n <= max_n, got min_n={min_n} max_n={max_n}"
            )
        self.max_n = max_n
        self.min_n = min_n

    def propose(
        self, prompt: Sequence[int], generated: Sequence[int], k: int
    ) -> list[int]:
        if k <= 0:
            return []
        ctx = list(prompt) + list(generated)
        L = len(ctx)
        for n in range(min(self.max_n, L - 1), self.min_n - 1, -1):
            pattern = ctx[L - n:]
            # most recent earlier occurrence wins: recent context is the
            # best predictor when generation has entered a repeating cycle
            for i in range(L - n - 1, -1, -1):
                if ctx[i:i + n] == pattern:
                    return ctx[i + n:i + n + k]
        return []


def build_drafter(spec) -> Drafter | None:
    """EngineConfig.drafter -> Drafter instance. Accepts None (no drafts:
    every speculative step degenerates to draft_len 0), the string
    "ngram", or any object with a ``propose`` method (duck-typed so tests
    can inject oracles/adversaries)."""
    if spec is None:
        return None
    if isinstance(spec, str):
        if spec == "ngram":
            return NGramDrafter()
        raise ValueError(
            f"unknown drafter {spec!r}; expected 'ngram', None, or a "
            "Drafter instance"
        )
    if not hasattr(spec, "propose"):
        raise TypeError(
            f"drafter {spec!r} does not implement Drafter.propose"
        )
    return spec
