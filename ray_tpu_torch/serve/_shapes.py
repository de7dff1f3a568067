"""Shape-bucket helpers (a copy of ``ray_tpu/serve/_shapes.py``).

The engine pads batch sizes and sequence lengths to a closed set of
buckets, so the shapes a model step sees stay few. The port keeps the same
rule so its scheduling matches the JAX engine's step for step.
"""
from __future__ import annotations

from typing import Sequence


def pad_to_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (last bucket if none fits)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def pow2_buckets(lo: int, hi: int) -> tuple[int, ...]:
    """Ascending powers of two covering [lo, hi]: the default bucket ladder
    for sequence lengths and batch sizes. Bounds the number of distinct
    compiled shapes at log2(hi/lo)+1 per dimension."""
    if lo < 1 or hi < lo:
        raise ValueError(f"need 1 <= lo <= hi, got lo={lo} hi={hi}")
    out = []
    b = 1
    while b < lo:
        b *= 2
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return tuple(out)
