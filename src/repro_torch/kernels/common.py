"""Helpers shared across kernel subpackages."""
from __future__ import annotations


def pow2(n: int) -> int:
    """Smallest power of two >= n."""
    p = 1
    while p < n:
        p *= 2
    return p
