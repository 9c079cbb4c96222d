"""Helpers shared across kernel subpackages."""
from __future__ import annotations

import threading

_launch_lock = threading.Lock()


def pow2(n: int) -> int:
    """Smallest power of two >= n."""
    p = 1
    while p < n:
        p *= 2
    return p


def count_launch(namespace: dict) -> None:
    """Add one to the counter ``namespace["launches"]`` (a wrapper module's
    globals()) under a lock shared by every wrapper: writer threads launch
    kernels concurrently, and an unlocked ``+=`` can lose a count."""
    with _launch_lock:
        namespace["launches"] += 1
