"""Small shared helpers."""
from __future__ import annotations


def pow2_bucket(n: int, minimum: int) -> int:
    """Smallest power of two >= max(n, minimum)."""
    return 1 << max(int(max(n, 1) - 1).bit_length(), minimum.bit_length() - 1)
