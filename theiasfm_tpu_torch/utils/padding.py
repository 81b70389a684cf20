"""Padding/bucketing helpers (port of theiasfm_tpu/utils/padding.py).

Ragged host arrays are padded to power-of-two buckets with a validity
mask, so the solver sees a small number of distinct shapes.
"""
from __future__ import annotations

import numpy as np


def next_bucket(n: int, minimum: int = 8) -> int:
    """Smallest power of two >= max(n, minimum)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def pad_to(arr: np.ndarray, size: int, axis: int = 0, fill=0):
    """Pad `arr` along `axis` to `size` with `fill`. Returns (padded,
    mask) where mask marks real rows."""
    n = arr.shape[axis]
    if n > size:
        raise ValueError(f"cannot pad {n} down to {size}")
    pad_width = [(0, 0)] * arr.ndim
    pad_width[axis] = (0, size - n)
    padded = np.pad(arr, pad_width, constant_values=fill)
    mask = np.zeros(size, dtype=bool)
    mask[:n] = True
    return padded, mask
