"""Brute-force descriptor matching (port of
theiasfm_tpu/matching/brute_force.py).

ref: src/theia/matching/brute_force_feature_matcher.{h,cc} (all-pairs
L2 + Lowe's ratio + optional symmetric check). The all-pairs distance
matrix is one batched float32 matrix product, ||a||^2 + ||b||^2 - 2 a.b,
as in the JAX module; the ratio decisions depend on that formula. The
product runs under `utils.device.full_f32`, so it is full float32 on the
card too (no TF32), and is left to torch.matmul as JAX left it to XLA.

The top-2 is an argmin (first index among equal distances) and the min
of the row with that one entry masked, which is what lax.top_k(-d, 2)
gives: a duplicate of the best distance counts as the second.
"""
from __future__ import annotations

import torch

from ..utils.device import full_f32


def _match(desc1, desc2, mask1, mask2, lowes_ratio, symmetric):
    """desc1 (..., N1, D), desc2 (..., N2, D), masks (..., N) or None."""
    with full_f32():
        ab = torch.matmul(desc1, desc2.transpose(-1, -2))
    n1 = (desc1 * desc1).sum(-1, keepdim=True)                # (..., N1, 1)
    n2 = (desc2 * desc2).sum(-1, keepdim=True).transpose(-1, -2)
    d2 = torch.clamp_min(n1 + n2 - 2.0 * ab, 0.0)
    del ab
    inf = float("inf")
    if mask2 is not None:
        d2 = torch.where(mask2[..., None, :], d2, inf)

    idx2 = d2.argmin(-1, keepdim=True)
    best = d2.gather(-1, idx2)[..., 0]
    second = d2.scatter(-1, idx2, inf).amin(-1)
    idx2 = idx2[..., 0].to(torch.int32)
    valid = (best < (lowes_ratio ** 2) * second) & torch.isfinite(best)
    if mask1 is not None:
        valid = valid & mask1

    if symmetric:
        d2r = d2 if mask1 is None else torch.where(mask1[..., :, None],
                                                   d2, inf)
        rev_best = d2r.argmin(-2).to(torch.int32)             # (..., N2)
        back = rev_best.gather(-1, idx2.long())
        rows = torch.arange(desc1.shape[-2], dtype=torch.int32,
                            device=desc1.device)
        valid = valid & (back == rows)
    return idx2, valid, best


def match_descriptors(desc1, desc2, mask1=None, mask2=None,
                      lowes_ratio: float = 0.8, symmetric: bool = True):
    """Match desc1 (N1, D) -> desc2 (N2, D), float32 tensors.

    Returns (idx2 (N1,) int32 best match per query, valid (N1,) bool,
    dist (N1,) squared L2 of best match). Invalid rows (mask False or
    failing ratio/symmetry) have valid=False.
    """
    return _match(desc1, desc2, mask1, mask2, lowes_ratio, symmetric)


def match_descriptors_batch(desc1, desc2, mask1, mask2,
                            lowes_ratio: float = 0.8,
                            symmetric: bool = True):
    """Pair matching over a batch: desc1 (P, N1, D), desc2 (P, N2, D),
    masks (P, N1), (P, N2) — the batched replacement for the reference's
    thread-pool chunks of <=20 pairs (feature_matcher.h:135)."""
    return _match(desc1, desc2, mask1, mask2, lowes_ratio, symmetric)
