"""Guided epipolar matching: grow verified matches along epipolar lines
(port of theiasfm_tpu/matching/guided_matcher.py).

ref: src/theia/matching/guided_epipolar_matcher.{h,cc} — after the
two-view geometry is known, unmatched features are matched against
candidates near their epipolar line (the reference builds flann
KD-trees on grid cells). Here all pairwise point-to-line distances
come in one dense (N1, N2) op per pair, masked to a band, then the
ratio test runs on the band-masked descriptor distances. Batched over
leading pair dims; the tensors' device is the caller's.
"""
from __future__ import annotations

import math

import torch


def guided_epipolar_matching(F, kp1, kp2, desc1, desc2, mask1, mask2,
                             matched1, matched2,
                             band_pixels: float = 4.0,
                             lowes_ratio: float = 0.9):
    """Match yet-unmatched features constrained to the epipolar band.

    F (..., 3, 3) fundamental (x2^T F x1 = 0) in PIXEL coords; kp (...,
    N, 2); desc (..., N, D); matchedX (..., N) bool marks features
    already matched; band_pixels a number or a (...,) tensor.
    Returns (idx2 (..., N1) int32, valid (..., N1))."""
    x1h = torch.cat([kp1, torch.ones_like(kp1[..., :1])], dim=-1)
    x2h = torch.cat([kp2, torch.ones_like(kp2[..., :1])], dim=-1)
    # epipolar lines of kp1 in image 2: l = F x1
    lines = x1h @ F.transpose(-1, -2)                  # (..., N1, 3)
    denom = torch.sqrt(lines[..., 0] ** 2 + lines[..., 1] ** 2 + 1e-12)
    dist = (lines @ x2h.transpose(-1, -2)).abs() / denom[..., None]

    d2 = (torch.sum(desc1 * desc1, -1, keepdim=True) +
          torch.sum(desc2 * desc2, -1)[..., None, :] -
          2.0 * desc1 @ desc2.transpose(-1, -2))
    band = torch.as_tensor(band_pixels, dtype=dist.dtype, device=dist.device)
    band = band.reshape(band.shape + (1, 1))
    usable2 = mask2 & ~matched2
    d2 = torch.where((dist <= band) & usable2[..., None, :], d2,
                     torch.full_like(d2, math.inf))

    neg_top2, idx_top2 = torch.topk(-d2, 2, dim=-1)
    best = -neg_top2[..., 0]
    second = -neg_top2[..., 1]
    idx2 = idx_top2[..., 0].to(torch.int32)
    valid = (best < (lowes_ratio ** 2) * second) & torch.isfinite(best) & \
        mask1 & ~matched1
    return idx2, valid
