"""Padding and batching shared by the estimators' entry points.

Each entry point takes one problem, (N, k) tensors, or a batch of them,
(B, N, k) tensors; the data are padded to the JAX module's power-of-two
bucket with its fill rows and masked out, and the batch goes through
the engine's `ransac_batch` in one call. Batch element b computes what
the one-problem call computes on problem b.
"""
from __future__ import annotations

import torch

from ...solvers import ransac_batch
from ...utils import next_bucket


def pad_data(data, fills, mask, minimum):
    """Pad every (..., N, k) tensor of `data` along N to
    next_bucket(N, minimum) with its fill row from `fills` (a k-vector,
    or 0.0). Returns (padded data, padded mask (..., b), n)."""
    first = next(iter(data.values()))
    n = first.shape[-2]
    b = next_bucket(n, minimum)
    if mask is None:
        mask = torch.ones(first.shape[:-1], dtype=torch.bool,
                          device=first.device)
    if b == n:
        return data, mask, n
    out = {}
    for k, v in data.items():
        row = torch.as_tensor(fills.get(k, 0.0), dtype=v.dtype,
                              device=v.device)
        pad = row.expand(v.shape[:-2] + (b - n, v.shape[-1]))
        out[k] = torch.cat([v, pad], dim=-2)
    mask = torch.cat([mask, mask.new_zeros(mask.shape[:-1] + (b - n,))],
                     dim=-1)
    return out, mask, n


def run(samples, spec, data, options, mask):
    """RANSAC over one problem ((N, k) data, a generator or (H, s)
    indices) or a batch ((B, N, k) data, a generator or (B, H, s)
    indices). Returns (model, summary), without the batch axis for one
    problem."""
    one = next(iter(data.values())).dim() == 2
    if one:
        data = {k: v[None] for k, v in data.items()}
        mask = mask[None]
        if not isinstance(samples, torch.Generator):
            samples = samples[None]
    model, summary = ransac_batch(samples, spec, data, options,
                                  data_mask=mask)
    if one:
        model = model[0]
        summary = summary._replace(
            inliers=summary.inliers[0], num_inliers=summary.num_inliers[0],
            confidence=summary.confidence[0],
            best_score=summary.best_score[0])
    return model, summary
