"""Fused descriptor matching: the counterpart of
theiasfm_tpu/matching/pallas_matcher.py.

The brute-force matcher (brute_force.py) materializes the whole (N1, N2)
distance matrix. The fused matcher streams it instead: for every query
row it keeps a running top-2 of ||b||² − 2a·b over the keys and writes
only (best, second, best index) per query.

    best, second, idx = top2(d1, d2, n2)

d1 (B, M, D) queries, d2 (B, N, D) keys, n2 (B, N) key squared norms,
all float32 and contiguous; an unbatched match is B = 1. best and
second (B, M) float32, idx (B, M) int32. On equal distances the lowest
key index wins, and second is the second smallest value of the multiset
(a duplicate of the best counts).

`top2` dispatches on the device of its tensors: on the CPU it runs the
plain PyTorch version `top2_plain` (the CPU tests use it); on a CUDA
tensor it launches the hand-written kernel of csrc/top2_match.cu (split
TF32 on the tensor cores: three TF32 products per float32 dot product),
which replaces both Pallas kernels (`_match_kernel` and
`_match_kernel_batched`), or raises. There is no fallback from one to
the other. Each CUDA launch adds one to the count "top2_match" in
utils/dispatch.py.

The wrappers' epilogue is plain torch, as in JAX: masked keys get the
squared norm 1e30, ||a||² is added back and clamped at 0, then the ratio
test, mask1 and (batched) the reverse pass with its back-check. The
kernel masks ragged M and N itself, so unlike the TPU wrappers nothing
is padded to a tile multiple; the outputs equal JAX's on [:N0].
"""
from __future__ import annotations

import torch

from ..utils.device import full_f32
from ..utils.dispatch import count_dispatch

_BIG = 1e30


def top2_plain(d1, d2, n2):
    """Plain version of the top2_match kernel: the whole (B, M, N)
    distance matrix n2 − 2·d1·d2ᵀ in float32, then argmin (first index
    among ties), its value, and the min with that one entry masked."""
    with full_f32():
        ab = torch.bmm(d1, d2.transpose(1, 2))
    dist = n2[:, None, :] - 2.0 * ab
    del ab
    idx = dist.argmin(-1, keepdim=True)
    best = dist.gather(-1, idx)[..., 0]
    second = dist.scatter(-1, idx, float("inf")).amin(-1)
    return best, second, idx[..., 0].to(torch.int32)


def _check(d1, d2, n2):
    if d1.dim() != 3 or d2.dim() != 3 or n2.dim() != 2:
        raise ValueError("top2 takes d1 (B, M, D), d2 (B, N, D), n2 (B, N);"
                         f" got {tuple(d1.shape)}, {tuple(d2.shape)}, "
                         f"{tuple(n2.shape)}")
    B, M, D = d1.shape
    N = d2.shape[1]
    if B > 65535:
        raise ValueError(f"top2_match takes at most 65535 pairs, got {B}")
    if d2.shape != (B, N, D) or n2.shape != (B, N):
        raise ValueError(f"shapes disagree: d1 {tuple(d1.shape)}, d2 "
                         f"{tuple(d2.shape)}, n2 {tuple(n2.shape)}")
    for name, t in (("d1", d1), ("d2", d2), ("n2", n2)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got "
                             f"{t.dtype}, contiguous={t.is_contiguous()}")
        if t.device != d1.device:
            raise RuntimeError(f"{name} on {t.device}, d1 on {d1.device}")
    return B, M, N, D


def top2(d1, d2, n2):
    """Running top-2 over the keys for every query: (best, second, idx).
    CPU tensors: the plain version. CUDA tensors: the top2_match kernel.
    Any other device raises."""
    dev = d1.device
    if dev.type == "cpu":
        return top2_plain(d1, d2, n2)
    if dev.type != "cuda":
        raise RuntimeError(f"top2 runs on the CPU (plain) or on CUDA (the "
                           f"top2_match kernel), got {dev}")
    B, M, N, D = _check(d1, d2, n2)
    best = torch.empty((B, M), dtype=torch.float32, device=dev)
    second = torch.empty((B, M), dtype=torch.float32, device=dev)
    idx = torch.empty((B, M), dtype=torch.int32, device=dev)
    if B * M == 0:
        return best, second, idx
    from .. import _kernels
    err = _kernels.library("top2_match").top2_match_f32(
        d1.data_ptr(), d2.data_ptr(), n2.data_ptr(), best.data_ptr(),
        second.data_ptr(), idx.data_ptr(), B, M, N, D,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"top2_match launch failed: cudaError {err}")
    count_dispatch("top2_match")
    return best, second, idx


def _masked_norms(d, mask):
    n = (d * d).sum(-1)
    return n if mask is None else torch.where(mask, n, _BIG)


def match_descriptors_fused_batch(desc1, desc2, mask1, mask2,
                                  lowes_ratio: float = 0.8,
                                  symmetric: bool = True):
    """Batched fused matcher over a stack of image pairs.

    desc1/desc2: (B, N, D) padded descriptor stacks; mask1/mask2 (B, N)
    mark valid rows. One top2 launch matches all pairs (and one more
    the reverse direction when symmetric). Returns (idx2 (B, N) int32,
    valid (B, N) bool, dist (B, N)): the counterpart of
    match_descriptors_pallas_batch.
    """
    d1 = desc1.to(torch.float32).contiguous()
    d2 = desc2.to(torch.float32).contiguous()
    best, second, idx = top2(d1, d2, _masked_norms(d2, mask2))
    n1_sq = (d1 * d1).sum(-1)
    best = torch.clamp_min(best + n1_sq, 0.0)
    second = torch.clamp_min(second + n1_sq, 0.0)
    valid = (best < (lowes_ratio ** 2) * second) & mask1

    if symmetric:
        _, _, ridx = top2(d2, d1, _masked_norms(d1, mask1))
        back = ridx.gather(1, idx.long())
        rows = torch.arange(d1.shape[1], dtype=idx.dtype, device=idx.device)
        valid = valid & (back == rows)
    return idx, valid, best


def match_descriptors_fused(desc1, desc2, mask1=None, mask2=None,
                            lowes_ratio: float = 0.8):
    """Drop-in fused matcher: same contract as
    brute_force.match_descriptors without the symmetric test (compose
    with a reverse call for symmetry); the counterpart of
    match_descriptors_pallas. desc1 (M, D), desc2 (N, D)."""
    d1 = desc1.to(torch.float32).contiguous()
    d2 = desc2.to(torch.float32).contiguous()
    best, second, idx = top2(d1[None], d2[None],
                             _masked_norms(d2, mask2)[None])
    n1_sq = (d1 * d1).sum(-1)
    best = torch.clamp_min(best[0] + n1_sq, 0.0)
    second = torch.clamp_min(second[0] + n1_sq, 0.0)
    valid = best < (lowes_ratio ** 2) * second
    if mask1 is not None:
        valid = valid & mask1
    return idx[0], valid, best
