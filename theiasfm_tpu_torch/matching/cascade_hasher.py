"""Cascade hashing for fast descriptor matching in PyTorch (port of
theiasfm_tpu/matching/cascade_hasher.py).

ref: src/theia/matching/cascade_hasher.{h,cc} — the CVPR-2014 cascade
hashing pipeline: 128-bit primary binary hash (random Gaussian
projections of mean-centered descriptors), candidates ranked by Hamming
distance, then verified by L2 + Lowe ratio (constants
cascade_hasher.h:51-58).

The JAX module's dense formulation: a Hamming-distance matrix between
the two hash sets, the top-K candidates per query by Hamming distance,
exact L2 on the K candidates, and the ratio test. Here:

  * the Hamming matrix is one float32 matrix product of the bits as +-1:
    ham = (128 - b1 . b2) / 2, integers of at most 128 and exact in
    float32 (the product runs under `utils.device.full_f32`), equal to
    JAX's XOR + popcount over packed uint32 words;
  * JAX's top_k orders equal values by index, and two thirds of the
    query rows tie at the K-th candidate, so the candidates are the K
    smallest of the unique key ham * N2 + j (exact in float32 while
    129 * N2 < 2^24), and the final best/second by a stable sort;
  * the projection basis is drawn from a CPU torch.Generator seeded with
    `seed` and moved to the hasher's device, so a seed gives the same
    basis, and the same hashes, on the card and on the CPU, as
    jax.random gives the same numbers on every backend (no torch
    generator reproduces jax.random.normal's stream); or it is given
    (`proj=`, e.g. JAX's basis through
    convert.cascade_hasher_from_state).

Every function takes any number of leading batch dimensions (the
feature matcher's pair batch, which the JAX module vmaps).
"""
from __future__ import annotations

import torch

from ..utils.device import full_f32, resolve_device

NUM_HASH_BITS = 128  # ref kHashCodeSize (cascade_hasher.h:51-58)


class CascadeHasher:
    """Holds the random projection basis (generated once, like ref
    CascadeHasher::Initialize) on `device` (the card by default; it
    raises without one)."""

    def __init__(self, num_dimensions: int = 128, seed: int = 0,
                 num_candidates: int = 10, device="cuda", proj=None):
        device = resolve_device(device)
        if proj is None:
            proj = torch.randn((num_dimensions, NUM_HASH_BITS),
                               generator=torch.Generator().manual_seed(seed))
        self.proj = torch.as_tensor(proj, dtype=torch.float32,
                                    device=device)
        self.num_candidates = num_candidates

    def hash_bits(self, desc, mean):
        """desc (..., N, D) -> bits (..., N, 128) bool."""
        return _hash_bits(desc, mean, self.proj)

    def hash_descriptors(self, desc, mean):
        """desc (..., N, D) -> packed bits (..., N, 4) as int64 holding
        the JAX module's uint32 words (bit b of word w is hash bit
        32 w + b)."""
        return pack_bits(self.hash_bits(desc, mean))

    def match(self, desc1, desc2, mean, mask1=None, mask2=None,
              lowes_ratio: float = 0.8):
        """Hamming-prefiltered matching of desc1 (..., N1, D) against
        desc2 (..., N2, D). Returns (idx2 int32, valid, dist)."""
        if mask1 is None:
            mask1 = torch.ones(desc1.shape[:-1], dtype=torch.bool,
                               device=desc1.device)
        if mask2 is None:
            mask2 = torch.ones(desc2.shape[:-1], dtype=torch.bool,
                               device=desc2.device)
        with torch.no_grad():
            s1 = _signs(self.hash_bits(desc1, mean))
            s2 = _signs(self.hash_bits(desc2, mean))
            return _cascade_match(desc1, desc2, s1, s2, mask1, mask2,
                                  self.num_candidates, lowes_ratio)


def _hash_bits(desc, mean, proj):
    mean = torch.as_tensor(mean, dtype=desc.dtype, device=desc.device)
    with full_f32():
        return (desc - mean) @ proj > 0


def pack_bits(bits):
    """(..., 128) bool -> (..., 4) int64 words, bit b of word w being
    bits[32 w + b] (the JAX module's packing)."""
    w = bits.reshape(*bits.shape[:-1], NUM_HASH_BITS // 32, 32).long()
    return (w << torch.arange(32, device=bits.device)).sum(-1)


def _signs(bits):
    return bits.to(torch.float32) * 2.0 - 1.0


def hamming(s1, s2):
    """Hamming distances (..., N1, N2) float32 between +-1 hash codes
    s1 (..., N1, 128) and s2 (..., N2, 128): (128 - s1 . s2) / 2, exact
    integers."""
    with full_f32():
        return (NUM_HASH_BITS - s1 @ s2.transpose(-1, -2)) * 0.5


def _cascade_match(desc1, desc2, s1, s2, mask1, mask2,
                   num_candidates: int, lowes_ratio: float):
    N2 = desc2.shape[-2]
    # masked columns rank after every real one (the JAX module sets them
    # to 1 << 30; any value above 128 gives the same order)
    ham = torch.where(mask2[..., None, :], hamming(s1, s2),
                      float(NUM_HASH_BITS + 1))
    j = torch.arange(N2, dtype=torch.float32, device=ham.device)
    key = ham * N2 + j                               # unique, exact
    del ham
    cand = torch.topk(key, num_candidates, dim=-1, largest=False,
                      sorted=True).indices           # (..., N1, K)
    del key
    lead = cand.shape[:-2]
    N1, K = cand.shape[-2:]
    flat = cand.reshape(*lead, N1 * K)
    cand_desc = torch.gather(
        desc2, -2, flat[..., None].expand(*lead, N1 * K, desc2.shape[-1])
    ).reshape(*lead, N1, K, desc2.shape[-1])
    diff = desc1[..., :, None, :] - cand_desc
    d2 = (diff * diff).sum(-1)                       # (..., N1, K)
    cand_valid = torch.gather(mask2, -1, flat).reshape(*lead, N1, K)
    d2 = torch.where(cand_valid, d2, torch.inf)

    top2, pos = torch.sort(d2, dim=-1, stable=True)
    best, second = top2[..., 0], top2[..., 1]
    idx2 = torch.gather(cand, -1, pos[..., :1])[..., 0]
    ratio_ok = best < (lowes_ratio ** 2) * second
    valid = ratio_ok & torch.isfinite(best) & mask1
    return idx2.to(torch.int32), valid, best
