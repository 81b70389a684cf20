"""Feature matching orchestrator: batch pairs -> device -> putative
matches in the database (port of theiasfm_tpu/matching/feature_matcher.py).

ref: src/theia/matching/feature_matcher.{h,cc} — AddImages /
SetImagePairsToMatch / MatchImages with DB storage per pair. Pairs are
batched into padded device calls: the fused top-2 matcher
(fused_matcher.py, the top2_match kernel) on the card once the chunk's
padded descriptor count reaches 2048, the torch brute force
(brute_force.py) otherwise, the routing rule of the JAX module.

Ported so far: the brute-force matcher without geometric verification
(`perform_geometric_verification=False`), which stores every pair with
enough putative matches and TwoViewInfo(num_verified_matches=n).
Geometric verification, guided matching and cascade hashing raise
NotImplementedError.

A chunk runs under three profiler ranges that chip_smoke.py reads for
its time breakdown: "match.pad" (host padding and the copy to the
device), "match.top2" (the matcher and the copy back) and "match.store"
(the database puts).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..sfm.view_graph import TwoViewInfo
from ..utils import next_bucket
from ..utils.device import resolve_device
from .brute_force import match_descriptors_batch
from .database import FeaturesAndMatchesDatabase, ImagePairMatch
from .fused_matcher import match_descriptors_fused_batch

# padded descriptors per image from which the card takes the fused
# matcher (the JAX module's threshold, set on a TPU; ROADMAP.md queue 2
# keeps its re-measurement on the H100)
FUSED_MIN_N = 2048


@dataclasses.dataclass(frozen=True)
class FeatureMatcherOptions:
    """ref: matching/feature_matcher_options.h. The fields and defaults
    of the JAX module's options; `geometric_verification` (the JAX
    module's TwoViewInfoOptions) is None until verification is ported."""
    lowes_ratio: float = 0.8
    guided_matching: bool = False
    keep_only_symmetric_matches: bool = True
    min_num_feature_matches: int = 30
    perform_geometric_verification: bool = True
    matcher: str = "brute_force"  # 'brute_force' | 'cascade_hashing'
    # pairs per device batch (32 covers an 8-image all-pairs run in one)
    pair_batch_size: int = 32
    geometric_verification: Optional[object] = None
    seed: int = 0


class FeatureMatcher:
    """ref FeatureMatcher base. Matches on `device` (the card by
    default; it raises without one)."""

    def __init__(self, options: FeatureMatcherOptions,
                 db: FeaturesAndMatchesDatabase, device="cuda"):
        if options.matcher == "cascade_hashing":
            raise NotImplementedError(
                "matcher='cascade_hashing' is not ported yet (ROADMAP.md "
                "queue 1, item 18: matching/cascade_hasher.py)")
        if options.matcher != "brute_force":
            raise ValueError(f"unknown matcher {options.matcher!r}")
        if options.perform_geometric_verification or \
                options.guided_matching:
            raise NotImplementedError(
                "geometric verification (and guided matching, which needs "
                "it) is not ported yet (ROADMAP.md queue 1, items 10 and "
                "12); pass perform_geometric_verification=False")
        self.options = options
        self.db = db
        self.device = resolve_device(device)
        self._names: List[str] = []
        self._pairs: Optional[List[Tuple[str, str]]] = None
        # feeds only geometric verification (the JAX module's PRNGKey),
        # which this slice does not run
        self._generator = torch.Generator().manual_seed(options.seed)

    def add_image(self, name: str):
        if name not in self._names:
            self._names.append(name)

    def add_images(self, names):
        for n in names:
            self.add_image(n)

    def set_image_pairs_to_match(self, pairs):
        self._pairs = list(pairs)

    def match_images(self) -> int:
        """Match all pairs (or the configured subset). Returns number of
        pairs stored."""
        pairs = self._pairs
        if pairs is None:
            pairs = [(a, b) for i, a in enumerate(self._names)
                     for b in self._names[i + 1:]]
        # resume: skip pairs already in the DB (ref front-end resume)
        pairs = [p for p in pairs
                 if self.db.get_match(p[0], p[1]) is None]
        n_stored = 0
        B = self.options.pair_batch_size
        for start in range(0, len(pairs), B):
            n_stored += self._match_chunk(pairs[start:start + B])
        return n_stored

    def _match_chunk(self, chunk) -> int:
        with record_function("match.pad"):
            feats, args = self._pad_chunk(chunk)
        with record_function("match.top2"):
            if self.device.type == "cuda" and \
                    args[0].shape[1] >= FUSED_MIN_N:
                # one top2_match launch for the whole pair batch, one
                # more for the reverse pass of the symmetric check
                match = match_descriptors_fused_batch
            else:
                match = match_descriptors_batch
            with torch.no_grad():
                idx2, valid, _ = match(
                    *args, lowes_ratio=self.options.lowes_ratio,
                    symmetric=self.options.keep_only_symmetric_matches)
            idx2 = idx2.cpu().numpy()
            valid = valid.cpu().numpy()
        with record_function("match.store"):
            return self._store(chunk, feats, idx2, valid)

    def _pad_chunk(self, chunk):
        """The chunk's features, and its descriptor stacks and masks
        padded to a shared 128-multiple bucket, on the device."""
        feats = {}
        for (a, b) in chunk:
            for n in (a, b):
                if n not in feats:
                    feats[n] = self.db.get_features(n)
        max_n = next_bucket(max(f.descriptors.shape[0]
                                for f in feats.values()), 128)
        D = next(iter(feats.values())).descriptors.shape[1]

        P = len(chunk)
        d1 = np.zeros((P, max_n, D), np.float32)
        d2 = np.zeros((P, max_n, D), np.float32)
        m1 = np.zeros((P, max_n), bool)
        m2 = np.zeros((P, max_n), bool)
        for i, (a, b) in enumerate(chunk):
            fa, fb = feats[a], feats[b]
            na, nb = fa.descriptors.shape[0], fb.descriptors.shape[0]
            d1[i, :na] = fa.descriptors
            d2[i, :nb] = fb.descriptors
            m1[i, :na] = True
            m2[i, :nb] = True
        return feats, [torch.from_numpy(x).to(self.device)
                       for x in (d1, d2, m1, m2)]

    def _store(self, chunk, feats, idx2, valid) -> int:
        """No verification: store each pair's putative matches."""
        n_stored = 0
        for i, (a, b) in enumerate(chunk):
            sel = np.nonzero(valid[i])[0]
            if len(sel) < self.options.min_num_feature_matches:
                continue
            kp1 = feats[a].keypoints[sel]
            kp2 = feats[b].keypoints[idx2[i][sel]]
            corr = np.concatenate([kp1[:, :2], kp2[:, :2]], axis=-1)
            info = TwoViewInfo(num_verified_matches=len(corr))
            self.db.put_match(a, b, ImagePairMatch(
                image1=a, image2=b, twoview_info=info,
                correspondences=corr))
            n_stored += 1
        return n_stored
