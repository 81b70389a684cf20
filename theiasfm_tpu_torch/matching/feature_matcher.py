"""Feature matching orchestrator: batch pairs -> device -> verified
matches in the database (port of theiasfm_tpu/matching/feature_matcher.py).

ref: src/theia/matching/feature_matcher.{h,cc} — AddImages /
SetImagePairsToMatch / MatchImages with geometric verification and DB
storage per pair (feature_matcher.cc:116-133). Pairs are batched into
padded device calls: the fused top-2 matcher (fused_matcher.py, the
top2_match kernel) on the card once the chunk's padded descriptor
count reaches 2048, the torch brute force (brute_force.py) otherwise,
the routing rule of the JAX module. With verification on (the
default) the chunk's pairs with enough putative matches are verified
in one batched call (sfm/pipeline/geometric_verification.py:
5-pt RANSAC, homography count, optional guided matching, two-view BA,
triangulation gates) on the matcher's device, from hypotheses drawn by
the matcher's generator there.

With matcher="cascade_hashing" the JAX module's cascade branch runs
instead of the top-2 matchers: one CascadeHasher per matcher (built on
the first chunk's descriptor width, seeded with the options' seed), the
chunk's mean descriptor computed on the host in numpy float32 as the JAX
module writes it (so the bits are JAX's for the same basis), the pair
batch in one batched call, and no symmetric pass (the JAX branch ignores
keep_only_symmetric_matches). Verification then runs as on the brute
force path.

A chunk runs under profiler ranges that chip_smoke.py reads for its
time breakdown: "match.pad" (host padding and the copy to the device),
"match.top2" (the matcher) or "match.cascade" (the cascade hasher),
the verification's "verify.*" ranges and "match.store" (the database
puts).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..sfm.pipeline.twoview import TwoViewInfoOptions
from ..sfm.view_graph import TwoViewInfo
from ..utils import next_bucket
from ..utils.device import resolve_device
from .brute_force import match_descriptors_batch
from .cascade_hasher import CascadeHasher
from .database import FeaturesAndMatchesDatabase, ImagePairMatch
from .fused_matcher import match_descriptors_fused_batch

# padded descriptors per image from which the card takes the fused
# matcher (the JAX module's threshold, set on a TPU; ROADMAP.md queue 2
# keeps its re-measurement on the H100)
FUSED_MIN_N = 2048


@dataclasses.dataclass(frozen=True)
class FeatureMatcherOptions:
    """ref: matching/feature_matcher_options.h. The fields and defaults
    of the JAX module's options."""
    lowes_ratio: float = 0.8
    guided_matching: bool = False
    keep_only_symmetric_matches: bool = True
    min_num_feature_matches: int = 30
    perform_geometric_verification: bool = True
    matcher: str = "brute_force"  # 'brute_force' | 'cascade_hashing'
    # pairs per device batch (32 covers an 8-image all-pairs run in one)
    pair_batch_size: int = 32
    geometric_verification: TwoViewInfoOptions = TwoViewInfoOptions()
    seed: int = 0


class FeatureMatcher:
    """ref FeatureMatcher base. Matches on `device` (the card by
    default; it raises without one)."""

    def __init__(self, options: FeatureMatcherOptions,
                 db: FeaturesAndMatchesDatabase, device="cuda"):
        if options.matcher not in ("brute_force", "cascade_hashing"):
            raise ValueError(f"unknown matcher {options.matcher!r}")
        self.options = options
        self.db = db
        self.device = resolve_device(device)
        self._names: List[str] = []
        self._pairs: Optional[List[Tuple[str, str]]] = None
        # draws the verification's hypotheses on the matcher's device
        # (the JAX module's PRNGKey(seed))
        self._generator = torch.Generator(self.device).manual_seed(
            options.seed)
        self._hasher: Optional[CascadeHasher] = None

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
            feats, host, args, kps = self._pad_chunk(chunk)
        if self.options.matcher == "cascade_hashing":
            with record_function("match.cascade"):
                idx2, valid = self._cascade(host, args)
        else:
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
        # putative matches per pair: (pair index, a, b, corr (Mi, 4))
        putative = []
        for i, (a, b) in enumerate(chunk):
            sel = np.nonzero(valid[i])[0]
            if len(sel) < self.options.min_num_feature_matches:
                continue
            kp1 = feats[a].keypoints[sel]
            kp2 = feats[b].keypoints[idx2[i][sel]]
            putative.append((i, a, b, np.concatenate(
                [kp1[:, :2], kp2[:, :2]], axis=-1)))
        if not putative:
            return 0
        if not self.options.perform_geometric_verification:
            results = [(a, b, TwoViewInfo(num_verified_matches=len(corr)),
                        corr) for _, a, b, corr in putative]
        else:
            with torch.no_grad():
                results = self._verify(putative, args, kps)
        with record_function("match.store"):
            for a, b, info, corr in results:
                self.db.put_match(a, b, ImagePairMatch(
                    image1=a, image2=b, twoview_info=info,
                    correspondences=corr))
        return len(results)

    def _cascade(self, host, args):
        """The chunk's pairs through the cascade hasher in one batched
        call; the mean over the chunk's real descriptor rows (host, the
        padded numpy stacks) is the JAX module's numpy float32 mean."""
        h1, h2, k1, k2 = host
        D = h1.shape[-1]
        if self._hasher is None:
            self._hasher = CascadeHasher(D, seed=self.options.seed,
                                         device=self.device)
        mean = np.concatenate([h1.reshape(-1, D)[k1.reshape(-1)],
                               h2.reshape(-1, D)[k2.reshape(-1)]]).mean(0)
        d1, d2, m1, m2 = args
        idx2, valid, _ = self._hasher.match(
            d1, d2, mean, m1, m2, lowes_ratio=self.options.lowes_ratio)
        return idx2, valid

    def _pad_chunk(self, chunk):
        """The chunk's features, its descriptor stacks and masks padded
        to a shared 128-multiple bucket on the host and on the device,
        and its keypoints (P, max_n, 4) padded alike on the host (guided
        matching reads them)."""
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
        kp1p = np.zeros((P, max_n, 4))
        kp2p = np.zeros((P, max_n, 4))
        m1 = np.zeros((P, max_n), bool)
        m2 = np.zeros((P, max_n), bool)
        for i, (a, b) in enumerate(chunk):
            fa, fb = feats[a], feats[b]
            na, nb = fa.descriptors.shape[0], fb.descriptors.shape[0]
            d1[i, :na] = fa.descriptors
            d2[i, :nb] = fb.descriptors
            kp1p[i, :na] = fa.keypoints[:, :4]
            kp2p[i, :nb] = fb.keypoints[:, :4]
            m1[i, :na] = True
            m2[i, :nb] = True
        host = (d1, d2, m1, m2)
        return feats, host, [torch.from_numpy(x).to(self.device)
                             for x in host], (kp1p, kp2p)

    def _verify(self, putative, args, kps):
        """One batched verification of the chunk's putative pairs on the
        matcher's device. Returns [(a, b, TwoViewInfo, corr)] of the
        pairs that pass."""
        # imported here: the verification imports the guided matcher of
        # this package
        from ..sfm.pipeline.geometric_verification import (
            GeometricVerificationOptions, verify_matches_batch)
        Pn = len(putative)
        maxm = next_bucket(max(len(c) for _, _, _, c in putative), 64)
        pix1 = np.zeros((Pn, maxm, 2))
        pix2 = np.zeros((Pn, maxm, 2))
        pmask = np.zeros((Pn, maxm), bool)
        f1s = np.zeros(Pn)
        f2s = np.zeros(Pn)
        pp1s = np.zeros((Pn, 2))
        pp2s = np.zeros((Pn, 2))
        sizes = np.zeros((Pn, 2, 2))
        for j, (_, a, b, corr) in enumerate(putative):
            n = len(corr)
            pix1[j, :n] = corr[:, :2]
            pix2[j, :n] = corr[:, 2:]
            pmask[j, :n] = True
            prior1 = self.db.get_intrinsics_prior(a)
            prior2 = self.db.get_intrinsics_prior(b)
            f1s[j], pp1s[j] = _focal_pp(prior1)
            f2s[j], pp2s[j] = _focal_pp(prior2)
            sizes[j, 0] = _image_size(prior1) or (0, 0)
            sizes[j, 1] = _image_size(prior2) or (0, 0)
        gv = GeometricVerificationOptions(
            estimate_twoview_info=self.options.geometric_verification,
            min_num_inlier_matches=self.options.min_num_feature_matches,
            guided_matching=self.options.guided_matching)
        guided_kw = {}
        if self.options.guided_matching:
            # guided matching grows the match set from all features:
            # the chunk's padded keypoints, and its descriptors and
            # masks already on the device
            sel = [i for i, _, _, _ in putative]
            d1, d2, m1, m2 = args
            guided_kw = dict(
                kp1_all=kps[0][sel], kp2_all=kps[1][sel],
                desc1=d1[sel], desc2=d2[sel], fmask1=m1[sel],
                fmask2=m2[sel])
        infos, corrs = verify_matches_batch(
            self._generator, pix1, pix2, pmask, f1s, f2s, pp1s, pp2s,
            sizes, gv, **guided_kw, device=self.device)
        return [(a, b, infos[j], corrs[j])
                for j, (_, a, b, _) in enumerate(putative)
                if infos[j] is not None]


def _image_size(prior):
    if prior is None or not (prior.image_width or prior.image_height):
        return None
    return (prior.image_width, prior.image_height)


def _focal_pp(prior):
    """Focal length and principal point from a view's prior, with the
    JAX module's fallbacks (1.2 x the larger side, the image centre,
    1000 px without a prior)."""
    if prior is None:
        return 1000.0, (0.0, 0.0)
    if prior.focal_length:
        f = prior.focal_length
    elif prior.image_width:
        f = 1.2 * max(prior.image_width, prior.image_height)
    else:
        f = 1000.0
    if prior.principal_point:
        pp = prior.principal_point
    else:
        pp = (prior.image_width / 2.0, prior.image_height / 2.0)
    return f, pp
