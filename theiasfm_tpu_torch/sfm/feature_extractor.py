"""Standalone batch feature extraction (port of
theiasfm_tpu/sfm/feature_extractor.py).

ref: src/theia/sfm/feature_extractor.{h,cc}:51-88 (Extract /
ExtractToDisk used by the extract_features app). Batches same-shape
images through the batched SIFT on `device` (the card unless the caller
passes "cpu") and optionally persists to a features DB. Images are
decoded with PIL (image.load_gray).
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, List

import numpy as np

from ..image import SiftOptions, extract_sift_batch, load_gray
from ..matching.database import (FeaturesAndMatchesDatabase,
                                 KeypointsAndDescriptors)
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class FeatureExtractorOptions:
    """ref: feature_extractor.h Options."""
    sift: SiftOptions = SiftOptions()
    max_image_dimension: int = 3200  # downsample larger images
    # same-shape images batch into ONE device call, capped by a
    # pixel budget (pyramid memory ~ 6 levels * pixels * 4B per image)
    batch_pixel_budget: int = 32 * 1024 * 1024


class FeatureExtractor:
    def __init__(self, options: FeatureExtractorOptions =
                 FeatureExtractorOptions(), device="cuda"):
        self.options = options
        self.device = resolve_device(device)

    def _load(self, path: str):
        gray = load_gray(path)
        scale = 1.0
        m = max(gray.shape)
        if m > self.options.max_image_dimension:
            step = int(np.ceil(m / self.options.max_image_dimension))
            gray = gray[::step, ::step]
            scale = float(step)
        return gray, scale

    def extract(self, image_paths: List[str]
                ) -> Dict[str, KeypointsAndDescriptors]:
        loaded = []
        for path in image_paths:
            name = os.path.basename(path)
            gray, scale = self._load(path)
            loaded.append((name, gray, scale))

        # group same-shape images, batch each group through one
        # device call (chunked by the pixel budget)
        groups: Dict[tuple, list] = {}
        for i, (name, gray, scale) in enumerate(loaded):
            groups.setdefault(gray.shape, []).append(i)

        out = {}
        for shape, idxs in groups.items():
            per = max(1, self.options.batch_pixel_budget //
                      max(shape[0] * shape[1], 1))
            for s in range(0, len(idxs), per):
                chunk = idxs[s:s + per]
                results = extract_sift_batch(
                    [loaded[i][1] for i in chunk], self.options.sift,
                    device=self.device)
                for i, (kps, desc, valid) in zip(chunk, results):
                    name, _, scale = loaded[i]
                    kps, desc = kps[valid].copy(), desc[valid]
                    kps[:, :3] *= scale
                    out[name] = KeypointsAndDescriptors(name, kps, desc)
                    logger.info("%s: %d features", name, len(kps))
        return out

    def extract_to_db(self, image_paths: List[str],
                      db: FeaturesAndMatchesDatabase) -> int:
        n = 0
        for path in image_paths:
            name = os.path.basename(path)
            if db.contains_features(name):
                continue
            feats = self.extract([path])[name]
            db.put_features(name, feats)
            n += 1
        return n
