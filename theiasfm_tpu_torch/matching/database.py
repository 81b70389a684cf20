"""Features-and-matches stores (copy of theiasfm_tpu/matching/database.py
on the port's CameraIntrinsicsPrior and TwoViewInfo; data stays as
numpy on the host).

ref: src/theia/matching/features_and_matches_database.h:51-99 (the
abstract KV contract: intrinsics priors, keypoints+descriptors per
image name, ImagePairMatch per pair),
in_memory_features_and_matches_database.h (dict impl) and
rocksdb_features_and_matches_database.h (out-of-core + resume). The
disk impl here is a directory of npz blobs — same out-of-core/resume
role without a DB dependency (files double as the checkpoint,
SURVEY.md §5 'checkpoint/resume').
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..sfm.reconstruction import CameraIntrinsicsPrior
from ..sfm.view_graph import TwoViewInfo


@dataclasses.dataclass
class KeypointsAndDescriptors:
    """ref: matching/keypoints_and_descriptors.h."""
    image_name: str = ""
    keypoints: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 4)))  # x, y, scale, orient
    descriptors: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 128), np.float32))


@dataclasses.dataclass
class ImagePairMatch:
    """ref: matching/image_pair_match.h — TwoViewInfo + inlier
    correspondences (pixel coords in each image)."""
    image1: str = ""
    image2: str = ""
    twoview_info: TwoViewInfo = dataclasses.field(default_factory=TwoViewInfo)
    correspondences: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 4)))  # x1 y1 x2 y2


class FeaturesAndMatchesDatabase:
    """Abstract interface (ref features_and_matches_database.h)."""

    def contains_features(self, name: str) -> bool:
        raise NotImplementedError

    def get_features(self, name: str) -> Optional[KeypointsAndDescriptors]:
        raise NotImplementedError

    def put_features(self, name: str, f: KeypointsAndDescriptors):
        raise NotImplementedError

    def image_names_of_features(self) -> List[str]:
        raise NotImplementedError

    def get_intrinsics_prior(self, name: str):
        raise NotImplementedError

    def put_intrinsics_prior(self, name: str, p: CameraIntrinsicsPrior):
        raise NotImplementedError

    def get_match(self, name1: str, name2: str) -> Optional[ImagePairMatch]:
        raise NotImplementedError

    def put_match(self, name1: str, name2: str, m: ImagePairMatch):
        raise NotImplementedError

    def image_pairs_of_matches(self) -> List[Tuple[str, str]]:
        raise NotImplementedError

    def num_matches(self) -> int:
        return len(self.image_pairs_of_matches())


class InMemoryFeaturesAndMatchesDatabase(FeaturesAndMatchesDatabase):
    """ref: in_memory_features_and_matches_database.h:55."""

    def __init__(self):
        self._features: Dict[str, KeypointsAndDescriptors] = {}
        self._priors: Dict[str, CameraIntrinsicsPrior] = {}
        self._matches: Dict[Tuple[str, str], ImagePairMatch] = {}

    def contains_features(self, name):
        return name in self._features

    def get_features(self, name):
        return self._features.get(name)

    def put_features(self, name, f):
        self._features[name] = f

    def image_names_of_features(self):
        return sorted(self._features.keys())

    def get_intrinsics_prior(self, name):
        return self._priors.get(name)

    def put_intrinsics_prior(self, name, p):
        self._priors[name] = p

    def get_match(self, name1, name2):
        return self._matches.get((name1, name2))

    def put_match(self, name1, name2, m):
        self._matches[(name1, name2)] = m

    def image_pairs_of_matches(self):
        return sorted(self._matches.keys())


class DiskFeaturesAndMatchesDatabase(FeaturesAndMatchesDatabase):
    """Directory-backed store; every put is durable, so interrupted
    extraction/matching resumes for free (the role RocksDB plays in the
    reference, rocksdb_features_and_matches_database.h:62-90)."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(os.path.join(directory, "features"), exist_ok=True)
        os.makedirs(os.path.join(directory, "matches"), exist_ok=True)
        os.makedirs(os.path.join(directory, "priors"), exist_ok=True)

    @staticmethod
    def _safe(name: str) -> str:
        return name.replace("/", "_")

    def _fpath(self, name):
        return os.path.join(self.dir, "features", self._safe(name) + ".npz")

    def _mpath(self, n1, n2):
        return os.path.join(self.dir, "matches",
                            self._safe(n1) + "__" + self._safe(n2) + ".npz")

    def contains_features(self, name):
        return os.path.exists(self._fpath(name))

    def get_features(self, name):
        p = self._fpath(name)
        if not os.path.exists(p):
            return None
        z = np.load(p)
        return KeypointsAndDescriptors(
            image_name=name, keypoints=z["keypoints"],
            descriptors=z["descriptors"])

    def put_features(self, name, f):
        np.savez_compressed(self._fpath(name), keypoints=f.keypoints,
                            descriptors=f.descriptors)

    def image_names_of_features(self):
        out = []
        d = os.path.join(self.dir, "features")
        for fn in sorted(os.listdir(d)):
            if fn.endswith(".npz"):
                out.append(fn[:-4])
        return out

    def get_intrinsics_prior(self, name):
        p = os.path.join(self.dir, "priors", self._safe(name) + ".json")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            d = json.load(f)
        prior = CameraIntrinsicsPrior()
        for k, v in d.items():
            setattr(prior, k, tuple(v) if isinstance(v, list) else v)
        return prior

    def put_intrinsics_prior(self, name, prior):
        p = os.path.join(self.dir, "priors", self._safe(name) + ".json")
        d = {}
        for field in dataclasses.fields(prior):
            v = getattr(prior, field.name)
            if v is None:
                continue
            if isinstance(v, np.ndarray):
                v = v.tolist()
            elif isinstance(v, tuple):
                v = list(v)
            elif hasattr(v, "value"):
                v = int(v)
            d[field.name] = v
        with open(p, "w") as f:
            json.dump(d, f)

    def get_match(self, n1, n2):
        p = self._mpath(n1, n2)
        if not os.path.exists(p):
            return None
        z = np.load(p, allow_pickle=False)
        info = TwoViewInfo(
            focal_length_1=float(z["focal1"]),
            focal_length_2=float(z["focal2"]),
            position_2=z["position_2"], rotation_2=z["rotation_2"],
            num_verified_matches=int(z["num_verified"]),
            num_homography_inliers=int(z["num_h"]),
            visibility_score=int(z["vis"]))
        return ImagePairMatch(image1=n1, image2=n2, twoview_info=info,
                              correspondences=z["correspondences"])

    def put_match(self, n1, n2, m):
        info = m.twoview_info
        np.savez_compressed(
            self._mpath(n1, n2), focal1=info.focal_length_1,
            focal2=info.focal_length_2, position_2=info.position_2,
            rotation_2=info.rotation_2,
            num_verified=info.num_verified_matches,
            num_h=info.num_homography_inliers,
            vis=info.visibility_score,
            correspondences=m.correspondences)

    def image_pairs_of_matches(self):
        out = []
        d = os.path.join(self.dir, "matches")
        for fn in sorted(os.listdir(d)):
            if fn.endswith(".npz"):
                a, b = fn[:-4].split("__")
                out.append((a, b))
        return out
