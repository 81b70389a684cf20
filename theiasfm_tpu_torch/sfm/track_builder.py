"""Track building: union-find over (view, feature) correspondences (port
of theiasfm_tpu/sfm/track_builder.py).

ref: src/theia/sfm/track_builder.{h,cc} — connected components over
feature matches, enforcing min/max track length and dropping tracks
that observe the same view twice (inconsistent).

The JAX module labels the components with the native connected-
components routine when `native/libhost_ops.so` is built and with
`math/graph.UnionFind` otherwise; this port takes the UnionFind path
only. Both assign the same track ids: the groups are walked in order of
their first member (feature ids in insertion order) whichever labels
them.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..math.graph import UnionFind
from .reconstruction import Reconstruction


class TrackBuilder:
    def __init__(self, min_track_length: int = 2,
                 max_track_length: int = 10 ** 9):
        self.min_track_length = min_track_length
        self.max_track_length = max_track_length
        self._feature_index: Dict[Tuple[int, Tuple[float, float]], int] = {}
        self._features: List[Tuple[int, np.ndarray]] = []
        self._pairs: List[Tuple[int, int]] = []

    def _feature_id(self, view_id: int, feature) -> int:
        key = (view_id, (float(feature[0]), float(feature[1])))
        fid = self._feature_index.get(key)
        if fid is None:
            fid = len(self._features)
            self._feature_index[key] = fid
            self._features.append((view_id, np.asarray(feature, float)))
        return fid

    def add_feature_correspondence(self, view1: int, feature1,
                                   view2: int, feature2):
        """ref: TrackBuilder::AddFeatureCorrespondence."""
        f1 = self._feature_id(view1, feature1)
        f2 = self._feature_id(view2, feature2)
        self._pairs.append((f1, f2))

    def build_tracks(self, reconstruction: Reconstruction) -> int:
        """Union-find over features -> tracks added to `reconstruction`.
        Returns number of tracks created (consistent, length-filtered).
        ref: TrackBuilder::BuildTracks (track_builder.cc:57+)."""
        n = len(self._features)
        uf = UnionFind(n)
        for a, b in self._pairs:
            uf.union(a, b)
        groups: Dict[int, List[int]] = {}
        for i in range(n):
            groups.setdefault(uf.find(i), []).append(i)

        created = 0
        for members in groups.values():
            if len(members) < self.min_track_length:
                continue
            views = [self._features[m][0] for m in members]
            if len(set(views)) != len(views):
                continue
            members = members[: self.max_track_length]
            tid = reconstruction.add_track()
            for m in members:
                vid, feat = self._features[m]
                reconstruction.add_observation(vid, tid, feat)
            created += 1
        return created
