"""Top-level reconstruction driver: images -> features -> matches ->
tracks -> reconstruction(s) (port of
theiasfm_tpu/sfm/reconstruction_builder.py).

ref: src/theia/sfm/reconstruction_builder.{h,cc} (AddImage,
ExtractAndMatchFeatures, BuildReconstruction with the multi-model loop,
reconstruction_builder.cc:350-415) and
src/theia/sfm/feature_extractor_and_matcher.cc (per-image EXIF/default
focal priors, SIFT extraction, pair selection, matching).

Everything runs on the builder's `device` (the card unless the caller
passes "cpu"): SIFT, the Fisher-vector pair selection, the feature
matcher with its verification, and the reconstruction estimator, in
`dtype` (float32 by default). Images already in the database are not
read again, so a caller can hand the builder extracted features
(convert.features_db_from_arrays) without PIL. The estimator is
GLOBAL by default (as in the JAX module), INCREMENTAL or HYBRID.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..image import SiftOptions, extract_sift_batch, load_gray
from ..matching import (FeatureMatcher, FeatureMatcherOptions,
                        FeaturesAndMatchesDatabase,
                        InMemoryFeaturesAndMatchesDatabase,
                        KeypointsAndDescriptors)
from .reconstruction import CameraIntrinsicsPrior, Reconstruction
from .track_builder import TrackBuilder
from .view_graph import ViewGraph
from ..utils.device import resolve_device
from .pipeline import (GlobalOptions, HybridOptions, IncrementalOptions,
                       global_reconstruction, hybrid_reconstruction,
                       incremental_reconstruction)

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ReconstructionBuilderOptions:
    """ref: reconstruction_builder.h:59-128."""
    reconstruction_estimator_type: str = "GLOBAL"  # GLOBAL|INCREMENTAL|HYBRID
    # ref: select_image_pairs_with_global_image_descriptor_matching
    select_image_pairs_with_global_descriptors: bool = False
    num_nearest_neighbors_for_global_descriptor_matching: int = 20
    # ref: num_gmm_clusters_for_fisher_vector,
    #      max_num_features_for_fisher_vector_training
    num_gmm_clusters_for_fisher_vector: int = 16
    max_num_features_for_fisher_vector_training: int = 100_000
    min_track_length: int = 2
    max_track_length: int = 50
    min_num_inlier_matches: int = 30
    sift: SiftOptions = SiftOptions()
    matching: FeatureMatcherOptions = FeatureMatcherOptions()
    global_options: GlobalOptions = GlobalOptions()
    incremental_options: IncrementalOptions = IncrementalOptions()


class ReconstructionBuilder:
    """ref: ReconstructionBuilder (reconstruction_builder.h:132-218)."""

    def __init__(self, options: ReconstructionBuilderOptions,
                 db: Optional[FeaturesAndMatchesDatabase] = None,
                 dtype=torch.float32, device="cuda"):
        self.options = options
        self.device = resolve_device(device)
        self.dtype = dtype
        self.db = db or InMemoryFeaturesAndMatchesDatabase()
        self._image_paths: Dict[str, str] = {}
        self._priors: Dict[str, CameraIntrinsicsPrior] = {}
        self._groups: Dict[str, int] = {}
        self._matcher = FeatureMatcher(options.matching, self.db,
                                       device=self.device)

    # -- images ---------------------------------------------------------
    def add_image(self, path: str,
                  prior: Optional[CameraIntrinsicsPrior] = None,
                  group: Optional[int] = None):
        """ref: ReconstructionBuilder::AddImage[WithCameraIntrinsicsPrior];
        `group` = shared-intrinsics group id (ref
        AddImageWithCameraIntrinsicsGroup) — views in the same group
        share one intrinsics block in bundle adjustment."""
        name = os.path.basename(path)
        self._image_paths[name] = path
        if prior is not None:
            self._priors[name] = prior
            self.db.put_intrinsics_prior(name, prior)
        if group is not None:
            self._groups[name] = group
        self._matcher.add_image(name)

    def add_two_view_match(self, name1: str, name2: str, match):
        """Inject precomputed matches (ref AddTwoViewMatch)."""
        self.db.put_match(name1, name2, match)

    # -- front end ------------------------------------------------------
    def extract_and_match_features(self) -> int:
        """SIFT over same-shape image batches + matching. Resumable
        through the DB (ref feature_extractor_and_matcher.cc:294-296
        ContainsFeatures skip)."""
        pending = []  # (name, gray)
        for name, path in sorted(self._image_paths.items()):
            if self.db.contains_features(name):
                continue
            gray = load_gray(path)
            prior = self._priors.get(name)
            if prior is None or not prior.image_width:
                prior = prior or CameraIntrinsicsPrior()
                prior.image_width = gray.shape[1]
                prior.image_height = gray.shape[0]
                self._priors[name] = prior
                self.db.put_intrinsics_prior(name, prior)
            pending.append((name, gray))

        # batch same-shape images into single device calls
        groups: Dict[tuple, list] = {}
        for i, (name, gray) in enumerate(pending):
            groups.setdefault(gray.shape, []).append(i)
        budget = 32 * 1024 * 1024  # pixels per batch
        for shape, idxs in groups.items():
            per = max(1, budget // max(shape[0] * shape[1], 1))
            for s in range(0, len(idxs), per):
                chunk = idxs[s:s + per]
                results = extract_sift_batch(
                    [pending[i][1] for i in chunk], self.options.sift,
                    device=self.device)
                for i, (kps, desc, valid) in zip(chunk, results):
                    name = pending[i][0]
                    kps, desc = kps[valid], desc[valid]
                    logger.info("extracted %d features from %s",
                                len(kps), name)
                    self.db.put_features(name, KeypointsAndDescriptors(
                        name, kps, desc))

        # optional O(n*k) pair pruning via Fisher-vector kNN
        # (ref feature_extractor_and_matcher.cc:352-413)
        if self.options.select_image_pairs_with_global_descriptors:
            from ..matching.fisher_vector import (
                FisherVectorExtractor, FisherVectorOptions,
                select_image_pairs_from_global_descriptors)
            names = self.db.image_names_of_features()
            fv = FisherVectorExtractor(FisherVectorOptions(
                num_gmm_clusters=self.options
                .num_gmm_clusters_for_fisher_vector,
                max_num_features_for_training=self.options
                .max_num_features_for_fisher_vector_training),
                device=self.device)
            all_desc = np.concatenate(
                [self.db.get_features(n).descriptors for n in names])
            fv.train(all_desc)
            gdesc = {n: fv.extract_global_descriptor(
                self.db.get_features(n).descriptors) for n in names}
            pairs = select_image_pairs_from_global_descriptors(
                gdesc, self.options
                .num_nearest_neighbors_for_global_descriptor_matching)
            self._matcher.set_image_pairs_to_match(pairs)
        return self._matcher.match_images()

    # -- back end -------------------------------------------------------
    def build_reconstruction(self) -> List[Reconstruction]:
        """Build one or more models (ref BuildReconstruction multi-model
        loop, reconstruction_builder.cc:350-415)."""
        # assemble reconstruction + view graph from the match DB
        recon = Reconstruction()
        graph = ViewGraph()
        names = sorted(set(self._image_paths.keys()) |
                       set(self.db.image_names_of_features()))
        name_to_vid = {}
        # user-specified shared-intrinsics groups map to low group ids
        user_groups = {g: i for i, g in
                       enumerate(sorted(set(self._groups.values())))}
        recon._next_group_id = len(user_groups)
        for name in names:
            g = self._groups.get(name)
            vid = recon.add_view(
                name, group=None if g is None else user_groups[g])
            name_to_vid[name] = vid
            view = recon.view(vid)
            prior = (self._priors.get(name) or
                     self.db.get_intrinsics_prior(name) or
                     CameraIntrinsicsPrior())
            view.prior = prior
            view.camera.set_from_prior(prior)

        tb = TrackBuilder(self.options.min_track_length,
                          self.options.max_track_length)
        for (n1, n2) in self.db.image_pairs_of_matches():
            m = self.db.get_match(n1, n2)
            if m is None or m.twoview_info.num_verified_matches < \
                    self.options.min_num_inlier_matches:
                continue
            v1, v2 = name_to_vid.get(n1), name_to_vid.get(n2)
            if v1 is None or v2 is None:
                continue
            graph.add_edge(v1, v2, m.twoview_info)
            for row in m.correspondences:
                tb.add_feature_correspondence(v1, row[:2], v2, row[2:])
        tb.build_tracks(recon)
        logger.info("view graph: %d views, %d edges; %d tracks",
                    graph.num_views(), graph.num_edges(),
                    recon.num_tracks())

        models: List[Reconstruction] = []
        while graph.num_views() >= 3:
            if self.options.reconstruction_estimator_type == "GLOBAL":
                summary = global_reconstruction(
                    recon, graph, self.options.global_options,
                    dtype=self.dtype, device=self.device)
            elif self.options.reconstruction_estimator_type == \
                    "INCREMENTAL":
                summary = incremental_reconstruction(
                    recon, graph, self.options.incremental_options,
                    dtype=self.dtype, device=self.device)
            else:
                summary = hybrid_reconstruction(
                    recon, graph, HybridOptions(), dtype=self.dtype,
                    device=self.device)
            if not summary.get("success") or \
                    summary.get("num_estimated_views", 0) < 3:
                break
            # split off the estimated sub-model, continue on the rest
            est = set(recon.estimated_views())
            models.append(_extract_submodel(recon, est))
            for v in est:
                graph.remove_view(v)
                recon.remove_view(v)
            for v in recon.views.values():
                v.is_estimated = False
            for t in recon.tracks.values():
                t.is_estimated = False
        return models


def _extract_submodel(recon: Reconstruction, view_ids) -> Reconstruction:
    """Copy the estimated subset into a standalone reconstruction
    (ref Reconstruction::GetSubReconstruction)."""
    import copy
    sub = Reconstruction()
    vid_map = {}
    for v in sorted(view_ids):
        view = recon.views[v]
        nv = sub.add_view(view.name, group=recon.view_groups[v])
        vid_map[v] = nv
        sview = sub.view(nv)
        sview.camera = copy.deepcopy(view.camera)
        sview.prior = copy.deepcopy(view.prior)
        sview.is_estimated = view.is_estimated
    for t, track in recon.tracks.items():
        obs = [(v, recon.views[v].features[t]) for v in track.views
               if v in view_ids]
        if len(obs) < 2:
            continue
        nt = sub.add_track()
        st = sub.track(nt)
        st.point = track.point.copy()
        st.color = track.color.copy()
        st.is_estimated = track.is_estimated
        for v, feat in obs:
            sub.add_observation(vid_map[v], nt, feat)
    return sub
