"""The port's ReconstructionBuilder against the JAX package's, on the
CPU.

- From injected matches (add_two_view_match) of the synthetic scene
  (tests/torch_sfm_cases.py): both builders assemble the same views,
  cameras, tracks and view graph before their estimator runs; the
  port's INCREMENTAL build then returns one model of all 8 views whose
  positions, aligned to the truth (JAX's sfm/transformation), are within
  1% of the scene's scale; GLOBAL (the default) and HYBRID raise
  NotImplementedError naming slice C.
- From image files (PIL): extract_and_match_features runs the batched
  SIFT on the CPU, stores what extract_sift_batch returns, skips images
  the database holds, and with Fisher-vector pair selection matches the
  pairs select_image_pairs_from_global_descriptors picks;
  FeatureExtractor stores the same features. Keypoints and descriptors
  are compared to 1e-3: the CPU's convolutions may round differently
  from one call to the next (some 6e-5 px measured on these views)."""
import dataclasses

import numpy as np
import pytest
import torch

from theiasfm_tpu.matching import database as jdb
from theiasfm_tpu.sfm import reconstruction as jreco
from theiasfm_tpu.sfm import reconstruction_builder as jrb
from theiasfm_tpu.sfm.transformation import align_point_clouds
from theiasfm_tpu.sfm.view_graph import TwoViewInfo as JTwoViewInfo
from theiasfm_tpu_torch import convert
from theiasfm_tpu_torch.image import (SiftOptions, extract_sift_batch,
                                      render_synthetic_views)
from theiasfm_tpu_torch.matching import (FeatureMatcherOptions,
                                         ImagePairMatch,
                                         InMemoryFeaturesAndMatchesDatabase)
from theiasfm_tpu_torch.sfm import feature_extractor as tfe
from theiasfm_tpu_torch.sfm import reconstruction_builder as trb
from theiasfm_tpu_torch.sfm.view_graph import TwoViewInfo

import torch_sfm_cases as cases
from torch_sfm_cases import one_torch_thread  # noqa: F401

PRIOR = dict(image_width=cases.SIZE[0], image_height=cases.SIZE[1],
             focal_length=cases.FOCAL, principal_point=cases.PP)


def _names(sc):
    return [f"img{v}.jpg" for v in range(sc.n_views)]


def _features(sc):
    """Per view: its observations as keypoints, random descriptors."""
    rng = np.random.default_rng(0)
    out = {}
    for v, name in enumerate(_names(sc)):
        pix = np.array([sc.obs[(v, p)] for p in range(len(sc.points))
                        if (v, p) in sc.obs])
        kps = np.concatenate([pix, np.ones((len(pix), 2))], axis=1)
        out[name] = (kps, rng.random((len(pix), 128)).astype(np.float32))
    return out


def _jax_builder(sc, opts):
    db = jdb.InMemoryFeaturesAndMatchesDatabase()
    for name, (k, d) in _features(sc).items():
        db.put_features(name, jdb.KeypointsAndDescriptors(name, k, d))
        db.put_intrinsics_prior(name, jreco.CameraIntrinsicsPrior(**PRIOR))
    b = jrb.ReconstructionBuilder(opts, db)
    names = _names(sc)
    for (v1, v2), info in cases.graph_edges(sc).items():
        b.add_two_view_match(names[v1], names[v2], jdb.ImagePairMatch(
            names[v1], names[v2], JTwoViewInfo(**info),
            cases.correspondences(sc, v1, v2)))
    return b


def _port_builder(sc, opts, **kw):
    db = convert.features_db_from_arrays(
        _features(sc), {n: PRIOR for n in _names(sc)})
    b = trb.ReconstructionBuilder(opts, db, device="cpu", **kw)
    names = _names(sc)
    for (v1, v2), info in cases.graph_edges(sc).items():
        b.add_two_view_match(names[v1], names[v2], ImagePairMatch(
            names[v1], names[v2], TwoViewInfo(**info),
            cases.correspondences(sc, v1, v2)))
    return b


def _capture(monkeypatch, module):
    """Replace the module's incremental estimator by one that records
    what the builder assembled and reports failure."""
    seen = {}

    def estimator(recon, graph, opts, **kw):
        seen.update(recon=recon, graph=graph)
        return {"success": False}
    monkeypatch.setattr(module, "incremental_reconstruction", estimator)
    return seen


def test_builder_assembles_like_jax(monkeypatch):
    sc = cases.scene(np.random.default_rng(42))
    jseen = _capture(monkeypatch, jrb)
    tseen = _capture(monkeypatch, trb)
    assert _jax_builder(sc, jrb.ReconstructionBuilderOptions(
        reconstruction_estimator_type="INCREMENTAL")
    ).build_reconstruction() == []
    assert _port_builder(sc, trb.ReconstructionBuilderOptions(
        reconstruction_estimator_type="INCREMENTAL")
    ).build_reconstruction() == []
    jr, tr = jseen["recon"], tseen["recon"]
    assert sorted(tr.views) == sorted(jr.views)
    for v, jv in jr.views.items():
        tv = tr.views[v]
        assert tv.name == jv.name
        assert tr.view_groups[v] == jr.view_groups[v]
        np.testing.assert_array_equal(tv.camera.intrinsics,
                                      jv.camera.intrinsics)
        assert (tv.camera.image_width, tv.camera.image_height) == \
            (jv.camera.image_width, jv.camera.image_height)
    assert {t: sorted((v, tuple(jr.views[v].features[t])) for v in x.views)
            for t, x in jr.tracks.items()} == \
        {t: sorted((v, tuple(tr.views[v].features[t])) for v in x.views)
         for t, x in tr.tracks.items()}
    jg, tg = jseen["graph"], tseen["graph"]
    assert sorted(tg.edges()) == sorted(jg.edges())
    for k, info in jg.edges().items():
        assert dataclasses.asdict(tg.edge(*k)).keys() == \
            dataclasses.asdict(info).keys()
        np.testing.assert_array_equal(tg.edge(*k).rotation_2,
                                      info.rotation_2)


def test_builder_reconstructs_incremental():
    sc = cases.scene(np.random.default_rng(42))
    models = _port_builder(sc, trb.ReconstructionBuilderOptions(
        reconstruction_estimator_type="INCREMENTAL"),
        dtype=torch.float64).build_reconstruction()
    assert len(models) == 1
    m = models[0]
    assert len(m.estimated_views()) == 8
    assert len(m.estimated_tracks()) > 100
    views = sorted(m.estimated_views())
    est = np.stack([m.views[v].camera.position for v in views])
    gt = np.stack([sc.extrinsics[int(m.views[v].name[3:-4]), :3]
                   for v in views])
    s, R, t = align_point_clouds(est, gt)
    err = np.linalg.norm(s * est @ R.T + t - gt, axis=1)
    assert np.median(err) < 0.08


@pytest.mark.parametrize("kind", ["GLOBAL", "HYBRID"])
def test_unported_estimators_raise(kind):
    sc = cases.scene(np.random.default_rng(42), n_views=4, n_pts=40)
    b = _port_builder(sc, trb.ReconstructionBuilderOptions(
        reconstruction_estimator_type=kind))
    with pytest.raises(NotImplementedError, match="slice C"):
        b.build_reconstruction()
    assert trb.ReconstructionBuilderOptions().reconstruction_estimator_type \
        == "GLOBAL"


def _write_views(tmp_path, n=3):
    from PIL import Image
    rng = np.random.default_rng(0)
    views, _ = render_synthetic_views(rng.random((128, 128)), n, (96, 80),
                                      focal=90.0)
    paths = []
    for i, im in enumerate(views):
        p = tmp_path / f"v{i}.png"
        Image.fromarray((im * 255).astype(np.uint8)).save(p)
        paths.append(str(p))
    return paths


SIFT = SiftOptions(num_octaves=2, max_features_per_octave=128)


def test_builder_extracts_from_images_on_cpu(tmp_path, monkeypatch):
    from theiasfm_tpu_torch.image import load_gray
    paths = _write_views(tmp_path)
    opts = trb.ReconstructionBuilderOptions(
        reconstruction_estimator_type="INCREMENTAL", sift=SIFT,
        matching=FeatureMatcherOptions(perform_geometric_verification=False,
                                       min_num_feature_matches=1),
        select_image_pairs_with_global_descriptors=True,
        num_nearest_neighbors_for_global_descriptor_matching=1,
        num_gmm_clusters_for_fisher_vector=2)
    db = InMemoryFeaturesAndMatchesDatabase()
    b = trb.ReconstructionBuilder(opts, db, device="cpu")
    for p in paths:
        b.add_image(p)
    chosen = []
    real = b._matcher.set_image_pairs_to_match
    monkeypatch.setattr(b._matcher, "set_image_pairs_to_match",
                        lambda pairs: chosen.append(pairs) or real(pairs))
    assert b.extract_and_match_features() == len(chosen[0]) > 0
    grays = [load_gray(p) for p in paths]
    ref = extract_sift_batch(grays, SIFT, device="cpu")
    for p, (k, d, v) in zip(paths, ref):
        f = db.get_features(p.split("/")[-1])
        np.testing.assert_allclose(f.keypoints, k[v], rtol=0, atol=1e-3)
        np.testing.assert_allclose(f.descriptors, d[v], rtol=0, atol=1e-3)
        prior = db.get_intrinsics_prior(p.split("/")[-1])
        assert (prior.image_width, prior.image_height) == (96, 80)
    assert set(chosen[0]) <= {("v0.png", "v1.png"), ("v0.png", "v2.png"),
                              ("v1.png", "v2.png")}
    # features the database holds are not extracted again
    monkeypatch.setattr(trb, "extract_sift_batch", None)
    again = trb.ReconstructionBuilder(opts, db, device="cpu")
    for p in paths:
        again.add_image(p)
    assert again.extract_and_match_features() == 0
    # the standalone extractor stores the same features
    fx = tfe.FeatureExtractor(tfe.FeatureExtractorOptions(sift=SIFT),
                              device="cpu")
    db2 = InMemoryFeaturesAndMatchesDatabase()
    assert fx.extract_to_db(paths, db2) == 3
    for name in db2.image_names_of_features():
        np.testing.assert_allclose(db2.get_features(name).keypoints,
                                   db.get_features(name).keypoints,
                                   rtol=0, atol=1e-3)


def _option_pairs():
    from theiasfm_tpu.matching import fisher_vector as jfv
    from theiasfm_tpu.sfm import feature_extractor as jfe
    from theiasfm_tpu.sfm.global_pose import position_estimation as jpe
    from theiasfm_tpu.sfm.global_pose import rotation_averaging as jra
    from theiasfm_tpu.sfm.pipeline import (estimate_tracks, global_pipeline,
                                           hybrid, incremental, localize)
    from theiasfm_tpu_torch.matching import fisher_vector as tfv
    from theiasfm_tpu_torch.sfm import global_pose as tgp
    from theiasfm_tpu_torch.sfm import pipeline as tp
    return [(jrb.ReconstructionBuilderOptions,
             trb.ReconstructionBuilderOptions),
            (incremental.IncrementalOptions, tp.IncrementalOptions),
            (localize.LocalizeOptions, tp.LocalizeOptions),
            (estimate_tracks.EstimateTracksOptions,
             tp.EstimateTracksOptions),
            (global_pipeline.GlobalOptions, tp.GlobalOptions),
            (hybrid.HybridOptions, tp.HybridOptions),
            (jra.RobustRotationOptions, tgp.RobustRotationOptions),
            (jpe.PositionEstimatorOptions, tgp.PositionEstimatorOptions),
            (jfv.FisherVectorOptions, tfv.FisherVectorOptions),
            (jfe.FeatureExtractorOptions, tfe.FeatureExtractorOptions)]


@pytest.mark.parametrize("pair", range(10))
def test_options_match_jax(pair):
    """The port's option dataclasses have JAX's fields and defaults
    (nested options compared field by field)."""
    def flat(o):
        return {f.name: (flat(getattr(o, f.name))
                         if dataclasses.is_dataclass(getattr(o, f.name))
                         else getattr(o, f.name))
                for f in dataclasses.fields(o)}
    j, t = _option_pairs()[pair]
    assert flat(t()) == flat(j())
