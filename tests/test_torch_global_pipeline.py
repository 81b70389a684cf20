"""The port's global pipeline (theiasfm_tpu_torch/sfm/pipeline/
{global_pipeline,select_good_tracks}.py) and its 1DSfM-class scene
(bench_problem.build_city_scene) against the JAX package's, on the CPU
in float64 (the suite's x64).

- build_city_scene at 40 views and 800 points: the same tracks,
  observations (pixels to 1e-9) and view-graph edges as
  tests/test_large_scale.py's generator for the same seed.
- select_good_tracks_for_bundle_adjustment on the synthetic scene of
  tests/torch_sfm_cases.py at its true state: the same track set.
- The step-5 translation refinement: the same directions to 1e-9.
- The whole global_reconstruction on that 8-view scene with
  GlobalOptions() (JAX's pipeline run once, module-scoped): the same
  estimated views and tracks, camera positions within 1e-6 of the
  scene's scale (the 8-unit camera distance), the same summary keys; and
  after a similarity alignment to the truth (JAX's sfm/transformation)
  the median position error under 1% of that scale in both."""
import dataclasses

import numpy as np
import pytest
import torch

from theiasfm_tpu.sfm.pipeline import global_pipeline as jgp
from theiasfm_tpu.sfm.pipeline import select_good_tracks as jsg
from theiasfm_tpu.sfm.transformation import align_point_clouds
from theiasfm_tpu_torch.bench_problem import build_city_scene
from theiasfm_tpu_torch.sfm.pipeline import global_pipeline as tgp
from theiasfm_tpu_torch.sfm.pipeline import select_good_tracks as tsg

import torch_sfm_cases as cases
from test_large_scale import build_city_scene as jax_city_scene
from torch_sfm_cases import one_torch_thread  # noqa: F401

CPU = dict(dtype=torch.float64, device="cpu")


def _observations(rec):
    return {t: sorted((v, tuple(rec.views[v].features[t])) for v in x.views)
            for t, x in rec.tracks.items()}


def test_city_scene_matches_jax():
    trec, tg, textr = build_city_scene(np.random.default_rng(7), 40, 800)
    jrec, jg, jextr = jax_city_scene(np.random.default_rng(7), 40, 800)
    np.testing.assert_allclose(textr, jextr, rtol=0, atol=1e-12)
    assert sorted(trec.views) == sorted(jrec.views)
    for v in jrec.views:
        assert trec.views[v].name == jrec.views[v].name
        np.testing.assert_array_equal(trec.views[v].camera.intrinsics,
                                      jrec.views[v].camera.intrinsics)
        assert list(trec.views[v].features) == list(jrec.views[v].features)
    to, jo = _observations(trec), _observations(jrec)
    assert to.keys() == jo.keys() and len(to) > 100
    for t in jo:
        assert [v for v, _ in to[t]] == [v for v, _ in jo[t]]
        np.testing.assert_allclose([p for _, p in to[t]],
                                   [p for _, p in jo[t]], rtol=0, atol=1e-9)
    assert list(tg.edges()) == list(jg.edges()) and tg.num_edges() >= 5
    for k, info in jg.edges().items():
        ti = tg.edge(*k)
        assert ti.num_verified_matches == info.num_verified_matches
        np.testing.assert_allclose(ti.rotation_2, info.rotation_2, atol=1e-9)
        np.testing.assert_allclose(ti.position_2, info.position_2, atol=1e-9)


def test_select_good_tracks_matches_jax():
    sc = cases.scene(np.random.default_rng(42))
    jrec, trec = cases.reconstructions(sc)
    cases.set_true_state(sc, jrec)
    cases.set_true_state(sc, trec)
    kw = dict(long_track_length_threshold=4, image_grid_cell_size_pixels=200,
              min_num_optimized_tracks_per_view=10)
    got = tsg.select_good_tracks_for_bundle_adjustment(trec, **kw, **CPU)
    want = jsg.select_good_tracks_for_bundle_adjustment(jrec, **kw)
    assert got == want
    assert 0 < len(got) < len(trec.tracks)


def test_refine_relative_translations_matches_jax():
    sc = cases.scene(np.random.default_rng(42))
    jrec, trec = cases.reconstructions(sc)
    _, tg = cases.graphs(cases.graph_edges(sc))
    edges, _, rel_pos, _ = tgp._graph_arrays(tg)
    vid_idx = {v: v for v in range(sc.n_views)}
    orient = sc.extrinsics[:, 3:]
    rng = np.random.default_rng(1)
    start = rel_pos + rng.normal(scale=0.05, size=rel_pos.shape)
    start /= np.linalg.norm(start, axis=1, keepdims=True)
    got = tgp._refine_relative_translations(trec, vid_idx, orient, edges,
                                            start, device="cpu")
    want = jgp._refine_relative_translations(jrec, vid_idx, orient, edges,
                                             start)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert np.abs(got - rel_pos).max() < np.abs(start - rel_pos).max()


@pytest.fixture(scope="module")
def runs():
    """Both packages' global_reconstruction on the 8-view scene, once."""
    sc = cases.scene(np.random.default_rng(42))
    jrec, trec = cases.reconstructions(sc)
    jg, tg = cases.graphs(cases.graph_edges(sc))
    js = jgp.global_reconstruction(jrec, jg, jgp.GlobalOptions())
    ts = tgp.global_reconstruction(trec, tg, tgp.GlobalOptions(), **CPU)
    return sc, (jrec, js), (trec, ts)


def test_global_reconstruction_matches_jax(runs):
    sc, (jrec, js), (trec, ts) = runs
    assert ts["success"] and js["success"]
    assert ts.keys() == js.keys()
    assert ts["timings"].keys() == js["timings"].keys()
    assert ts["num_estimated_views"] == js["num_estimated_views"] == 8
    assert ts["num_estimated_tracks"] == js["num_estimated_tracks"] > 100
    assert sorted(trec.estimated_tracks()) == sorted(jrec.estimated_tracks())
    views = sorted(jrec.estimated_views())
    assert sorted(trec.estimated_views()) == views
    tp = np.stack([trec.views[v].camera.position for v in views])
    jp = np.stack([jrec.views[v].camera.position for v in views])
    scale = np.linalg.norm(jp - jp.mean(0), axis=1).max()
    assert np.abs(tp - jp).max() < 1e-6 * scale
    gt = sc.extrinsics[views, :3]
    for est in (tp, jp):
        s, R, t = align_point_clouds(est, gt)
        err = np.linalg.norm(s * est @ R.T + t - gt, axis=1)
        assert np.median(err) < 0.08


def test_global_options_match_jax():
    assert dataclasses.asdict(tgp.GlobalOptions()) == \
        dataclasses.asdict(jgp.GlobalOptions())
