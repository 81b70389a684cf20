"""The port's localization, track estimation and filters against the JAX
package's on the synthetic scene (tests/torch_sfm_cases.py), in float64
on the CPU, both packages holding the same reconstruction.

- localize_view / localize_views_batch, given the sample indices JAX
  draws from its key: the same views succeed (views with too few 2D-3D
  matches are left out alike), and their poses agree to 1e-8.
- estimate_all_tracks: the same tracks estimated, points to 1e-8.
- set_outlier_tracks_to_unestimated and
  set_underconstrained_as_unestimated: the same counts and the same
  tracks and views left estimated."""
import jax
import numpy as np
import pytest
import torch

from theiasfm_tpu.sfm.pipeline import estimate_tracks as jet
from theiasfm_tpu.sfm.pipeline import filters as jfl
from theiasfm_tpu.sfm.pipeline import localize as jlo
from theiasfm_tpu.solvers.ransac import random_samples as jrs
from theiasfm_tpu_torch.sfm.pipeline import estimate_tracks as tet
from theiasfm_tpu_torch.sfm.pipeline import filters as tfl
from theiasfm_tpu_torch.sfm.pipeline import localize as tlo
from theiasfm_tpu_torch.utils import next_bucket

import torch_sfm_cases as cases
from torch_sfm_cases import one_torch_thread  # noqa: F401

F64 = torch.float64
KW = dict(dtype=F64, device="cpu")


@pytest.fixture(scope="module")
def scene():
    return cases.scene(np.random.default_rng(42))


def _drop_observations(rec, view, keep):
    """Remove all but `keep` of a view's observations."""
    for t in sorted(rec.views[view].features)[keep:]:
        del rec.views[view].features[t]
        rec.tracks[t].views.discard(view)


def _estimated(rec):
    return (sorted(rec.estimated_views()), sorted(rec.estimated_tracks()))


def _localize_state(scene):
    """Views 0-4 at their true poses, every track at its true point,
    views 5-7 to localize; view 6 keeps only 20 observations (too few
    for min_num_inliers = 30)."""
    recs = cases.reconstructions(scene)
    for rec in recs:
        cases.set_true_state(scene, rec, views=range(5))
        _drop_observations(rec, 6, 20)
    return recs


def test_localize_views_batch_matches_jax(scene):
    jrec, trec = _localize_state(scene)
    opts = tlo.LocalizeOptions(num_hypotheses=64)
    key = jax.random.PRNGKey(3)
    views = [5, 6, 7]
    jres = jlo.localize_views_batch(key, jrec, views, jlo.LocalizeOptions(
        num_hypotheses=64))
    batch = tlo.prepare_localize_batch(trec, views, opts)
    assert batch.view_ids == [5, 7]
    idx = cases.jax_localize_samples(key, batch, 64)
    tres = tlo.localize_views_batch(idx, trec, views, opts, **KW)
    assert tres == jres == {5: True, 7: True}
    for v in views:
        assert trec.views[v].is_estimated == jrec.views[v].is_estimated
        np.testing.assert_allclose(trec.views[v].camera.extrinsics,
                                   jrec.views[v].camera.extrinsics,
                                   rtol=0, atol=1e-8)
    for v in (5, 7):
        np.testing.assert_allclose(trec.views[v].camera.extrinsics,
                                   scene.extrinsics[v], atol=2e-2)


def test_localize_view_matches_jax(scene):
    jrec, trec = _localize_state(scene)
    opts = tlo.LocalizeOptions(num_hypotheses=64)
    key = jax.random.PRNGKey(4)
    assert jlo.localize_view(key, jrec, 5, jlo.LocalizeOptions(
        num_hypotheses=64))
    n = sum(1 for t in trec.views[5].features
            if trec.tracks[t].is_estimated)
    b = next_bucket(n, 64)
    idx = torch.from_numpy(np.array(jrs(
        key, b, 3, 64, jax.numpy.arange(b) < n)))
    assert tlo.localize_view(idx, trec, 5, opts, **KW)
    np.testing.assert_allclose(trec.views[5].camera.extrinsics,
                               jrec.views[5].camera.extrinsics, rtol=0,
                               atol=1e-8)
    # too few matches: no RANSAC, no change
    assert not jlo.localize_view(key, jrec, 6, jlo.LocalizeOptions())
    assert not tlo.localize_view(idx, trec, 6, opts, **KW)
    assert not trec.views[6].is_estimated


def test_estimate_all_tracks_matches_jax(scene):
    """All views at their true poses, tracks unestimated; then once more
    on a subset after perturbing view 3 by 0.2 units (the tracks view 3
    still observes, half of them, then fail the reprojection gate)."""
    recs = cases.reconstructions(scene)
    for rec in recs:
        _drop_observations(rec, 3, 75)
        cases.set_true_state(scene, rec)
        for t in rec.tracks.values():
            t.is_estimated = False
    jrec, trec = recs
    jn = jet.estimate_all_tracks(jrec, jet.EstimateTracksOptions())
    tn = tet.estimate_all_tracks(trec, tet.EstimateTracksOptions(), **KW)
    assert tn == jn > 100
    assert _estimated(trec) == _estimated(jrec)
    for t in jrec.estimated_tracks():
        np.testing.assert_allclose(trec.tracks[t].point,
                                   jrec.tracks[t].point, rtol=0, atol=1e-8)
    subset = sorted(jrec.tracks)[::3]
    for rec in recs:
        rec.views[3].camera.extrinsics[:3] += 0.2
        for t in subset:
            rec.tracks[t].is_estimated = False
    jn = jet.estimate_all_tracks(jrec, jet.EstimateTracksOptions(),
                                 track_ids=subset)
    tn = tet.estimate_all_tracks(trec, tet.EstimateTracksOptions(),
                                 track_ids=subset, **KW)
    assert tn == jn and 0 < jn < len(subset)
    assert _estimated(trec) == _estimated(jrec)
    for t in subset:
        np.testing.assert_allclose(trec.tracks[t].point,
                                   jrec.tracks[t].point, rtol=0, atol=1e-8)


def test_filters_match_jax(scene):
    """Every view and track at the truth, then 12 track points moved by
    up to 0.5 units and view 2 shifted by 0.05; then view 7, which keeps
    10 observations, is left with one estimated track: both filters
    remove the same tracks and views."""
    rng = np.random.default_rng(9)
    recs = cases.reconstructions(scene)
    moved = rng.choice(len(recs[0].tracks), 12, replace=False)
    shift = rng.uniform(-0.5, 0.5, size=(12, 3))
    for rec in recs:
        cases.set_true_state(scene, rec)
        for t, d in zip(moved, shift):
            rec.tracks[int(t)].point[:3] += d
        rec.views[2].camera.extrinsics[:3] += 0.05
    jn = jfl.set_outlier_tracks_to_unestimated(recs[0], 5.0, 3.0)
    tn = tfl.set_outlier_tracks_to_unestimated(recs[1], 5.0, 3.0, **KW)
    assert tn == jn > 0
    assert _estimated(recs[1]) == _estimated(recs[0])
    for rec in recs:
        _drop_observations(rec, 7, 10)
        for t in sorted(rec.views[7].features)[1:]:
            rec.tracks[t].is_estimated = False
    jn = jfl.set_underconstrained_as_unestimated(recs[0])
    tn = tfl.set_underconstrained_as_unestimated(recs[1])
    assert tn == jn > 0
    assert _estimated(recs[1]) == _estimated(recs[0])
    assert 7 not in recs[1].estimated_views()
    obs_j, err_j = jfl._reprojection_errors(recs[0])
    obs_t, err_t = tfl._reprojection_errors(recs[1], **KW)
    assert obs_t == obs_j
    np.testing.assert_allclose(err_t, err_j, rtol=1e-10, atol=1e-9)


def test_outlier_filter_keeps_jax_pairing(scene):
    """The JAX module pairs the point-sorted snapshot's errors with the
    observations listed view by view (filters.py docstring); the port
    keeps that pairing. With 12 of the 150 track points moved, the
    pairing flags 74 tracks and catches 5 of the 12, where errors paired
    with their own observations would flag exactly the 12."""
    rng = np.random.default_rng(9)
    _, rec = cases.reconstructions(scene)
    cases.set_true_state(scene, rec)
    moved = {int(t) for t in rng.choice(150, 12, replace=False)}
    for t in sorted(moved):
        rec.tracks[t].point[:3] += rng.uniform(-0.5, 0.5, 3)
    obs, err = tfl._reprojection_errors(rec, **KW)
    prob, _ = rec.to_ba_problem(**KW)
    own = tfl._reproj(0, prob).numpy()
    flagged = {t for (_, t), e in zip(obs, err) if e > 5.0}
    assert {t for (_, t), e in zip(obs, own) if e > 5.0} == moved
    assert (len(flagged), len(flagged & moved)) == (74, 5)
