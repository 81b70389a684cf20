"""A 3-view SIFT -> match -> verify slice in both packages on the CPU,
with JAX's sample indices and the port verifying in float64 (see
tests/test_torch_verification.py for the method).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import ndimage

from theiasfm_tpu import matching as jm
from theiasfm_tpu.image import sift as jsift
from theiasfm_tpu.image.synth import render_synthetic_views
from theiasfm_tpu.sfm.pipeline import twoview as jtv
from theiasfm_tpu.sfm.reconstruction import CameraIntrinsicsPrior as JPrior
from theiasfm_tpu_torch import matching as tm
from theiasfm_tpu_torch.convert import features_db_from_arrays
from theiasfm_tpu_torch.sfm.pipeline import geometric_verification as tgv
from theiasfm_tpu_torch.sfm.pipeline import twoview as ttv
from torch_verification_cases import F64, H, jax_batch_samples


def _slice_features():
    rng = np.random.default_rng(0)
    tex = sum(s * ndimage.gaussian_filter(rng.normal(size=(192, 256)), s)
              for s in (1, 2, 4, 8))
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    views, _ = render_synthetic_views(tex, 3, (160, 120), focal=150.0)
    res = jsift.extract_sift_batch(
        views, jsift.SiftOptions(max_features_per_octave=256))
    return {f"v{i}": (np.asarray(k)[np.asarray(v)],
                      np.asarray(d)[np.asarray(v)])
            for i, (k, d, v) in enumerate(res)}


@pytest.mark.parametrize("guided", [False, True],
                         ids=["plain", "guided"])
def test_small_slice_verifies_as_jax(guided, monkeypatch):
    """Three synthetic 160x120 views -> SIFT (JAX's features for both)
    -> FeatureMatcher with verification on, in both packages. The port's
    matcher draws its samples through draw_verification_samples; here it
    gets the ones JAX's matcher draws from the same seed, and verifies
    in float64 as JAX does under x64: the same verified pairs, counts
    within 2%, rotations within 0.1 degrees."""
    feats = _slice_features()
    prior = dict(image_width=160, image_height=120, focal_length=150.0,
                 principal_point=(80.0, 60.0))
    jdb = jm.InMemoryFeaturesAndMatchesDatabase()
    for name, (k, d) in feats.items():
        jdb.put_features(name, jm.KeypointsAndDescriptors(name, k, d))
        jdb.put_intrinsics_prior(name, JPrior(**prior))
    jfm = jm.FeatureMatcher(jm.FeatureMatcherOptions(
        guided_matching=guided,
        geometric_verification=jtv.TwoViewInfoOptions(num_hypotheses=H)),
        jdb)

    def jax_chunk_samples(generator, mask, num_hypotheses):
        # FeatureMatcher: split(PRNGKey(seed)) per chunk, one more
        # split before verify_matches_batch
        _, k = jax.random.split(jax.random.PRNGKey(0))
        _, k = jax.random.split(k)
        assert num_hypotheses == H
        return jax_batch_samples(k, mask.numpy())
    monkeypatch.setattr(tgv, "draw_verification_samples", jax_chunk_samples)
    monkeypatch.setattr(tgv, "verify_matches_batch", functools.partial(
        tgv.verify_matches_batch, dtype=F64))
    tdb = features_db_from_arrays(feats, {n: prior for n in feats})
    tfm = tm.FeatureMatcher(tm.FeatureMatcherOptions(
        guided_matching=guided,
        geometric_verification=ttv.TwoViewInfoOptions(num_hypotheses=H)),
        tdb, device="cpu")
    for fm in (jfm, tfm):
        fm.add_images(sorted(feats))
    nj, nt = jfm.match_images(), tfm.match_images()
    assert nt == nj >= 2
    assert tdb.image_pairs_of_matches() == jdb.image_pairs_of_matches()
    for p in jdb.image_pairs_of_matches():
        a = jdb.get_match(*p).twoview_info
        b = tdb.get_match(*p).twoview_info
        assert abs(b.num_verified_matches - a.num_verified_matches) <= \
            0.02 * a.num_verified_matches, p
        assert np.degrees(np.abs(b.rotation_2 - a.rotation_2).max()) < 0.1
        assert len(tdb.get_match(*p).correspondences) == \
            b.num_verified_matches

