"""The port's FeatureMatcher and features-and-matches database against
the JAX package's on the CPU, verification off (tests/
test_torch_verification.py holds the verification against JAX).

Both matchers run their brute force on the CPU (JAX's XLA path, the
port's torch path) on the same features, handed to the port through
convert.features_db_from_arrays. They must store the same pairs and the
same correspondence rows; at most 0.5% of a pair's rows may differ,
because the two sum the distance matrix's float32 products in another
order, which can flip a ratio test that sits on its threshold.
"""
import dataclasses

import numpy as np
import pytest
from scipy import ndimage
from scipy.spatial.transform import Rotation

from theiasfm_tpu import matching as jm
from theiasfm_tpu.image import sift as jsift
from theiasfm_tpu.image.synth import render_synthetic_views
from theiasfm_tpu.sfm.reconstruction import CameraIntrinsicsPrior as JPrior
from theiasfm_tpu_torch import matching as tm
from theiasfm_tpu_torch.convert import features_db_from_arrays
from theiasfm_tpu_torch.image import sift as tsift
from theiasfm_tpu_torch.image import synth as tsynth
from theiasfm_tpu_torch.sfm.reconstruction import CameraIntrinsicsPrior
from theiasfm_tpu_torch.sfm.view_graph import TwoViewInfo

OFF = dict(perform_geometric_verification=False)


def _features(seed=0, n_images=5):
    """Images that each see a noisy random subset of 400 landmarks."""
    rng = np.random.default_rng(seed)
    land = np.abs(rng.normal(size=(400, 128))).astype(np.float32)
    out = {}
    for i in range(n_images):
        n = int(rng.integers(230, 300))
        sel = rng.permutation(400)[:n]
        desc = land[sel] + 0.35 * np.abs(
            rng.normal(size=(n, 128))).astype(np.float32)
        desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
        kps = np.concatenate([rng.uniform(0, 640, (n, 2)),
                              rng.uniform(1, 8, (n, 1)),
                              rng.uniform(0, 6.28, (n, 1))], -1)
        out[f"img{i}"] = (kps, desc)
    return out


def _jax_db(features):
    db = jm.InMemoryFeaturesAndMatchesDatabase()
    for name, (k, d) in features.items():
        db.put_features(name, jm.KeypointsAndDescriptors(name, k, d))
    return db


def _run(features, jax_opts=None, port_opts=None):
    jdb = _jax_db(features)
    jfm = jm.FeatureMatcher(jax_opts or jm.FeatureMatcherOptions(**OFF), jdb)
    jfm.add_images(sorted(features))
    nj = jfm.match_images()
    tdb = features_db_from_arrays(features)
    tfm = tm.FeatureMatcher(port_opts or tm.FeatureMatcherOptions(**OFF),
                            tdb, device="cpu")
    tfm.add_images(sorted(features))
    nt = tfm.match_images()
    return (nj, jdb, jfm), (nt, tdb, tfm)


def _assert_same_matches(jdb, tdb):
    pairs = jdb.image_pairs_of_matches()
    assert pairs and tdb.image_pairs_of_matches() == pairs
    for p in pairs:
        jmatch, tmatch = jdb.get_match(*p), tdb.get_match(*p)
        rows_j = {tuple(r) for r in np.round(jmatch.correspondences, 6)}
        rows_t = {tuple(r) for r in np.round(tmatch.correspondences, 6)}
        assert len(rows_j ^ rows_t) <= 0.005 * len(rows_j), p
        assert tmatch.twoview_info.num_verified_matches == \
            len(tmatch.correspondences)
        assert (tmatch.image1, tmatch.image2) == p


def test_feature_matcher_matches_jax():
    (nj, jdb, _), (nt, tdb, _) = _run(_features())
    assert nt == nj > 5
    _assert_same_matches(jdb, tdb)


def test_feature_matcher_options_match_jax():
    """No symmetric check, another ratio, a higher match floor, and
    chunks of 3 pairs."""
    kw = dict(OFF, keep_only_symmetric_matches=False, lowes_ratio=0.7,
              min_num_feature_matches=60, pair_batch_size=3)
    (nj, jdb, _), (nt, tdb, _) = _run(_features(1),
                                      jm.FeatureMatcherOptions(**kw),
                                      tm.FeatureMatcherOptions(**kw))
    assert nt == nj > 0
    _assert_same_matches(jdb, tdb)


def test_feature_matcher_resumes_and_pair_subset():
    (nj, jdb, jfm), (nt, tdb, tfm) = _run(_features(2, 4))
    assert nt == nj and jfm.match_images() == 0 and tfm.match_images() == 0
    db = features_db_from_arrays(_features(2, 4))
    fm = tm.FeatureMatcher(tm.FeatureMatcherOptions(**OFF), db, device="cpu")
    fm.set_image_pairs_to_match([("img0", "img2")])
    assert fm.match_images() == 1
    assert db.image_pairs_of_matches() == [("img0", "img2")]


def test_options_fields_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(
        jm.FeatureMatcherOptions)}
    tf = {f.name: f.default for f in dataclasses.fields(
        tm.FeatureMatcherOptions)}
    assert list(tf) == list(jf)
    assert dataclasses.asdict(tf.pop("geometric_verification")) == \
        dataclasses.asdict(jf.pop("geometric_verification"))
    assert tf == jf


def _two_view_features(seed=0, n=150):
    """Two calibrated views (focal 600, principal point (320, 240)) of
    n points at depth 4-10, with one shared 64-d descriptor per point
    (a little noise apart) and 30 extra unmatched features per view."""
    rng = np.random.default_rng(seed)
    aa = np.array([0.05, -0.1, 0.04])
    R = Rotation.from_rotvec(aa).as_matrix()
    t = np.array([1.0, 0.1, -0.05])
    pts = rng.uniform([-2, -2, 4], [2, 2, 10], size=(n, 3))
    p2 = pts @ R.T + t
    desc = rng.normal(size=(n + 60, 64)).astype(np.float32)
    out = {}
    for name, p, extra in (("img0", pts, desc[n:n + 30]),
                           ("img1", p2, desc[n + 30:])):
        pix = p[:, :2] / p[:, 2:] * 600.0 + (320.0, 240.0)
        pix = np.concatenate([pix + rng.normal(scale=0.3, size=pix.shape),
                              rng.uniform(0, 640, (30, 2))])
        d = np.concatenate([desc[:n], extra]) + 0.05 * rng.normal(
            size=(n + 30, 64)).astype(np.float32)
        kps = np.concatenate([pix, np.ones((n + 30, 2))], -1)
        out[name] = (kps, d / np.linalg.norm(d, axis=-1, keepdims=True))
    return out, aa


@pytest.mark.parametrize("kw", [
    {},   # the default verifies geometry
    dict(OFF, matcher="cascade_hashing"),
    dict(guided_matching=True),
], ids=["verification", "cascade_hashing", "guided"])
def test_unported_options_raise(kw):
    """No option raises any more. Verification (the default) and guided
    matching verify a synthetic pair on the CPU and store its relative
    pose; cascade hashing (verification off) stores the pair's putative
    matches: all 150 true correspondences and none of the 30 extra
    features."""
    features, aa = _two_view_features()
    prior = dict(image_width=640, image_height=480, focal_length=600.0,
                 principal_point=(320.0, 240.0))
    db = features_db_from_arrays(features, {n: prior for n in features})
    fm = tm.FeatureMatcher(tm.FeatureMatcherOptions(**kw), db, device="cpu")
    fm.add_images(sorted(features))
    assert fm.match_images() == 1
    m = db.get_match("img0", "img1")
    if kw.get("matcher") == "cascade_hashing":
        assert m.twoview_info.num_verified_matches == \
            len(m.correspondences) == 150
        return
    info = m.twoview_info
    assert info.num_verified_matches == len(m.correspondences) >= 130
    assert 0 < info.num_homography_inliers <= 180
    assert info.visibility_score > info.num_verified_matches
    err = np.degrees(np.linalg.norm(
        (Rotation.from_rotvec(info.rotation_2).inv() *
         Rotation.from_rotvec(aa)).as_rotvec()))
    assert err < 0.5, err


def _fill(db, features, prior):
    for name, (k, d) in features.items():
        db.put_features(name, tm.KeypointsAndDescriptors(name, k, d))
        db.put_intrinsics_prior(name, prior)


def _check_roundtrip(db, features):
    assert db.image_names_of_features() == sorted(features)
    for name, (k, d) in features.items():
        f = db.get_features(name)
        np.testing.assert_array_equal(f.keypoints, k)
        np.testing.assert_array_equal(f.descriptors, d)
        p = db.get_intrinsics_prior(name)
        assert p.focal_length == 600.0 and p.image_width == 640
        assert tuple(p.principal_point) == (320.0, 240.0)
        assert int(p.camera_intrinsics_model_type) == 0
    m = db.get_match("img0", "img1")
    np.testing.assert_array_equal(m.correspondences,
                                  np.arange(8.0).reshape(2, 4))
    assert m.twoview_info.num_verified_matches == 2
    assert db.image_pairs_of_matches() == [("img0", "img1")]
    assert db.num_matches() == 1
    assert db.get_match("img1", "img0") is None


@pytest.mark.parametrize("kind", ["memory", "disk"])
def test_database_roundtrip(kind, tmp_path):
    features = _features(3, 3)
    db = (tm.InMemoryFeaturesAndMatchesDatabase() if kind == "memory"
          else tm.DiskFeaturesAndMatchesDatabase(str(tmp_path)))
    prior = CameraIntrinsicsPrior(image_width=640, image_height=480,
                                  focal_length=600.0,
                                  principal_point=(320.0, 240.0))
    _fill(db, features, prior)
    db.put_match("img0", "img1", tm.ImagePairMatch(
        "img0", "img1", TwoViewInfo(num_verified_matches=2),
        np.arange(8.0).reshape(2, 4)))
    _check_roundtrip(db, features)
    assert db.contains_features("img2") and not db.contains_features("x")


def test_disk_database_reads_jax_written_store(tmp_path):
    """The port's disk store reads a directory the JAX package wrote."""
    features = _features(4, 3)
    jdb = jm.DiskFeaturesAndMatchesDatabase(str(tmp_path))
    for name, (k, d) in features.items():
        jdb.put_features(name, jm.KeypointsAndDescriptors(name, k, d))
        jdb.put_intrinsics_prior(name, JPrior(
            image_width=640, image_height=480, focal_length=600.0,
            principal_point=(320.0, 240.0)))
    from theiasfm_tpu.sfm.view_graph import TwoViewInfo as JInfo
    jdb.put_match("img0", "img1", jm.ImagePairMatch(
        "img0", "img1", JInfo(num_verified_matches=2),
        np.arange(8.0).reshape(2, 4)))
    _check_roundtrip(tm.DiskFeaturesAndMatchesDatabase(str(tmp_path)),
                     features)


def test_features_db_from_arrays_priors():
    features = _features(5, 2)
    db = features_db_from_arrays(features, {"img1": dict(
        image_width=320, focal_length=300.0,
        camera_intrinsics_model_type=1)})
    assert db.get_intrinsics_prior("img0") is None
    p = db.get_intrinsics_prior("img1")
    assert p.focal_length == 300.0 and p.image_width == 320
    assert p.camera_intrinsics_model_type.name == "PINHOLE_RADIAL_TANGENTIAL"
    k, d = features["img0"]
    got = db.get_features("img0")
    np.testing.assert_array_equal(got.descriptors, d)
    assert got.keypoints is not k


def test_small_slice_matches_jax():
    """Three synthetic 160x120 views -> SIFT -> matcher in both packages:
    the same pairs stored, putative-match counts within 2%."""
    rng = np.random.default_rng(0)
    tex = sum(s * ndimage.gaussian_filter(rng.normal(size=(192, 256)), s)
              for s in (1, 2, 4, 8))
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    views, _ = render_synthetic_views(tex, 3, (160, 120), focal=150.0)
    tviews, _ = tsynth.render_synthetic_views(tex, 3, (160, 120),
                                              focal=150.0)
    for a, b in zip(views, tviews):
        np.testing.assert_array_equal(a, b)

    jres = jsift.extract_sift_batch(
        views, jsift.SiftOptions(max_features_per_octave=256))
    tres = tsift.extract_sift_batch(
        views, tsift.SiftOptions(max_features_per_octave=256), device="cpu")
    jdb = _jax_db({f"v{i}": (k[v], d[v]) for i, (k, d, v) in
                   enumerate(jres)})
    tdb = features_db_from_arrays({f"v{i}": (k[v], d[v]) for i, (k, d, v)
                                   in enumerate(tres)})
    jfm = jm.FeatureMatcher(jm.FeatureMatcherOptions(**OFF), jdb)
    tfm = tm.FeatureMatcher(tm.FeatureMatcherOptions(**OFF), tdb,
                            device="cpu")
    for fm in (jfm, tfm):
        fm.add_images(["v0", "v1", "v2"])
    nj, nt = jfm.match_images(), tfm.match_images()
    assert nt == nj == 3
    assert tdb.image_pairs_of_matches() == jdb.image_pairs_of_matches()
    for p in jdb.image_pairs_of_matches():
        cj = len(jdb.get_match(*p).correspondences)
        ct = len(tdb.get_match(*p).correspondences)
        assert cj >= 30 and abs(ct - cj) <= 0.02 * cj, (p, cj, ct)
