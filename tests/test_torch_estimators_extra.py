"""The port's uncalibrated and transform estimators against the JAX
package's, in float64 on the CPU, every RANSAC with the indices JAX
draws over the padded data injected (no torch generator reproduces
JAX's stream): the same inliers and models to 1e-8 (1e-6 relative where
a minimal solver polishes with Gauss-Newton or descends from a
multistart). The batched entry points give, problem by problem, what
the one-problem calls give. The slice test runs three synthetic views
through the port's SIFT and matcher (chip_smoke.putative_pairs, the
card phases' inputs) and then, in both packages, the uncalibrated
relative pose and the relative pose with EVSAC's weighted sampler.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

import chip_smoke as cs
from theiasfm_tpu.sfm.estimators import transforms as jtr
from theiasfm_tpu.sfm.estimators import twoview_estimators as jte
from theiasfm_tpu.sfm.estimators import uncalibrated as jun
from theiasfm_tpu.solvers import RansacOptions as JRansacOptions
from theiasfm_tpu.solvers.ransac import random_samples as jrs
from theiasfm_tpu_torch import solver_problems as sp
from theiasfm_tpu_torch.image import sift as tsift
from theiasfm_tpu_torch.image import synth as tsynth
from theiasfm_tpu_torch.sfm.estimators import transforms as ttr
from theiasfm_tpu_torch.sfm.estimators import uncalibrated as tun
from theiasfm_tpu_torch.solvers import RansacOptions, ransac, ransac_batch
from theiasfm_tpu_torch.solvers import evsac as tev

from torch_sfm_cases import one_torch_thread  # noqa: F401

jransac = importlib.import_module("theiasfm_tpu.solvers.ransac")
jev = importlib.import_module("theiasfm_tpu.solvers.evsac")
T = torch.from_numpy


def _jidx(key, n, minimum, s, H):
    """The indices JAX's entry point draws: over the data padded to
    next_bucket(n, minimum), the padding masked."""
    b = minimum
    while b < n:
        b *= 2
    return T(np.array(jrs(key, b, s, H, jnp.asarray(np.arange(b) < n))))


def _opts(thresh, H, **kw):
    return (JRansacOptions(error_thresh=thresh, num_hypotheses=H, **kw),
            RansacOptions(error_thresh=thresh, num_hypotheses=H, **kw))


def _close(a, b, rel):
    a, b = np.asarray(a, float), np.asarray(b, float)
    assert np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)) < rel, (a, b)


def test_uncalibrated_absolute_pose_p4pf_matches_jax():
    p = sp.absolute_pose(np.random.default_rng(0), 1, 90, focal=(700, 900),
                         noise_px=0.3, outliers=0.15)
    world, image = p["world"][0], p["image"][0]
    key = jax.random.PRNGKey(1)
    jo, to = _opts(3.0 ** 2, 32)
    ref = jun.estimate_uncalibrated_absolute_pose(
        key, jnp.asarray(world), jnp.asarray(image), jo)
    out = tun.estimate_uncalibrated_absolute_pose(
        _jidx(key, 90, 64, 4, 32), T(world), T(image), to)
    np.testing.assert_array_equal(out["inliers"].numpy(),
                                  np.asarray(ref["inliers"]))
    assert int(out["num_inliers"]) >= 0.8 * 90
    _close(out["extrinsics"].numpy(), ref["extrinsics"], 1e-6)
    _close(float(out["focal_length"]), float(ref["focal_length"]), 1e-6)
    _close(out["intrinsics_tail"].numpy(), ref["intrinsics_tail"], 1e-6)
    assert abs(float(out["focal_length"]) - p["focal"][0]) < 0.02 * \
        p["focal"][0]


def test_uncalibrated_absolute_pose_dlt_spec_matches_jax():
    p = sp.absolute_pose(np.random.default_rng(1), 1, 128, focal=(700, 900),
                         noise_px=0.3, outliers=0.15)
    data = {"world": p["world"][0], "image": p["image"][0]}
    key = jax.random.PRNGKey(2)
    jo, to = _opts(3.0 ** 2, 64)
    jm, js = jransac.ransac(key, jun.uncalibrated_absolute_pose_spec(),
                            {k: jnp.asarray(v) for k, v in data.items()}, jo)
    idx = T(np.array(jrs(key, 128, 6, 64, None)))
    tm, ts = ransac(idx, tun.uncalibrated_absolute_pose_spec(),
                    {k: T(v) for k, v in data.items()}, to)
    np.testing.assert_array_equal(ts.inliers.numpy(), np.asarray(js.inliers))
    _close(tm.numpy(), jm, 1e-8)


def test_uncalibrated_relative_pose_matches_jax():
    p = sp.relative_pose(np.random.default_rng(2), 1, 150, noise=3e-4)
    f1, f2 = 700.0, 900.0
    x1, x2 = p["x1"][0] * f1, p["x2"][0] * f2
    x2[:15] = np.random.default_rng(3).uniform(-300, 300, (15, 2))
    key = jax.random.PRNGKey(3)
    jo, to = _opts(2.0 ** 2, 128)
    ref = jun.estimate_uncalibrated_relative_pose(
        key, jnp.asarray(x1), jnp.asarray(x2), jo)
    out = tun.estimate_uncalibrated_relative_pose(
        _jidx(key, 150, 64, 8, 128), T(x1), T(x2), to)
    np.testing.assert_array_equal(out["inliers"].numpy(),
                                  np.asarray(ref["inliers"]))
    sgn = np.sign(np.sum(out["F"].numpy() * np.asarray(ref["F"])))
    np.testing.assert_allclose(out["F"].numpy() * sgn, np.asarray(ref["F"]),
                               rtol=0, atol=1e-8)
    for k in ("focal_length_1", "focal_length_2"):
        _close(float(out[k]), float(ref[k]), 1e-6)
    assert bool(out["focal_valid"]) == bool(ref["focal_valid"])
    np.testing.assert_allclose(out["R"].numpy(), np.asarray(ref["R"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(out["t"].numpy(), np.asarray(ref["t"]),
                               rtol=0, atol=1e-6)
    assert abs(float(out["focal_length_1"]) - f1) < 0.12 * f1


@pytest.mark.parametrize("with_scale", [False, True])
def test_rigid_transform_matches_jax(with_scale):
    p = sp.rigid_pairs(np.random.default_rng(4), 1, 60, with_scale,
                       noise=0.01, outliers=0.2)
    src, dst = p["src"][0], p["dst"][0]
    key = jax.random.PRNGKey(4)
    jo, to = _opts(0.05 ** 2, 64)
    ref = jtr.estimate_rigid_transform(key, jnp.asarray(src),
                                       jnp.asarray(dst), jo,
                                       with_scale=with_scale)
    out = ttr.estimate_rigid_transform(_jidx(key, 60, 16, 3, 64), T(src),
                                       T(dst), to, with_scale=with_scale)
    np.testing.assert_array_equal(out["inliers"].numpy(),
                                  np.asarray(ref["inliers"]))
    for k in ("R", "t", "scale"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-8)
    assert np.abs(out["R"].numpy() - p["R"][0]).max() < 1e-2


def test_triangulation_matches_jax():
    rng = np.random.default_rng(5)
    X = np.array([0.5, -0.3, 6.0])
    o = rng.uniform(-2, 2, (7, 3)) * [1, 1, 0]
    d = X - o + rng.normal(scale=1e-3, size=(7, 3))
    d[0] = [0.3, 0.2, 1.0]                       # an outlier ray
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    key = jax.random.PRNGKey(5)
    jo, to = _opts(1e-4, 16)
    ref = jtr.estimate_triangulation(key, jnp.asarray(o), jnp.asarray(d), jo)
    out = ttr.estimate_triangulation(_jidx(key, 7, 8, 2, 16), T(o), T(d), to)
    np.testing.assert_array_equal(out["inliers"].numpy(),
                                  np.asarray(ref["inliers"]))
    np.testing.assert_allclose(out["point"].numpy(), np.asarray(ref["point"]),
                               rtol=0, atol=1e-8)
    assert np.linalg.norm(out["point"].numpy() - X) < 0.05


def test_dominant_plane_matches_jax():
    rng = np.random.default_rng(6)
    pts = np.concatenate([
        np.c_[rng.uniform(-5, 5, (80, 2)), rng.normal(scale=0.01, size=80)],
        rng.uniform(-5, 5, (30, 3))])
    key = jax.random.PRNGKey(6)
    jo, to = _opts(0.05 ** 2, 64)
    ref = jtr.estimate_dominant_plane_from_points(key, jnp.asarray(pts), jo)
    out = ttr.estimate_dominant_plane_from_points(
        _jidx(key, 110, 16, 3, 64), T(pts), to)
    np.testing.assert_array_equal(out["inliers"].numpy(),
                                  np.asarray(ref["inliers"]))
    sgn = np.sign(np.sum(out["plane"].numpy() * np.asarray(ref["plane"])))
    np.testing.assert_allclose(out["plane"].numpy() * sgn,
                               np.asarray(ref["plane"]), rtol=0, atol=1e-8)


def test_similarity_transform_2d_3d_matches_jax():
    p = sp.generalized_similarity(np.random.default_rng(7), 1, 50,
                                  noise=1e-4, outliers=0.2)
    args = (p["origin"][0], p["dir"][0], p["point"][0])
    key = jax.random.PRNGKey(7)
    jo, to = _opts(1e-6, 32)
    ref = jtr.estimate_similarity_transform_2d_3d(
        key, *map(jnp.asarray, args), jo)
    out = ttr.estimate_similarity_transform_2d_3d(
        _jidx(key, 50, 16, 4, 32), *map(T, args), to)
    np.testing.assert_array_equal(out["inliers"].numpy(),
                                  np.asarray(ref["inliers"]))
    for k in ("R", "t", "scale"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-6)
    assert abs(float(out["scale"]) - p["s"][0]) < 0.05 * p["s"][0]


def test_batched_entry_points_equal_single_calls():
    """Problem b of one batched call is the one-problem call on problem
    b, for every new entry point (port only, the same indices)."""
    g = torch.Generator().manual_seed(0)
    p = sp.rigid_pairs(np.random.default_rng(8), 3, 40, True, noise=0.01,
                       outliers=0.2)
    src, dst = T(p["src"]), T(p["dst"])
    idx = torch.stack([torch.randperm(48, generator=g)[:3] % 40
                       for _ in range(3 * 16)]).reshape(3, 16, 3)
    o = RansacOptions(error_thresh=0.05 ** 2, num_hypotheses=16)
    bat = ttr.estimate_rigid_transform(idx, src, dst, o, with_scale=True)
    for b in range(3):
        one = ttr.estimate_rigid_transform(idx[b], src[b], dst[b], o,
                                           with_scale=True)
        np.testing.assert_array_equal(bat["inliers"][b].numpy(),
                                      one["inliers"].numpy())
        np.testing.assert_allclose(bat["R"][b].numpy(), one["R"].numpy(),
                                   rtol=0, atol=1e-12)
    q = sp.absolute_pose(np.random.default_rng(9), 2, 64, focal=(600, 800),
                         noise_px=0.3)
    idx = torch.stack([torch.randperm(64, generator=g)[:4]
                       for _ in range(2 * 8)]).reshape(2, 8, 4)
    o = RansacOptions(error_thresh=9.0, num_hypotheses=8)
    bat = tun.estimate_uncalibrated_absolute_pose(idx, T(q["world"]),
                                                  T(q["image"]), o)
    for b in range(2):
        one = tun.estimate_uncalibrated_absolute_pose(
            idx[b], T(q["world"][b]), T(q["image"][b]), o)
        np.testing.assert_allclose(bat["extrinsics"][b].numpy(),
                                   one["extrinsics"].numpy(), rtol=0,
                                   atol=1e-10)
        assert int(bat["num_inliers"][b]) == int(one["num_inliers"])


def _slice_pairs():
    """Three 320x240 synthetic views (focal 300) through the port's SIFT
    and chip_smoke.putative_pairs on the CPU."""
    rng = np.random.default_rng(0)
    tex = sum(s * ndimage.gaussian_filter(rng.normal(size=(384, 512)), s)
              for s in (1, 2, 4, 8))
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    views, cams = tsynth.render_synthetic_views(tex, 3, (320, 240),
                                                focal=300.0)
    res = tsift.extract_sift_batch(
        views, tsift.SiftOptions(max_features_per_octave=512), device="cpu")
    names = [f"v{i}" for i in range(3)]
    arrays = {n: (k[v], d[v]) for n, (k, d, v) in zip(names, res)}
    P = cs.putative_pairs(arrays, names, "cpu")
    return P, cams


def test_slice_uncalibrated_and_weighted_relative_pose_match_jax():
    P, cams = _slice_pairs()
    n = int(P["mask"][0].sum())
    assert n >= 100
    # pixel coordinates relative to the image centre (160, 120): the
    # helper centres on chip_smoke's (320, 240)
    shift = torch.tensor([160.0, 120.0])
    x1 = (P["x1"][0, :n] + shift).double()
    x2 = (P["x2"][0, :n] + shift).double()
    key = jax.random.PRNGKey(0)
    jo, to = _opts(2.0 ** 2, 128)
    ref = jun.estimate_uncalibrated_relative_pose(
        key, jnp.asarray(x1.numpy()), jnp.asarray(x2.numpy()), jo)
    out = tun.estimate_uncalibrated_relative_pose(
        _jidx(key, n, 64, 8, 128), x1, x2, to)
    np.testing.assert_array_equal(out["inliers"].numpy(),
                                  np.asarray(ref["inliers"]))
    assert int(out["num_inliers"]) >= 0.8 * n
    sgn = np.sign(np.sum(out["F"].numpy() * np.asarray(ref["F"])))
    np.testing.assert_allclose(out["F"].numpy() * sgn, np.asarray(ref["F"]),
                               rtol=0, atol=1e-8)

    # EVSAC: probabilities of the best/second distance ratios, then the
    # relative pose with the weighted sampler (normalized coordinates)
    ratio = P["ratio"][0, :n].double()
    jw = np.asarray(jev.evsac_probabilities(jnp.asarray(ratio.numpy())))
    tw = tev.evsac_probabilities(ratio)
    np.testing.assert_allclose(tw.numpy(), jw, rtol=1e-8, atol=1e-12)
    b = 64
    while b < n:
        b *= 2
    pad = np.zeros((b - n, 2))
    data = {"x1": np.concatenate([x1.numpy() / 300.0, pad]),
            "x2": np.concatenate([x2.numpy() / 300.0, pad])}
    mask = np.arange(b) < n
    w = np.concatenate([jw, np.zeros(b - n)])
    jo, to = _opts((2.0 / 300.0) ** 2, 128, sampler="weighted")
    jE, js = jransac.ransac(key, jte.relative_pose_spec(),
                            {k: jnp.asarray(v) for k, v in data.items()},
                            jo, data_mask=jnp.asarray(mask),
                            sample_weights=jnp.asarray(w))
    idx = T(np.asarray(jev.weighted_samples(key, jnp.asarray(w * mask), 5,
                                            128)))
    from theiasfm_tpu_torch.sfm.estimators import relative_pose_spec
    tE, ts = ransac_batch(idx[None], relative_pose_spec(),
                          {k: T(v)[None] for k, v in data.items()}, to,
                          data_mask=T(mask)[None],
                          sample_weights=T(w)[None])
    np.testing.assert_array_equal(ts.inliers[0].numpy(),
                                  np.asarray(js.inliers))
    np.testing.assert_allclose(tE[0].numpy(), np.asarray(jE), rtol=0,
                               atol=1e-8)
    assert int(ts.num_inliers[0]) >= 0.8 * n
