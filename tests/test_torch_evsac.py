"""The port's EVSAC sampler (solvers/evsac.py), the weighted sampler of
its RANSAC engine, math/probability.py and math/gauss_jordan.py against
the JAX package's, in float64 on the CPU.

The EVSAC fits (MR-Rayleigh, the gamma and GEV maximum-likelihood
Newton steps) and the EM of evsac_probabilities agree with JAX's to
1e-8 relative; the mixture's posterior, which goes through the
regularized incomplete gamma (the two libraries' agree to ~3e-8), to
1e-6; one problem at a time and batched along a leading axis. No
torch generator reproduces JAX's stream, so the weighted RANSAC is
held to JAX's with JAX's Gumbel top-k indices injected (the same model
to 1e-8), and the port's own weighted draws by what they must do: pick
all-inlier samples far more often than uniform draws, and no masked
datum while unmasked weight remains. The numpy probability module is a copy
and gives the same numbers; Gauss-Jordan agrees to 1e-10.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theiasfm_tpu.math import probability as jprob
from theiasfm_tpu.sfm.estimators import twoview_estimators as jte
from theiasfm_tpu.solvers import RansacOptions as JRansacOptions
from theiasfm_tpu_torch import solver_problems as sp
from theiasfm_tpu_torch.math import probability as tprob
from theiasfm_tpu_torch.sfm.estimators import twoview_estimators as tte
from theiasfm_tpu_torch.solvers import RansacOptions, draw_samples, ransac

from test_evsac import _make_knn_distances
from torch_sfm_cases import one_torch_thread  # noqa: F401

jev = importlib.import_module("theiasfm_tpu.solvers.evsac")
tev = importlib.import_module("theiasfm_tpu_torch.solvers.evsac")
jransac = importlib.import_module("theiasfm_tpu.solvers.ransac")
jgj = importlib.import_module("theiasfm_tpu.math.gauss_jordan")
tgj = importlib.import_module("theiasfm_tpu_torch.math.gauss_jordan")
T = torch.from_numpy


def _knn(seed, n=400, ratio=0.25):
    d, correct = _make_knn_distances(np.random.default_rng(seed), n=n,
                                     inlier_ratio=ratio)
    return np.asarray(d, np.float64), correct


def test_fits_match_jax():
    d, _ = _knn(0)
    w = (np.random.default_rng(1).random(len(d)) > 0.3).astype(float)
    jp, jc = map(np.asarray, jev.mr_rayleigh_predict(jnp.asarray(d)))
    tp, tc = tev.mr_rayleigh_predict(T(d))
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-12)
    jk = np.asarray(jev.fit_gamma_mle(jnp.asarray(d[:, 0]), jnp.asarray(w)))
    tk = np.asarray([float(v) for v in tev.fit_gamma_mle(T(d[:, 0]),
                                                         T(w))])
    np.testing.assert_allclose(tk, jk, rtol=1e-10)
    jg = np.asarray(jev.fit_gev_mle(jnp.asarray(-d[:, 1]), jnp.asarray(w)))
    tg = np.asarray([float(v) for v in tev.fit_gev_mle(T(-d[:, 1]), T(w))])
    np.testing.assert_allclose(tg, jg, rtol=1e-8)
    x = np.linspace(-1.5, 0.5, 41)
    for f in ("gev_logpdf", "gev_cdf"):
        for xi in (-0.3, 1e-8, 0.2):
            je = np.asarray(getattr(jev, f)(jnp.asarray(x), -0.9, 0.1, xi))
            te = getattr(tev, f)(T(x), -0.9, 0.1, xi).numpy()
            np.testing.assert_allclose(te, je, rtol=1e-10)
    # the two libraries' regularized incomplete gamma agree to ~3e-8
    np.testing.assert_allclose(
        tev.gamma_cdf(T(np.abs(x)), torch.tensor(2.0), torch.tensor(0.1))
        .numpy(), np.asarray(jev.gamma_cdf(jnp.asarray(np.abs(x)), 2.0, 0.1)),
        rtol=1e-7)


def test_mixture_matches_jax_single_and_batched():
    ds, masks, refs = [], [], []
    for seed in (2, 3):
        d, _ = _knn(seed)
        mask = np.random.default_rng(seed).random(len(d)) > 0.05
        post, w, params = jev.evsac_mixture(jnp.asarray(d), 0.65,
                                            jnp.asarray(mask))
        refs.append((np.asarray(post), np.asarray(w),
                     np.asarray([float(v) for v in params])))
        ds.append(d)
        masks.append(mask)
    post, w, params = tev.evsac_mixture(T(np.stack(ds)), 0.65,
                                        T(np.stack(masks)))
    for b, (jpost, jw, jparams) in enumerate(refs):
        # the inlier ratio fits the gamma CDF (incomplete gamma, ~3e-8
        # between the libraries); the rest follows it
        np.testing.assert_allclose(post[b].numpy(), jpost, rtol=1e-6,
                                   atol=1e-12)
        np.testing.assert_allclose(w[b].numpy(), jw, rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose([float(p[b]) for p in params], jparams,
                                   rtol=1e-6)
    one = tev.evsac_mixture(T(ds[0]), 0.65, T(masks[0]))[0]
    np.testing.assert_allclose(one.numpy(), post[0].numpy(), rtol=1e-12)


def test_evsac_probabilities_matches_jax():
    rng = np.random.default_rng(4)
    d = np.stack([_knn(5)[0][:, 0], _knn(6)[0][:, 0]])
    mask = rng.random(d.shape) > 0.1
    ref = np.stack([np.asarray(jev.evsac_probabilities(
        jnp.asarray(d[b]), jnp.asarray(mask[b]))) for b in range(2)])
    out = tev.evsac_probabilities(T(d), T(mask)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(tev.evsac_probabilities(T(d[0])).numpy(),
                               np.asarray(jev.evsac_probabilities(
                                   jnp.asarray(d[0]))), rtol=1e-8,
                               atol=1e-12)


def test_weighted_draws_favour_inliers():
    """The port's own weighted draws: all-inlier 5-samples far more often
    than uniform draws (the reference's acceleration claim), never a
    masked datum while unmasked weight remains."""
    d, correct = _knn(7, n=600, ratio=0.15)
    _, w, _ = tev.evsac_mixture(T(d))
    gen = torch.Generator().manual_seed(0)
    idx = tev.weighted_samples(gen, w, 5, 256).numpy()
    assert idx.shape == (256, 5)
    assert all(len(set(r)) == 5 for r in idx)
    pure = np.all(correct[idx], axis=1).mean()
    assert pure > 0.2, pure          # uniform: some 7.6e-5
    x = sp.relative_pose(np.random.default_rng(8), 1, 96, noise=1e-3)
    mask = torch.ones(128, dtype=torch.bool)
    mask[96:] = False
    wt = torch.rand(128, generator=gen, dtype=torch.float64)
    opts = RansacOptions(error_thresh=1e-5, num_hypotheses=64,
                         sampler="weighted")
    spec = tte.relative_pose_spec()
    drawn = draw_samples(gen, spec, 128, opts, mask, sample_weights=wt)
    assert drawn.shape == (64, 5) and int(drawn.max()) < 96
    data = {k: torch.cat([T(x[k][0]), torch.zeros(32, 2,
                                                  dtype=torch.float64)])
            for k in ("x1", "x2")}
    _, summary = ransac(gen, spec, data, opts, data_mask=mask,
                        sample_weights=wt)
    assert int(summary.num_inliers) >= 90


@pytest.mark.parametrize("sampler", ["weighted", "random"])
def test_weighted_ransac_with_jax_indices_matches_jax(sampler):
    """ransac with sample_weights ('weighted', or 'random' with weights,
    which samples the same way) on a relative pose problem, the port
    given the indices JAX's Gumbel top-k draws."""
    x = sp.relative_pose(np.random.default_rng(9), 1, 120, noise=1e-3)
    x1, x2 = x["x1"][0], x["x2"][0]
    x2[:30] = np.random.default_rng(10).uniform(-0.5, 0.5, (30, 2))
    b = 128
    pad = np.zeros((b - 120, 2))
    data = {"x1": np.concatenate([x1, pad]), "x2": np.concatenate([x2, pad])}
    mask = np.arange(b) < 120
    w = np.random.default_rng(11).uniform(0.05, 1.0, b)
    w[30:120] += 1.0
    key = jax.random.PRNGKey(3)
    H, thresh = 64, 1e-5
    jE, js = jransac.ransac(
        key, jte.relative_pose_spec(),
        {k: jnp.asarray(v) for k, v in data.items()},
        JRansacOptions(error_thresh=thresh, num_hypotheses=H,
                       sampler=sampler), data_mask=jnp.asarray(mask),
        sample_weights=jnp.asarray(w))
    idx = np.asarray(jev.weighted_samples(key, jnp.asarray(w * mask), 5, H))
    tE, ts = ransac(T(idx), tte.relative_pose_spec(),
                    {k: T(v) for k, v in data.items()},
                    RansacOptions(error_thresh=thresh, num_hypotheses=H,
                                  sampler=sampler),
                    data_mask=T(mask), sample_weights=T(w))
    np.testing.assert_array_equal(ts.inliers.numpy(), np.asarray(js.inliers))
    np.testing.assert_allclose(tE.numpy(), np.asarray(jE), rtol=0,
                               atol=1e-8)
    assert int(ts.num_inliers) >= 85


def test_probability_copy_matches_jax():
    for sigma, eps in ((0.05, 0.6), (0.1, 0.3)):
        assert tprob.sprt_decision_threshold(sigma, eps) == \
            jprob.sprt_decision_threshold(sigma, eps)
    r = np.random.default_rng(12).random(200) * 2
    a = jprob.sprt_decision_threshold(0.05, 0.6)
    assert tprob.sequential_probability_ratio_test(r, 1.0, 0.05, 0.6, a) \
        == jprob.sequential_probability_ratio_test(r, 1.0, 0.05, 0.6, a)
    x = np.linspace(-3, 3, 13)
    np.testing.assert_array_equal(tprob.NormalDistribution(0.5, 2).eval(x),
                                  jprob.NormalDistribution(0.5, 2).eval(x))
    np.testing.assert_array_equal(tprob.UniformDistribution(-1, 2).eval(x),
                                  jprob.UniformDistribution(-1, 2).eval(x))
    th, jh = tprob.Histogram([0, 1, 2, 3]), jprob.Histogram([0, 1, 2, 3])
    ts, js = tprob.ReservoirSampler(5, seed=1), jprob.ReservoirSampler(
        5, seed=1)
    for v in np.random.default_rng(13).random(100) * 4:
        th.add(v)
        jh.add(v)
        ts.add(v)
        js.add(v)
    np.testing.assert_array_equal(th.counts, jh.counts)
    assert ts.samples == js.samples


@pytest.mark.parametrize("shape,max_rows", [((4, 4), None), ((5, 8), None),
                                            ((6, 9), 4)])
def test_gauss_jordan_matches_jax(shape, max_rows):
    A = np.random.default_rng(14).normal(size=(6,) + shape)
    A[0, 0, 0] = 0.0                       # needs a pivot swap
    ref = np.stack([np.asarray(jgj.gauss_jordan(jnp.asarray(a), max_rows))
                    for a in A])
    out = tgj.gauss_jordan(T(A), max_rows).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-10)
