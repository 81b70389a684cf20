"""The port's RANSAC engine (solvers/ransac.py) against the JAX
package's on the CPU, on a line-fit spec written for both.

No torch generator reproduces JAX's random stream, so the comparisons
hand the port the sample indices JAX's samplers drew: the same best
model (to 1e-12 under float64), the same inlier mask and count, the
same confidence and best score (to 1e-12 relative). The port's
samplers are held to JAX's on the same Gumbel noise (equal indices) and
checked on their own: they respect the mask, never repeat an index
within a hypothesis, and repeat their draws for the same seed.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the modules (both packages' solvers/__init__ export a function
# `ransac` that shadows them as attributes)
jr = importlib.import_module("theiasfm_tpu.solvers.ransac")
tr = importlib.import_module("theiasfm_tpu_torch.solvers.ransac")

H = 64


def jax_line_spec():
    """y = m x + b from 2 points; squared vertical residuals."""
    def solve(pts):
        dx = pts[1, 0] - pts[0, 0]
        degenerate = jnp.abs(dx) < 1e-9
        m = (pts[1, 1] - pts[0, 1]) / jnp.where(degenerate, 1.0, dx)
        b = pts[0, 1] - m * pts[0, 0]
        return jnp.stack([m, b])[None, :], ~degenerate[None]

    def residuals(model, pts):
        return (pts[:, 1] - (model[0] * pts[:, 0] + model[1])) ** 2

    def refine(model, pts, w):
        sw = jnp.sum(w) + 1e-12
        mx = jnp.sum(w * pts[:, 0]) / sw
        my = jnp.sum(w * pts[:, 1]) / sw
        cov = jnp.sum(w * (pts[:, 0] - mx) * (pts[:, 1] - my))
        var = jnp.sum(w * (pts[:, 0] - mx) ** 2) + 1e-12
        m = cov / var
        return jnp.stack([m, my - m * mx])

    return jr.MinimalSolverSpec("line", 2, 1, solve, residuals, refine)


def torch_line_spec():
    """The same spec under the port's batched contract."""
    def solve(d):
        pts = d["p"]                                  # (..., 2, 2)
        dx = pts[..., 1, 0] - pts[..., 0, 0]
        degenerate = dx.abs() < 1e-9
        m = (pts[..., 1, 1] - pts[..., 0, 1]) / torch.where(
            degenerate, torch.ones_like(dx), dx)
        b = pts[..., 0, 1] - m * pts[..., 0, 0]
        return torch.stack([m, b], -1)[..., None, :], ~degenerate[..., None]

    def residuals(models, d):                         # (B, C, 2), (B, N, 2)
        pts = d["p"][:, None]
        pred = models[..., 0, None] * pts[..., 0] + models[..., 1, None]
        return (pts[..., 1] - pred) ** 2

    def refine(model, d, w):                          # (B, 2), (B, N)
        pts = d["p"]
        sw = w.sum(-1) + 1e-12
        mx = (w * pts[..., 0]).sum(-1) / sw
        my = (w * pts[..., 1]).sum(-1) / sw
        cov = (w * (pts[..., 0] - mx[:, None]) *
               (pts[..., 1] - my[:, None])).sum(-1)
        var = (w * (pts[..., 0] - mx[:, None]) ** 2).sum(-1) + 1e-12
        m = cov / var
        return torch.stack([m, my - m * mx], -1)

    return tr.MinimalSolverSpec("line", 2, 1, solve, residuals, refine)


def _line_data(seed, n_inl=80, n_out=20):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-10, 10, n_inl)
    inl = np.stack([x, 2.0 * x - 1.0 + rng.normal(scale=0.05, size=n_inl)],
                   -1)
    out = rng.uniform(-10, 10, (n_out, 2)) * np.array([1.0, 5.0])
    data = np.concatenate([inl, out])
    return data[rng.permutation(len(data))]


def _compare(quality, data, mask=None, n_total=None):
    opts_j = jr.RansacOptions(error_thresh=0.04, num_hypotheses=H,
                              quality=quality, model_chunk=16)
    opts_t = tr.RansacOptions(**dataclasses.asdict(opts_j))
    key = jax.random.PRNGKey(7)
    N = len(data)
    jm = None if mask is None else jnp.asarray(mask)
    idx = np.array(jr.random_samples(key, N, 2, H, jm))
    mj, sj = jax.jit(lambda k, d, m: jr.ransac(
        k, jax_line_spec(), d, opts_j, data_mask=m, num_data=n_total))(
        key, jnp.asarray(data), jm)
    mt, st = tr.ransac(
        torch.from_numpy(idx), torch_line_spec(),
        {"p": torch.from_numpy(data)}, opts_t,
        data_mask=None if mask is None else torch.from_numpy(mask),
        num_data=n_total)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_array_equal(st.inliers.numpy(), np.asarray(sj.inliers))
    assert int(st.num_inliers) == int(sj.num_inliers)
    assert st.num_hypotheses == sj.num_hypotheses == H
    np.testing.assert_allclose(float(st.confidence), float(sj.confidence),
                               rtol=1e-12)
    np.testing.assert_allclose(float(st.best_score), float(sj.best_score),
                               rtol=1e-12)
    return st


@pytest.mark.parametrize("quality", ["inlier", "msac", "mle", "lmed"])
def test_engine_matches_jax_with_its_samples(quality):
    st = _compare(quality, _line_data(0))
    assert int(st.num_inliers) >= 75


@pytest.mark.parametrize("quality", ["inlier", "lmed"])
def test_engine_matches_jax_masked(quality):
    """Padded data: a mask over 100 real rows of 128, and num_data."""
    data = np.concatenate([_line_data(1), np.zeros((28, 2))])
    mask = np.arange(128) < 100
    _compare(quality, data, mask)
    _compare(quality, data, mask, n_total=120)


def test_engine_batch_matches_single_problems():
    """ransac_batch over three problems equals three ransac calls."""
    datas = [_line_data(s) for s in (2, 3, 4)]
    opts = tr.RansacOptions(error_thresh=0.04, num_hypotheses=H)
    g = torch.Generator().manual_seed(0)
    idx = tr.random_samples(g, 100, 2, H, torch.ones(3, 100, dtype=bool))
    spec = torch_line_spec()
    mb, sb = tr.ransac_batch(idx, spec, {"p": torch.from_numpy(
        np.stack(datas))}, opts)
    for i, d in enumerate(datas):
        m1, s1 = tr.ransac(idx[i], spec, {"p": torch.from_numpy(d)}, opts)
        torch.testing.assert_close(mb[i], m1)
        assert torch.equal(sb.inliers[i], s1.inliers)


@pytest.mark.parametrize("masked", [False, True])
def test_samplers_match_jax_on_its_noise(masked):
    """Given JAX's Gumbel noise, the port's top-k picks JAX's indices
    for the random and the PROSAC sampler."""
    key = jax.random.PRNGKey(3)
    N, s = 40, 4
    mask = (np.arange(N) % 5 != 0) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    g = torch.from_numpy(np.array(jax.random.gumbel(key, (H, N))))
    np.testing.assert_array_equal(
        tr._top_k_samples(g, s, tm).numpy(),
        np.asarray(jr.random_samples(key, N, s, H, jm)))
    np.testing.assert_array_equal(
        tr._top_k_samples(g, s, tm, tr._prosac_pool(N, s, H, "cpu")).numpy(),
        np.asarray(jr.prosac_samples(key, N, s, H, jm)))


@pytest.mark.parametrize("n,h", [(10, 64), (12, 30)])
def test_exhaustive_samples_equal_jax(n, h):
    np.testing.assert_array_equal(
        tr.exhaustive_pair_samples(n, h, device="cpu").numpy(),
        np.asarray(jr.exhaustive_pair_samples(n, h)))


def test_port_samplers_respect_mask_and_repeat_for_a_seed():
    """Random draws stay in the mask, PROSAC draws in each hypothesis's
    pool; no index repeats within a hypothesis; a seed repeats."""
    mask = torch.from_numpy(np.random.default_rng(0).random((3, 50)) < 0.6)
    pool = tr._prosac_pool(50, 5, 200, "cpu")
    for fn, allowed in ((tr.random_samples, mask[:, None]),
                        (tr.prosac_samples, pool[None])):
        m = mask if fn is tr.random_samples else None
        a = fn(torch.Generator().manual_seed(5), 50, 5, 200, m)
        b = fn(torch.Generator().manual_seed(5), 50, 5, 200, m)
        c = fn(torch.Generator().manual_seed(6), 50, 5, 200, m)
        assert torch.equal(a, b) and not torch.equal(a, c)
        a = a.expand(3, 200, 5)
        assert bool(torch.gather(allowed.expand(3, 200, 50), 2, a).all())
        srt = a.sort(-1).values
        assert bool((srt[..., 1:] != srt[..., :-1]).all())


def test_ransac_with_generator_and_prosac():
    data = torch.from_numpy(_line_data(5))
    opts = tr.RansacOptions(error_thresh=0.04, num_hypotheses=H)
    for sampler in ("random", "prosac"):
        o = dataclasses.replace(opts, sampler=sampler)
        m, s = tr.ransac(torch.Generator().manual_seed(1), torch_line_spec(),
                         {"p": data}, o)
        np.testing.assert_allclose(m.numpy(), [2.0, -1.0], atol=0.05)
        assert int(s.num_inliers) >= 75 and float(s.confidence) > 0.99


def test_weighted_sampler_raises():
    opts = tr.RansacOptions(error_thresh=0.04, num_hypotheses=H,
                            sampler="weighted")
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 14"):
        tr.ransac(torch.Generator(), torch_line_spec(),
                  {"p": torch.zeros(10, 2)}, opts)


def test_adaptive_and_budget_helper():
    data = torch.from_numpy(_line_data(6))
    opts = tr.RansacOptions(error_thresh=0.04, num_hypotheses=512)
    m, s = tr.ransac_adaptive(torch.Generator().manual_seed(2),
                              torch_line_spec(), {"p": data}, opts)
    assert s.num_hypotheses == 32   # an 80% inlier line stops at once
    np.testing.assert_allclose(m.numpy(), [2.0, -1.0], atol=0.05)
    for args in ((5, 0.5), (2, 0.8, 0.001), (4, 1.0)):
        assert tr.hypotheses_for_confidence(*args) == \
            jr.hypotheses_for_confidence(*args)
