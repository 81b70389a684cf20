"""The port's two-sided radial-distortion homography (H6_l1l2) and its
RANSAC estimator against the JAX package's, in float64 on the CPU.

The solver sweeps a 14 x 14 (l1, l2) grid of 12x9 DLT matrices, ranks
the cells by their smallest singular value (a stable argsort) and
polishes the best two with Gauss-Newton: validity agrees exactly, the
solutions to 1e-7 (a polish that stops short of a root amplifies
rounding), the symmetric transfer error to 1e-10, and the polish's
closed-form jacobian equals jax.jacfwd of the JAX residual to 1e-10.
The estimator, given the indices JAX draws over the padded data,
returns the same inliers and model to 1e-8. In float32 the ranking of
near-equal cells may differ from float64; the share of exact problems
solved on the CPU is held to no less than JAX's float32 share less
0.1.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theiasfm_tpu.sfm.estimators import twoview_estimators as jte
from theiasfm_tpu.solvers import RansacOptions as JRansacOptions
from theiasfm_tpu.solvers.ransac import random_samples as jrs
from theiasfm_tpu_torch import solver_problems as sp
from theiasfm_tpu_torch.sfm.estimators import twoview_estimators as tte
from theiasfm_tpu_torch.solvers import RansacOptions

from torch_sfm_cases import one_torch_thread  # noqa: F401

jrh = importlib.import_module("theiasfm_tpu.sfm.pose.radial_homography")
trh = importlib.import_module("theiasfm_tpu_torch.sfm.pose.radial_homography")
T = torch.from_numpy


def _jax_solve(x1, x2):
    m, v = jax.vmap(jrh.six_point_radial_distortion_homography)(
        jnp.asarray(x1), jnp.asarray(x2))
    flat = np.concatenate([np.asarray(m["H"]).reshape(v.shape + (9,)),
                           np.asarray(m["l1"])[..., None],
                           np.asarray(m["l2"])[..., None]], -1)
    return flat, np.asarray(v)


def test_six_point_matches_jax():
    x, truth = sp.minimal_problems("radial_homography", 0, 24)
    jm, jv = _jax_solve(x["x1"], x["x2"])
    tm, tv = trh.six_point_radial_distortion_homography(T(x["x1"]),
                                                        T(x["x2"]))
    np.testing.assert_array_equal(tv.numpy(), jv)
    # polishes that stop short of a root amplify rounding to ~1e-8
    np.testing.assert_allclose(tm.numpy(), jm, rtol=0, atol=1e-7)
    hits = sp.minimal_hits("radial_homography", (tm, tv), truth)
    assert hits.mean() >= 0.6


def test_undistort_and_symmetric_error_match_jax():
    rng = np.random.default_rng(1)
    x1 = rng.uniform(-0.6, 0.6, size=(3, 40, 2))
    x2 = rng.uniform(-0.6, 0.6, size=(3, 40, 2))
    H = np.eye(3) + 0.2 * rng.normal(size=(3, 3, 3))
    l1, l2 = rng.uniform(-1, -0.1, 3), rng.uniform(-1, -0.1, 3)
    model = np.concatenate([H.reshape(3, 9), l1[:, None], l2[:, None]], -1)
    je = np.asarray(jax.vmap(jrh.radial_homography_symmetric_error_sq)(
        {"H": jnp.asarray(H), "l1": jnp.asarray(l1), "l2": jnp.asarray(l2)},
        jnp.asarray(x1), jnp.asarray(x2)))
    te = trh.radial_homography_symmetric_error_sq(T(model), T(x1), T(x2))
    np.testing.assert_allclose(te.numpy(), je, rtol=1e-10, atol=1e-14)
    y = rng.normal(size=(3, 40, 3))
    jd = np.asarray(jax.vmap(jrh.distort_division_homogeneous)(
        jnp.asarray(y), jnp.asarray(l1)))
    td = trh.distort_division_homogeneous(T(y), T(l1)[:, None])
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-12, atol=1e-12)


def test_polish_jacobian_matches_jacfwd():
    x, _ = sp.minimal_problems("radial_homography", 2, 3)
    rng = np.random.default_rng(3)
    p = np.concatenate([rng.normal(size=(3, 9)),
                        rng.uniform(-1, -0.1, (3, 2))], -1)
    r, J = trh._algebraic(T(p), T(x["x1"]), T(x["x2"]), True)
    for b in range(3):
        def res(q, b=b):
            return jrh._algebraic_residuals(
                q[:9], q[9], q[10], jnp.asarray(x["x1"][b]),
                jnp.asarray(x["x2"][b]))
        jJ = np.asarray(jax.jacfwd(res)(jnp.asarray(p[b])))
        np.testing.assert_allclose(r[b].numpy(), np.asarray(
            res(jnp.asarray(p[b]))), rtol=0, atol=1e-12)
        np.testing.assert_allclose(J[b].numpy(), jJ, rtol=1e-10,
                                   atol=1e-10)


@pytest.mark.parametrize("n", [200, 256])
def test_estimator_with_jax_indices_matches_jax(n):
    p = sp.radial_pairs(np.random.default_rng(4), 1, n, noise=1e-4,
                        outliers=0.2)
    x1, x2 = p["x1"][0], p["x2"][0]
    key = jax.random.PRNGKey(n)
    H, thresh = 48, 1e-5
    ref = jte.estimate_radial_distortion_homography(
        key, jnp.asarray(x1), jnp.asarray(x2),
        JRansacOptions(error_thresh=thresh, num_hypotheses=H))
    b = 256
    mask = np.arange(b) < n
    idx = T(np.array(jrs(key, b, 6, H, jnp.asarray(mask))))
    out = tte.estimate_radial_distortion_homography(
        idx, T(x1), T(x2), RansacOptions(error_thresh=thresh,
                                         num_hypotheses=H))
    np.testing.assert_array_equal(out["inliers"].numpy(),
                                  np.asarray(ref["inliers"]))
    assert int(out["num_inliers"]) == int(ref["num_inliers"]) >= 0.7 * n
    np.testing.assert_allclose(out["H"].numpy(), np.asarray(ref["H"]),
                               rtol=0, atol=1e-8)
    for k in ("l1", "l2"):
        np.testing.assert_allclose(float(out[k]), float(ref[k]), atol=1e-8)
    assert abs(float(out["l1"]) - p["l1"][0]) < 1e-2


def test_float32_share_holds_to_jax():
    x, truth = sp.minimal_problems("radial_homography", 5, 48)
    jm, jv = _jax_solve(x["x1"].astype(np.float32),
                        x["x2"].astype(np.float32))
    jhit = sp.minimal_hits("radial_homography",
                           (T(jm.astype(np.float64)), T(jv)), truth)
    thit = sp.minimal_hits("radial_homography", sp.run_minimal(
        "radial_homography", x, torch.float32, "cpu"), truth)
    assert thit.mean() >= jhit.mean() - 0.1, (thit.mean(), jhit.mean())
