"""The port's P3P solver and calibrated absolute-pose estimator against
the JAX package's, in float64 on the CPU.

P3P on 64 seeded problems: every problem has the same valid-solution
mask in both packages, the valid solutions agree to 1e-7, and both
recover the true pose (to 1e-6) on every problem. The GN refinement
agrees with JAX's to 1e-9 from perturbed starts; the RANSAC estimator,
given JAX's sample indices, returns the same inlier set and the same
pose to 1e-8."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theiasfm_tpu.sfm.estimators import absolute_pose as jap
from theiasfm_tpu.sfm.pose.p3p import p3p_grunert as jp3p
from theiasfm_tpu.solvers import RansacOptions as JRansacOptions
from theiasfm_tpu.solvers.ransac import random_samples as jrs
from theiasfm_tpu_torch.sfm.estimators import absolute_pose as tap
from theiasfm_tpu_torch.sfm.pose.p3p import p3p_grunert as tp3p
from theiasfm_tpu_torch.solvers import RansacOptions

import torch_sfm_cases as cases
from torch_sfm_cases import one_torch_thread  # noqa: F401


def _problem(rng, n):
    """A random camera looking at n points 3-7 units ahead: (world (n,
    3), normalized image coords (n, 2), true extrinsics (6,))."""
    aa = rng.normal(size=3) * 0.4
    c = rng.normal(size=3)
    R = cases.rotation(aa)
    pc = rng.uniform([-1.5, -1.5, 3], [1.5, 1.5, 7], size=(n, 3))
    world = pc @ R + c
    return world, pc[:, :2] / pc[:, 2:], np.concatenate([c, aa])


def test_p3p_matches_jax():
    rng = np.random.default_rng(0)
    W, I, G = map(np.stack, zip(*[_problem(rng, 3) for _ in range(64)]))
    je, jv = map(np.asarray, jax.vmap(jp3p)(jnp.asarray(W), jnp.asarray(I)))
    te, tv = tp3p(torch.from_numpy(W), torch.from_numpy(I))
    te, tv = te.numpy(), tv.numpy()
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(te[tv], je[jv], rtol=0, atol=1e-7)

    def recovered(e, v):
        return int(sum(np.any(v[i] & (np.abs(e[i] - G[i]).max(-1) < 1e-6))
                       for i in range(64)))
    assert recovered(je, jv) == 64
    assert recovered(te, tv) == 64


def _noisy(rng, n=100, n_out=30, noise=1e-3):
    world, img, gt = _problem(rng, n)
    img = img + rng.normal(scale=noise, size=img.shape)
    img[:n_out] = rng.uniform(-0.4, 0.4, size=(n_out, 2))
    return world, img, gt


def test_refine_absolute_pose_gn_matches_jax():
    rng = np.random.default_rng(1)
    cases_ = [_noisy(rng) for _ in range(4)]
    W = np.stack([c[0] for c in cases_])
    I = np.stack([c[1] for c in cases_])
    G = np.stack([c[2] for c in cases_])
    start = G + rng.normal(scale=0.02, size=G.shape)
    w = (rng.random(W.shape[:2]) > 0.3).astype(float)
    w[:, :30] = 0.0
    ref = np.stack([np.asarray(jap.refine_absolute_pose_gn(
        jnp.asarray(start[b]), jnp.asarray(W[b]), jnp.asarray(I[b]),
        jnp.asarray(w[b]))) for b in range(4)])
    out = tap.refine_absolute_pose_gn(*(torch.from_numpy(x) for x in
                                        (start, W, I, w))).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-9)
    assert np.abs(out - G).max() < 2e-2


@pytest.mark.parametrize("n", [100, 64])
def test_estimate_calibrated_absolute_pose_matches_jax(n):
    """With the indices JAX draws over the padded data (bucket of 64)."""
    rng = np.random.default_rng(2)
    world, img, gt = _noisy(rng, n=n)
    key = jax.random.PRNGKey(n)
    H, thresh = 128, (3e-3) ** 2
    ref = jap.estimate_calibrated_absolute_pose(
        key, jnp.asarray(world), jnp.asarray(img),
        JRansacOptions(error_thresh=thresh, num_hypotheses=H))
    b = 128 if n > 64 else 64
    mask = np.arange(b) < n
    idx = torch.from_numpy(np.array(jrs(key, b, 3, H, jnp.asarray(mask))))
    out = tap.estimate_calibrated_absolute_pose(
        idx, torch.from_numpy(world), torch.from_numpy(img),
        RansacOptions(error_thresh=thresh, num_hypotheses=H))
    np.testing.assert_array_equal(out["inliers"].numpy(),
                                  np.asarray(ref["inliers"]))
    assert int(out["num_inliers"]) == int(ref["num_inliers"]) >= \
        0.75 * (n - 30)
    np.testing.assert_allclose(out["extrinsics"].numpy(),
                               np.asarray(ref["extrinsics"]), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(float(out["confidence"]),
                               float(ref["confidence"]), atol=1e-12)
    assert np.abs(out["extrinsics"].numpy() - gt).max() < 2e-2
