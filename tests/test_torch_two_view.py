"""The port's two-view refinements (theiasfm_tpu_torch/sfm/ba/two_view.py)
against the JAX package's, on batched inputs made with numpy.

The JAX functions solve one problem each and are vmapped here; the port
takes the batch as leading dims. Both run the same fixed-iteration
Gauss–Newton in float64. The residuals normalize t, so each normal
matrix is singular along t and only its tiny damping (1e-12, 1e-10)
makes it invertible: the two solves' rounding differences grow to about
5e-8 there, hence 1e-6."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from theiasfm_tpu.math import rotation as jrot
from theiasfm_tpu.sfm.ba import two_view as jtv
from theiasfm_tpu_torch.sfm.ba import two_view as ttv

TOL = 1e-6


def _pairs(rng, B, N, noise):
    """B relative poses (small rotation, unit baseline) and N normalized
    correspondences each, with pixel-like noise and random weights."""
    aa = rng.normal(scale=0.1, size=(B, 3))
    t = rng.normal(size=(B, 3))
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    X = rng.uniform(-1, 1, (B, N, 3)) + np.array([0, 0, 5.0])
    R = np.asarray(jrot.angle_axis_to_rotation_matrix(jnp.asarray(aa)))
    X2 = np.einsum("bij,bnj->bni", R, X) + t[:, None]
    x1 = X[..., :2] / X[..., 2:]
    x2 = X2[..., :2] / X2[..., 2:]
    x1 = x1 + rng.normal(scale=noise, size=x1.shape)
    x2 = x2 + rng.normal(scale=noise, size=x2.shape)
    w = rng.uniform(0.5, 1.5, (B, N))
    return aa, t, x1, x2, w, R


@pytest.mark.parametrize("batch", [(5,), (2, 3)])
def test_two_views_angular_matches_jax(batch):
    rng = np.random.default_rng(3)
    B = int(np.prod(batch))
    aa, t, x1, x2, w, _ = _pairs(rng, B, 40, 1e-3)
    aa0 = aa + rng.normal(scale=0.02, size=aa.shape)
    t0 = t + rng.normal(scale=0.05, size=t.shape)
    aj, tj = jax.vmap(jtv.bundle_adjust_two_views_angular)(
        *(jnp.asarray(x) for x in (aa0, t0, x1, x2, w)))
    shape = lambda x: torch.tensor(x).reshape(batch + x.shape[1:])  # noqa
    at, tt = ttv.bundle_adjust_two_views_angular(
        *(shape(x) for x in (aa0, t0, x1, x2, w)))
    assert at.shape == batch + (3,) and tt.shape == batch + (3,)
    np.testing.assert_allclose(at.reshape(B, 3).numpy(), np.asarray(aj),
                               atol=TOL)
    np.testing.assert_allclose(tt.reshape(B, 3).numpy(), np.asarray(tj),
                               atol=TOL)


@pytest.mark.parametrize("iters", [1, 12])
def test_relative_position_known_rotation_matches_jax(iters):
    rng = np.random.default_rng(5)
    B = 4
    _, _, x1, x2, w, R = _pairs(rng, B, 30, 1e-3)
    R1 = np.asarray(jrot.angle_axis_to_rotation_matrix(
        jnp.asarray(rng.normal(scale=0.2, size=(B, 3)))))
    R2 = np.einsum("bij,bjk->bik", R, R1)
    pos0 = rng.normal(size=(B, 3))
    pj = jax.vmap(lambda *a: jtv.optimize_relative_position_with_known_rotation(
        *a, iters=iters))(*(jnp.asarray(x) for x in (pos0, R1, R2, x1, x2,
                                                    w)))
    pt = ttv.optimize_relative_position_with_known_rotation(
        *(torch.tensor(x) for x in (pos0, R1, R2, x1, x2, w)), iters=iters)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(pt.numpy(), axis=1), 1.0,
                               atol=1e-12)
