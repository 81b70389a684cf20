"""Inputs and checks shared by the verification tests
(tests/test_torch_verification*.py): synthetic calibrated pairs, the
sample indices JAX's verify_matches_batch draws from a key, and the
comparison of two lists of TwoViewInfo."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from theiasfm_tpu.math import rotation as jrot
from theiasfm_tpu.solvers.ransac import random_samples as jrs
from theiasfm_tpu_torch.sfm.pipeline import geometric_verification as tgv

H = 64
F64 = torch.float64
PP = (320.0, 240.0)


def pair(rng, n_pts=150, n_out=40, noise=0.4, focal=600.0):
    aa = np.array([0.1, -0.15, 0.08])
    t = np.array([1.0, 0.2, -0.1])
    R = np.asarray(jrot.angle_axis_to_rotation_matrix(jnp.asarray(aa)))
    pts = rng.uniform([-2, -2, 4], [2, 2, 10], size=(n_pts, 3))
    p2 = pts @ R.T + t
    pix1 = pts[:, :2] / pts[:, 2:] * focal + PP
    pix2 = p2[:, :2] / p2[:, 2:] * focal + PP
    pix1 += rng.normal(scale=noise, size=pix1.shape)
    pix1 = np.concatenate([pix1, rng.uniform(0, 640, (n_out, 2))])
    pix2 = np.concatenate([pix2, rng.uniform(0, 640, (n_out, 2))])
    return pix1, pix2, aa


def jax_batch_samples(key, mask, num_hypotheses=H):
    """The indices JAX's verify_matches_batch draws from `key`."""
    P, N = mask.shape
    ie, ih = [], []
    for p, k in enumerate(jax.random.split(key, P)):
        k1, k2 = jax.random.split(k)
        m = jnp.asarray(mask[p])
        ie.append(np.array(jrs(k1, N, 5, num_hypotheses, m)))
        ih.append(np.array(jrs(k2, N, 4, num_hypotheses, m)))
    return tgv.VerificationSamples(torch.from_numpy(np.stack(ie)),
                                   torch.from_numpy(np.stack(ih)))


def assert_same_infos(ji, ti, jc=None, tc=None):
    assert [i is None for i in ji] == [i is None for i in ti]
    for p, (a, b) in enumerate(zip(ji, ti)):
        if a is None:
            continue
        assert b.num_verified_matches == a.num_verified_matches, p
        assert b.num_homography_inliers == a.num_homography_inliers, p
        assert b.visibility_score == a.visibility_score, p
        np.testing.assert_allclose(b.rotation_2, a.rotation_2, atol=1e-6)
        np.testing.assert_allclose(b.position_2, a.position_2, atol=1e-6)
        if jc is not None:
            np.testing.assert_allclose(tc[p], jc[p], atol=1e-9)


def batch(rng):
    """Four pairs: two scenes, a garbage pair (uncorrelated points)
    and an all-padding pair."""
    P, N = 4, 256
    pix1, pix2 = np.zeros((P, N, 2)), np.zeros((P, N, 2))
    mask = np.zeros((P, N), bool)
    for p in range(2):
        a, b, _ = pair(rng)
        pix1[p, :len(a)], pix2[p, :len(a)], mask[p, :len(a)] = a, b, True
    pix1[2, :100] = rng.uniform(0, 640, (100, 2))
    pix2[2, :100] = rng.uniform(0, 640, (100, 2))
    mask[2, :100] = True
    f = np.full(P, 600.0)
    pps = np.tile(PP, (P, 1))
    sizes = np.array([[[640, 480], [640, 480]]] * 3 + [[[0, 0], [0, 0]]],
                     float)
    return pix1, pix2, mask, f, pps, sizes
