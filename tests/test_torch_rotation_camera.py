"""The port's rotation, camera, loss and padding helpers against the JAX
package on the same random f64 inputs."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from theiasfm_tpu.camera import models as jcm
from theiasfm_tpu.math import rotation as jrot
from theiasfm_tpu.sfm.ba import bundle_adjustment as jba
from theiasfm_tpu.sfm.ba.losses import robust_weight as j_robust_weight
from theiasfm_tpu.utils import padding as jpad
from theiasfm_tpu_torch.camera import models as tcm
from theiasfm_tpu_torch.math import rotation as trot
from theiasfm_tpu_torch.sfm.ba import bundle_adjustment as tba
from theiasfm_tpu_torch.sfm.ba.losses import LOSSES
from theiasfm_tpu_torch.sfm.ba.losses import robust_weight as t_robust_weight
from theiasfm_tpu_torch.utils import padding as tpad

ATOL = 1e-10


def _aa_samples(rng, n=64):
    """Angle-axis vectors at generic angles, near 0 (incl. exactly 0,
    below and above the 1e-6 Taylor switch) and near pi."""
    axes = rng.normal(size=(n, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    ang = np.concatenate([
        rng.uniform(0.0, np.pi, n // 4),
        [0.0, 1e-9, 5e-7, 2e-6, 1e-5] + [0.0] * (n // 4 - 5),
        np.pi - rng.uniform(1e-4, 1e-2, n // 4),
        rng.uniform(2.5, np.pi - 1e-3, n - 3 * (n // 4)),
    ])
    return axes * ang[:, None]


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def test_rotation_functions_match():
    rng = np.random.default_rng(0)
    aa = _aa_samples(rng)
    pt = rng.normal(size=aa.shape) * 5.0
    R_j = jrot.angle_axis_to_rotation_matrix(jnp.asarray(aa))
    R_t = trot.angle_axis_to_rotation_matrix(torch.tensor(aa))
    np.testing.assert_allclose(_np(R_t), _np(R_j), atol=ATOL)
    np.testing.assert_allclose(
        _np(trot.angle_axis_rotate_point(torch.tensor(aa), torch.tensor(pt))),
        _np(jrot.angle_axis_rotate_point(jnp.asarray(aa), jnp.asarray(pt))),
        atol=ATOL)
    R = _np(R_j)
    q_j = jrot.rotation_matrix_to_quaternion(jnp.asarray(R))
    q_t = trot.rotation_matrix_to_quaternion(torch.tensor(R))
    np.testing.assert_allclose(_np(q_t), _np(q_j), atol=ATOL)
    np.testing.assert_allclose(
        _np(trot.quaternion_to_angle_axis(torch.tensor(_np(q_j)))),
        _np(jrot.quaternion_to_angle_axis(q_j)), atol=ATOL)
    aa_back = _np(trot.rotation_matrix_to_angle_axis(torch.tensor(R)))
    np.testing.assert_allclose(
        aa_back, _np(jrot.rotation_matrix_to_angle_axis(jnp.asarray(R))),
        atol=ATOL)
    # and the round trip recovers the rotation
    np.testing.assert_allclose(
        _np(trot.angle_axis_to_rotation_matrix(torch.tensor(aa_back))), R,
        atol=1e-9)


def _intrinsics(rng, model, n):
    intr = np.zeros((n, 10))
    intr[:, 0] = rng.uniform(400, 1200, n)
    intr[:, 1] = rng.uniform(0.9, 1.1, n)
    intr[:, 2] = rng.uniform(-0.5, 0.5, n)
    intr[:, 3] = rng.uniform(200, 600, n)
    intr[:, 4] = rng.uniform(200, 500, n)
    M = jcm.CameraModelType
    if model == M.PINHOLE:
        intr[:, 5:7] = rng.uniform(-0.1, 0.1, (n, 2))
    elif model == M.PINHOLE_RADIAL_TANGENTIAL:
        intr[:, 5:8] = rng.uniform(-0.1, 0.1, (n, 3))
        intr[:, 8:10] = rng.uniform(-0.01, 0.01, (n, 2))
    elif model == M.FISHEYE:
        intr[:, 5:9] = rng.uniform(-0.05, 0.05, (n, 4))
    elif model == M.FOV:
        intr[:, 5] = rng.uniform(0.3, 1.2, n)
    else:
        intr[:, 5] = rng.uniform(-0.2, 0.2, n)
    return intr


MODELS = [int(m) for m in jcm.CameraModelType if m >= 0]


@pytest.mark.parametrize("model", MODELS)
def test_project_matches(model):
    rng = np.random.default_rng(model)
    n = 128
    extr = np.concatenate([rng.normal(size=(n, 3)),
                           rng.normal(scale=0.3, size=(n, 3))], axis=1)
    intr = _intrinsics(rng, model, n)
    # points in front of each camera: X = c + R^T [x, y, z], z in [2, 10]
    R = _np(jrot.angle_axis_to_rotation_matrix(jnp.asarray(extr[:, 3:])))
    pc = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                   rng.uniform(2, 10, n)], axis=1)
    pts = extr[:, :3] + np.einsum("nji,nj->ni", R, pc)
    pix_j, dep_j = jcm.project(model, jnp.asarray(extr), jnp.asarray(intr),
                               jnp.asarray(pts))
    pix_t, dep_t = tcm.project(model, torch.tensor(extr), torch.tensor(intr),
                               torch.tensor(pts))
    np.testing.assert_allclose(_np(dep_t), _np(dep_j), atol=ATOL)
    np.testing.assert_allclose(_np(pix_t), _np(pix_j), atol=ATOL)
    assert np.all(_np(dep_t) > 1.0)


@pytest.mark.parametrize("model", MODELS)
def test_residual_jacobians_match(model):
    """The per-observation jacobians (vmap(jacrev) in the port, jax.vmap
    of jax.jacrev in the reference) for every camera model."""
    rng = np.random.default_rng(10 + model)
    n = 64
    extr = np.concatenate([rng.normal(size=(n, 3)),
                           rng.normal(scale=0.3, size=(n, 3))], axis=1)
    intr = _intrinsics(rng, model, n)
    R = _np(jrot.angle_axis_to_rotation_matrix(jnp.asarray(extr[:, 3:])))
    pc = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                   rng.uniform(2, 10, n)], axis=1)
    pts = extr[:, :3] + np.einsum("nji,nj->ni", R, pc)
    pix = rng.normal(size=(n, 2)) * 300 + 400
    w = rng.uniform(0.5, 1.0, n)
    fields = dict(extrinsics=extr, intrinsics=intr, points=pts,
                  obs_cam=np.arange(n, dtype=np.int32),
                  obs_group=np.arange(n, dtype=np.int32),
                  obs_pt=np.arange(n, dtype=np.int32), obs_pix=pix,
                  obs_mask=np.ones(n, bool))
    pj = jba.BAProblem(**{k: jnp.asarray(v) for k, v in fields.items()})
    pt = tba.BAProblem(**{k: torch.tensor(v) for k, v in fields.items()})
    out_j = jba._all_jacobians(model, pj, jnp.asarray(w))
    out_t = tba._all_jacobians(model, pt, torch.tensor(w))
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("loss", LOSSES)
def test_robust_weight_matches(loss):
    rng = np.random.default_rng(1)
    scale = 2.0
    s = np.concatenate([[0.0, scale ** 2, 1e-40],
                        rng.uniform(0, 10 * scale ** 2, 200)])
    np.testing.assert_allclose(
        _np(t_robust_weight(loss, torch.tensor(s), scale)),
        _np(j_robust_weight(loss, jnp.asarray(s), scale)), atol=ATOL)


def test_robust_weight_unknown_loss():
    with pytest.raises(ValueError):
        t_robust_weight("nope", torch.zeros(3), 1.0)


@pytest.mark.parametrize("n,minimum", [(0, 8), (1, 8), (8, 8), (9, 8),
                                       (1000, 64), (4097, 256), (3, 1)])
def test_next_bucket_matches(n, minimum):
    assert tpad.next_bucket(n, minimum) == jpad.next_bucket(n, minimum)


def test_pad_to_matches():
    a = np.arange(12.0).reshape(4, 3)
    for axis, size in ((0, 7), (1, 5)):
        pt, mt = tpad.pad_to(a, size, axis=axis, fill=-1)
        pj, mj = jpad.pad_to(a, size, axis=axis, fill=-1)
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_array_equal(mt, mj)
    with pytest.raises(ValueError):
        tpad.pad_to(a, 2)


def test_jax_x64_enabled():
    # the comparisons above are f64 on both sides
    assert jax.config.jax_enable_x64
