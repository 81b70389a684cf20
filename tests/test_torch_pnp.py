"""The port's UPnP, DLS-PnP, gDLS and PnP-with-focal-and-radial solvers
against the JAX package's, in float64 on the CPU, on the numpy-seeded
problems of theiasfm_tpu_torch/solver_problems.py.

UPnP, DLS and gDLS share the multistart damped Newton on unit
quaternions. Where JAX differentiates the cost with jax.grad and
jax.hessian, the port evaluates cost, gradient and Hessian in closed
form from the residuals' affine form in vec(R); those agree with JAX's
autodiff to 1e-10. The solvers' poses agree with JAX's to 1e-6 (the
lockstep descent keeps a step only where the cost drops, and costs
within rounding of each other may keep different last steps) and both
recover the truth on every exact problem. P4Pfr and P5Pfr (a (k, f)
grid of P3P solves, a stable argsort and a 15/20-step polish) agree
with JAX to 1e-7 relative, and their closed-form polish jacobian
equals jax.jacfwd of the JAX residual to 1e-10.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theiasfm_tpu.math import rotation as jrot
from theiasfm_tpu_torch import solver_problems as sp
from theiasfm_tpu_torch.math import rotation as trot

from torch_sfm_cases import one_torch_thread  # noqa: F401

jup = importlib.import_module("theiasfm_tpu.sfm.pose.upnp")
jgd = importlib.import_module("theiasfm_tpu.sfm.pose.gdls")
jfr = importlib.import_module("theiasfm_tpu.sfm.pose.pnp_focal_radial")
tup = importlib.import_module("theiasfm_tpu_torch.sfm.pose.upnp")
tgd = importlib.import_module("theiasfm_tpu_torch.sfm.pose.gdls")
tfr = importlib.import_module("theiasfm_tpu_torch.sfm.pose.pnp_focal_radial")

T = torch.from_numpy


def test_so3_covering_matches_jax():
    np.testing.assert_array_equal(tup.so3_covering_quats(),
                                  jup.so3_covering_quats())


@pytest.mark.parametrize("which", ["upnp", "gdls"])
def test_multistart_derivatives_match_autodiff(which):
    """Cost, gradient and Hessian of the tangent-space cost
    cost(q (x) [1, d/2]) at d = 0, closed form against jax.grad and
    jax.hessian of the JAX module's cost."""
    rng = np.random.default_rng(0)
    if which == "upnp":
        p = sp.generalized_pose(rng, 4, 7)
        args = (p["origins"], p["dirs"], p["world"])
        _, _, B, Q = tup.upnp_cost_matrix(*map(T, args))
    else:
        p = sp.generalized_similarity(rng, 4, 7, noise=0.01)
        args = (p["origin"], p["dir"], p["point"])
        _, _, B, Q = tgd.gdls_cost_matrix(*map(T, args))
    q = rng.normal(size=(4, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    c, g, H = tup._cost_grad_hess(B, Q, trot.quaternion_to_rotation_matrix(
        T(q)))
    for b in range(4):
        a = tuple(jnp.asarray(x[b]) for x in args)
        cost_of_R = (jup.upnp_cost_matrix(*a)[1] if which == "upnp"
                     else jgd.gdls_cost_matrix(*a)[1])

        def local(d, qb=jnp.asarray(q[b])):
            dq = jnp.concatenate([jnp.ones(1), 0.5 * d])
            qn = jrot.quaternion_multiply(qb, dq)
            qn = qn / jnp.linalg.norm(qn)
            return cost_of_R(jrot.quaternion_to_rotation_matrix(qn))[0]

        z = jnp.zeros(3)
        scale = max(1.0, abs(float(local(z))))
        assert abs(float(local(z)) - float(c[b])) < 1e-10 * scale
        np.testing.assert_allclose(g[b].numpy(), np.asarray(
            jax.grad(local)(z)), rtol=0, atol=1e-10 * scale)
        np.testing.assert_allclose(H[b].numpy(), np.asarray(
            jax.hessian(local)(z)), rtol=0, atol=1e-10 * scale)


def test_upnp_and_dls_match_jax():
    x, truth = sp.minimal_problems("upnp", 1, 12)
    tR, tt, tc = tup.upnp(T(x["origins"]), T(x["dirs"]), T(x["world"]))
    jR, jt, jc = map(np.asarray, jax.vmap(jup.upnp)(
        jnp.asarray(x["origins"]), jnp.asarray(x["dirs"]),
        jnp.asarray(x["world"])))
    np.testing.assert_allclose(tR.numpy(), jR, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), jt, rtol=0, atol=1e-6)
    assert sp.minimal_hits("upnp", (tR, tt, tc), truth).all()

    # DLS: the central case from normalized image points
    p = sp.absolute_pose(np.random.default_rng(2), 12, 6)
    Rt = sp.rotation(p["extrinsics"][:, 3:])
    tR, tt, _ = tup.dls_pnp(T(p["image"]), T(p["world"]))
    jR, jt, _ = map(np.asarray, jax.vmap(jup.dls_pnp)(
        jnp.asarray(p["image"]), jnp.asarray(p["world"])))
    np.testing.assert_allclose(tR.numpy(), jR, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), jt, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tR.numpy(), Rt, rtol=0, atol=1e-6)


def test_gdls_matches_jax():
    x, truth = sp.minimal_problems("gdls", 3, 12)
    tR, tt, ts, tc = tgd.gdls_similarity_transform(
        T(x["origin"]), T(x["dir"]), T(x["point"]))
    jR, jt, js, jc = map(np.asarray, jax.vmap(
        jgd.gdls_similarity_transform)(jnp.asarray(x["origin"]),
                                       jnp.asarray(x["dir"]),
                                       jnp.asarray(x["point"])))
    np.testing.assert_allclose(tR.numpy(), jR, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), js, rtol=0, atol=1e-6)
    assert sp.minimal_hits("gdls", (tR, tt, ts, tc), truth).all()


@pytest.mark.parametrize("n,num_radial", [(4, 1), (5, 2)])
def test_pnp_focal_radial_matches_jax(n, num_radial):
    p = sp.absolute_pose(np.random.default_rng(4 + n), 6, n,
                         focal=(500, 1200), distortion=(-0.5, -0.05))
    if n == 4:
        j = jax.vmap(jfr.four_point_focal_length_radial_distortion)
        tm, tv = tfr.four_point_focal_length_radial_distortion(
            T(p["world"]), T(p["image"]))
    else:
        j = jax.vmap(lambda w, i: jfr.five_point_focal_length_radial_distortion(
            w, i, num_radial=num_radial))
        tm, tv = tfr.five_point_focal_length_radial_distortion(
            T(p["world"]), T(p["image"]), num_radial=num_radial)
    jm, jv = map(np.asarray, j(jnp.asarray(p["world"]),
                               jnp.asarray(p["image"])))
    np.testing.assert_array_equal(tv.numpy(), jv)
    scale = np.maximum(np.abs(jm[..., :7]), 1.0)
    assert np.max(np.abs(tm.numpy()[..., :7] - jm[..., :7])[jv] /
                  scale[jv]) < 1e-7
    # distortion coefficients ~1e-7: relative to the first one's size
    kscale = np.abs(jm[..., 7:8]).max()
    assert np.max(np.abs(tm.numpy()[..., 7:] - jm[..., 7:])[jv]) < \
        1e-7 * kscale


def test_pnp_focal_radial_polish_jacobian_matches_jacfwd():
    """The closed-form jacobian of the (pose, focal, k1, k2) polish
    residual against jax.jacfwd of the JAX module's residual
    (pnp_focal_radial.py:113-124)."""
    p = sp.absolute_pose(np.random.default_rng(9), 3, 5, focal=(500, 900),
                         distortion=(-0.4, -0.1))
    rng = np.random.default_rng(10)
    par = np.concatenate([rng.normal(size=(3, 6)) * 0.5,
                          rng.uniform(500, 900, (3, 1)),
                          rng.normal(size=(3, 2)) * 1e-7], -1)
    nr = 2

    def residual(q, world, image_px):
        r2 = jnp.sum(image_px ** 2, axis=-1)
        pc = jrot.angle_axis_rotate_point(
            jnp.broadcast_to(q[3:6], world.shape), world - q[0:3])
        z = jnp.maximum(pc[:, 2], 1e-6)
        proj = pc[:, :2] / z[:, None] * q[6]
        w = jnp.ones_like(r2)
        rpow = r2
        for j in range(nr):
            w = w + q[7 + j] * rpow
            rpow = rpow * r2
        return (proj - image_px / w[:, None]).reshape(-1)

    seen = {}

    def fake_gn(res_jac, p0, iters, damping):
        seen["rj"] = res_jac(p0, True)
        return p0

    orig = tfr.gauss_newton
    tfr.gauss_newton = fake_gn
    try:
        tfr._polish(T(p["world"]), T(p["image"]), T(par), nr, 1)
    finally:
        tfr.gauss_newton = orig
    r, J = seen["rj"]
    for b in range(3):
        args = (jnp.asarray(par[b]), jnp.asarray(p["world"][b]),
                jnp.asarray(p["image"][b]))
        np.testing.assert_allclose(r[b].numpy(), np.asarray(
            residual(*args)), rtol=0, atol=1e-9)
        jJ = np.asarray(jax.jacfwd(residual)(*args))
        np.testing.assert_allclose(J[b].numpy(), jJ, rtol=1e-10,
                                   atol=1e-10 * np.abs(jJ).max())
