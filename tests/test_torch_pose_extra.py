"""The port's seven-point, focal-from-F, known-rotation, DLT, EPnP and
P4Pf solvers against the JAX package's, in float64 on the CPU, on the
numpy-seeded problems of theiasfm_tpu_torch/solver_problems.py.

Closed forms (known rotation, DLT and its RQ decomposition, EPnP) agree
to 1e-8; the focal lengths from F to 1e-5 relative (each epipole is an
eigenvector of F^T F, of condition some 1e12 at pixel scale). The seven-point solver finds its
roots with 60 Aberth iterations, so it is held by solution-set
membership: every valid JAX solution is matched by a valid port
solution within 1e-8 (up to sign), the valid counts agree, and both
recover the true F (relative 1e-3) on every problem. P4Pf (a focal
sweep of P3P solves, ranked by a stable argsort, and a 15-step
Gauss-Newton polish) agrees to 1e-7 relative; its closed-form polish
jacobian equals jax.jacfwd of the JAX residual to 1e-10. In float32 the
share of problems each solver solves on the CPU is held to no less than
JAX's float32 share on the same problems less a stated margin.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theiasfm_tpu.math import rotation as jrot
from theiasfm_tpu.sfm.pose import dlt_pnp as jdlt
from theiasfm_tpu.sfm.pose import epnp as jepnp
from theiasfm_tpu.sfm.pose import focal_from_fundamental as jff
from theiasfm_tpu.sfm.pose import known_rotation as jkr
from theiasfm_tpu.sfm.pose import p4pf as jp4pf
from theiasfm_tpu.sfm.pose import seven_point as jsp
from theiasfm_tpu_torch import solver_problems as sp
from theiasfm_tpu_torch.sfm.pose import _polish
from theiasfm_tpu_torch.sfm.pose import dlt_pnp as tdlt
from theiasfm_tpu_torch.sfm.pose import epnp as tepnp
from theiasfm_tpu_torch.sfm.pose import focal_from_fundamental as tff
from theiasfm_tpu_torch.sfm.pose import known_rotation as tkr
from theiasfm_tpu_torch.sfm.pose import p4pf as tp4pf
from theiasfm_tpu_torch.sfm.pose import seven_point as tsp

from torch_sfm_cases import one_torch_thread  # noqa: F401

T = torch.from_numpy


def _np(x):
    return np.asarray(x)


def test_focal_from_fundamental_matches_jax():
    x, truth = sp.minimal_problems("focal_from_fundamental", 0, 32)
    z = np.zeros((32, 2))
    jf1, jf2, jv = map(_np, jax.vmap(jff.focal_lengths_from_fundamental)(
        jnp.asarray(x["F"]), jnp.asarray(z), jnp.asarray(z)))
    tf1, tf2, tv = tff.focal_lengths_from_fundamental(T(x["F"]), T(z), T(z))
    np.testing.assert_array_equal(tv.numpy(), jv)
    # the epipoles come from eigh of F^T F, whose condition number is
    # some f^4 ~ 1e12 for pixel-scale F: the two packages' eigensolvers
    # agree to a few 1e-6 relative there
    np.testing.assert_allclose(tf1.numpy(), jf1, rtol=1e-5)
    np.testing.assert_allclose(tf2.numpy(), jf2, rtol=1e-5)
    out = (tf1, tf2, tv)
    assert sp.minimal_hits("focal_from_fundamental", out, truth).all()


def test_known_rotation_matches_jax():
    x, truth = sp.minimal_problems("known_rotation", 1, 64)
    jt, jv = map(_np, jax.vmap(
        jkr.relative_pose_from_two_points_with_known_rotation)(
        *(jnp.asarray(x[k]) for k in ("x1", "x2", "R"))))
    tt, tv = tkr.relative_pose_from_two_points_with_known_rotation(
        *(T(x[k]) for k in ("x1", "x2", "R")))
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_allclose(tt.numpy(), jt, rtol=0, atol=1e-12)
    assert sp.minimal_hits("known_rotation", (tt, tv), truth).all()


def test_seven_point_solution_sets_match_jax():
    """Root finder: JAX's valid solutions are a subset of the port's
    (within 1e-8 up to sign) on every problem, and the valid counts
    agree on every problem."""
    x, truth = sp.minimal_problems("seven_point", 2, 64)
    jF, jv = map(_np, jax.vmap(jsp.seven_point_fundamental)(
        jnp.asarray(x["x1"]), jnp.asarray(x["x2"])))
    tF, tv = tsp.seven_point_fundamental(T(x["x1"]), T(x["x2"]))
    tF, tv = tF.numpy().reshape(64, 3, 9), tv.numpy()
    jF = jF.reshape(64, 3, 9)
    np.testing.assert_array_equal(tv.sum(-1), jv.sum(-1))
    for b in range(64):
        for s in np.nonzero(jv[b])[0]:
            d = np.minimum(np.abs(tF[b] - jF[b, s]).max(-1),
                           np.abs(tF[b] + jF[b, s]).max(-1))
            assert np.any(tv[b] & (d < 1e-8)), (b, s, d)
    assert sp.minimal_hits("seven_point", (T(tF.reshape(64, 3, 3, 3)),
                                           T(tv)), truth).all()


def test_dlt_pnp_and_decomposition_match_jax():
    """dlt_pnp (plain and weighted), the closed-form RQ against JAX's
    QR route, and six_point_pnp."""
    x, truth = sp.minimal_problems("dlt_pnp", 3, 32)
    W, I = x["world"], x["image"]
    jP, jok = map(_np, jax.vmap(jdlt.dlt_pnp)(jnp.asarray(W),
                                              jnp.asarray(I)))
    tP, tok = tdlt.dlt_pnp(T(W), T(I))
    assert tok.numpy().all() and jok.all()
    # the null vector's sign is the factorization's; compare up to sign
    sgn = np.sign(np.sum(tP.numpy() * jP, axis=(-2, -1)))
    np.testing.assert_allclose(tP.numpy() * sgn[:, None, None], jP,
                               rtol=0, atol=1e-8)
    jK, je = map(_np, jax.vmap(jdlt.decompose_projection_matrix)(
        jnp.asarray(jP)))
    tK, te = tdlt.decompose_projection_matrix(T(jP.copy()))
    # K's entries span the focal length (~1e3) down to a zero principal
    # point: 1e-10 relative to the focal length
    np.testing.assert_allclose(tK.numpy(), jK, rtol=0,
                               atol=1e-10 * np.abs(jK).max())
    np.testing.assert_allclose(te.numpy(), je, rtol=0, atol=1e-8)
    jm, jv = map(_np, jax.vmap(jdlt.six_point_pnp)(jnp.asarray(W),
                                                  jnp.asarray(I)))
    tm, tv = tdlt.six_point_pnp(T(W), T(I))
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_allclose(tm.numpy()[..., :8], jm[..., :8], rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_allclose(tm.numpy()[..., 8:], jm[..., 8:], rtol=0,
                               atol=1e-10 * np.abs(jm[..., 6]).max())
    assert sp.minimal_hits("dlt_pnp", (tm, tv), truth).all()

    # weighted, on 20 noisy points with 3 outliers weighted out
    p = sp.absolute_pose(np.random.default_rng(4), 4, 20, focal=(500, 900),
                         noise_px=0.3)
    w = np.ones((4, 20))
    p["image"][:, :3] += 40.0
    w[:, :3] = 0.0
    jP, _ = map(_np, jax.vmap(jdlt.dlt_pnp)(
        jnp.asarray(p["world"]), jnp.asarray(p["image"]), jnp.asarray(w)))
    tP, _ = tdlt.dlt_pnp(T(p["world"]), T(p["image"]), T(w))
    sgn = np.sign(np.sum(tP.numpy() * jP, axis=(-2, -1)))
    np.testing.assert_allclose(tP.numpy() * sgn[:, None, None], jP,
                               rtol=0, atol=1e-8)


@pytest.mark.parametrize("weighted", [False, True])
def test_epnp_matches_jax(weighted):
    x, truth = sp.minimal_problems("epnp", 5, 32)
    w = np.random.default_rng(6).uniform(0.5, 1.5, size=(32, 6)) \
        if weighted else None
    args = (x["world"], x["image"]) + ((w,) if weighted else ())
    je, jok = map(_np, jax.vmap(jepnp.epnp)(*map(jnp.asarray, args)))
    te, tok = tepnp.epnp(*map(T, args))
    np.testing.assert_array_equal(tok.numpy(), jok)
    np.testing.assert_allclose(te.numpy(), je, rtol=0, atol=1e-8)
    assert sp.minimal_hits("epnp", (te, tok), truth).all()


def test_p4pf_matches_jax():
    x, truth = sp.minimal_problems("p4pf", 7, 16)
    jm, jv = map(_np, jax.vmap(jp4pf.p4pf)(jnp.asarray(x["world"]),
                                          jnp.asarray(x["image"])))
    tm, tv = tp4pf.p4pf(T(x["world"]), T(x["image"]))
    np.testing.assert_array_equal(tv.numpy(), jv)
    scale = np.maximum(np.abs(jm), 1.0)
    assert np.max(np.abs(tm.numpy() - jm)[jv] / scale[jv]) < 1e-7
    assert sp.minimal_hits("p4pf", (tm, tv), truth).mean() >= 0.85


def test_project_focal_jacobian_matches_jacfwd():
    """The closed-form jacobian of the P4Pf polish residual against
    jax.jacfwd of the JAX module's residual (p4pf.py:79-84)."""
    x, _ = sp.minimal_problems("p4pf", 8, 6)
    rng = np.random.default_rng(9)
    p = np.concatenate([x["world"][:, 0] * 0 + rng.normal(size=(6, 3)),
                        rng.normal(size=(6, 3)) * 0.5,
                        rng.uniform(400, 1600, (6, 1))], -1)

    def residual(p, world, image):
        pc = jrot.angle_axis_rotate_point(
            jnp.broadcast_to(p[3:6], world.shape), world - p[0:3])
        z = jnp.maximum(pc[:, 2], 1e-6)
        return (pc[:, :2] / z[:, None] * p[6] - image).reshape(-1)

    jJ = np.stack([np.asarray(jax.jacfwd(residual)(
        jnp.asarray(p[b]), jnp.asarray(x["world"][b]),
        jnp.asarray(x["image"][b]))) for b in range(6)])
    proj, tJ = _polish.project_focal(T(p), T(x["world"]), True)
    r = (proj - T(x["image"])).flatten(-2).numpy()
    jr = np.stack([np.asarray(residual(jnp.asarray(p[b]),
                                       jnp.asarray(x["world"][b]),
                                       jnp.asarray(x["image"][b])))
                   for b in range(6)])
    np.testing.assert_allclose(r, jr, rtol=0, atol=1e-9)
    np.testing.assert_allclose(tJ.flatten(-3, -2).numpy(), jJ, rtol=1e-10,
                               atol=1e-10)


# float32 shares of solved problems (relative 1e-3), port on the CPU
# against JAX in float32 on the same 64 problems: the port's no more than
# this margin below JAX's (it may be above: its seven-point nullspace
# comes from a Householder QR and its epipoles from cross products,
# where JAX's eigh of the normal matrices loses float32 accuracy)
F32_MARGIN = 0.1


@pytest.mark.parametrize("name,jax_fn,n_out", [
    ("seven_point", lambda x: jax.vmap(jsp.seven_point_fundamental)(
        x["x1"], x["x2"]), 2),
    ("focal_from_fundamental", lambda x: jax.vmap(
        jff.focal_lengths_from_fundamental)(
        x["F"], jnp.zeros(x["F"].shape[:-2] + (2,), jnp.float32),
        jnp.zeros(x["F"].shape[:-2] + (2,), jnp.float32)), 3),
    ("known_rotation", lambda x: jax.vmap(
        jkr.relative_pose_from_two_points_with_known_rotation)(
        x["x1"], x["x2"], x["R"]), 2),
    ("epnp", lambda x: jax.vmap(jepnp.epnp)(x["world"], x["image"]), 2),
    ("dlt_pnp", lambda x: jax.vmap(jdlt.six_point_pnp)(
        x["world"], x["image"]), 2),
])
def test_float32_share_holds_to_jax(name, jax_fn, n_out):
    x, truth = sp.minimal_problems(name, 10, 64)
    jout = jax_fn({k: jnp.asarray(v, jnp.float32) for k, v in x.items()})
    jhit = sp.minimal_hits(name, tuple(T(np.asarray(o, np.float64))
                                       for o in jout), truth)
    thit = sp.minimal_hits(name, sp.run_minimal(name, x, torch.float32,
                                                "cpu"), truth)
    assert thit.mean() >= jhit.mean() - F32_MARGIN, (thit.mean(),
                                                     jhit.mean())
