"""The port's two-view solvers and triangulation against the JAX
package's on the CPU, on numpy-seeded scenes.

Five-point: each package returns up to 10 solutions, and which of them
its 40 Aberth iterations reach depends on rounding where the
characteristic polynomial is ill-conditioned. So the f64 route (eigh
null vectors) is held per solution: at least 95% of JAX's valid
solutions that interpolate their five points (epipolar residual
< 1e-9) are matched by a valid port E within 1e-8 up to sign, the
valid counts agree in at least 95% of problems, and the ground truth
is recovered (to 1e-6) in as many problems. The f32 route (inverse
iteration), with float32 arrays passed to JAX's solver directly: the
ground truth is recovered (to 1e-3) in a share of problems within 0.06
of JAX's, and at least 80% of JAX's interpolating solutions (residual
< 1e-4) are matched within 1e-3. The other solvers agree to 1e-9
(float64) after sign normalization.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theiasfm_tpu.math import rotation as jrot
from theiasfm_tpu.sfm import triangulation as jtri
from theiasfm_tpu.sfm.pose import eight_point as jep
from theiasfm_tpu.sfm.pose import five_point as jfp
from theiasfm_tpu.sfm.pose import homography as jh
from theiasfm_tpu.sfm.pose import twoview_utils as jtu
from theiasfm_tpu_torch.sfm import triangulation as ttri
from theiasfm_tpu_torch.sfm.pose import eight_point as tep
from theiasfm_tpu_torch.sfm.pose import five_point as tfp
from theiasfm_tpu_torch.sfm.pose import homography as th
from theiasfm_tpu_torch.sfm.pose import twoview_utils as ttu

T = torch.from_numpy


def _scenes(seed, n, k):
    """n random relative poses, each seeing k points at depth 4-10."""
    rng = np.random.default_rng(seed)
    aa = rng.normal(scale=0.2, size=(n, 3))
    t = rng.normal(size=(n, 3))
    R = np.asarray(jrot.angle_axis_to_rotation_matrix(jnp.asarray(aa)))
    pts = rng.uniform([-2, -2, 4], [2, 2, 10], size=(n, k, 3))
    p2 = np.einsum("nij,nkj->nki", R, pts) + t[:, None]
    x1 = pts[..., :2] / pts[..., 2:]
    x2 = p2[..., :2] / p2[..., 2:]
    tu = t / np.linalg.norm(t, axis=-1, keepdims=True)
    E = np.asarray(jrot.skew(jnp.asarray(tu))) @ R
    return x1, x2, E / np.linalg.norm(E, axis=(1, 2))[:, None, None], R, tu


def _epi_resid(E, x1, x2):
    h1 = np.concatenate([x1, np.ones_like(x1[..., :1])], -1)
    h2 = np.concatenate([x2, np.ones_like(x2[..., :1])], -1)
    return np.abs(np.einsum("pki,pmij,pkj->pmk", h2, E, h1)).max(-1)


def _sign_dist(A, B):
    """(P, 10, 10) max-abs distance up to sign between solution sets."""
    a = A.reshape(A.shape[0], -1, 1, 9)
    b = B.reshape(B.shape[0], 1, -1, 9)
    return np.minimum(np.abs(a - b).max(-1), np.abs(a + b).max(-1))


def _gt_found(E, valid, E_true, tol):
    d = _sign_dist(E, E_true[:, None])[..., 0]
    return ((d < tol) & valid).any(-1)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_five_point_matches_jax(dt):
    np_dt = np.float64 if dt == "f64" else np.float32
    x1, x2, E_true, _, _ = _scenes(0, 64, 5)
    Ej, vj = jax.jit(jax.vmap(jfp.five_point_essential))(
        jnp.asarray(x1.astype(np_dt)), jnp.asarray(x2.astype(np_dt)))
    Et, vt = tfp.five_point_essential(T(x1.astype(np_dt)),
                                      T(x2.astype(np_dt)))
    assert Et.dtype == (torch.float64 if dt == "f64" else torch.float32)
    Ej, vj = np.asarray(Ej).astype(float), np.asarray(vj)
    Et, vt = Et.double().numpy(), vt.numpy()
    res_tol, match_tol, gt_tol = ((1e-9, 1e-8, 1e-6) if dt == "f64"
                                  else (1e-4, 1e-3, 1e-3))
    good = vj & (_epi_resid(Ej, x1, x2) < res_tol)
    d = np.where(vt[:, None, :], _sign_dist(Ej, Et), np.inf)
    matched = (d.min(-1) < match_tol)[good]
    gj, gt = (_gt_found(Ej, vj, E_true, gt_tol),
              _gt_found(Et, vt, E_true, gt_tol))
    if dt == "f64":
        assert matched.mean() >= 0.95, matched.mean()
        assert np.mean(vj.sum(1) == vt.sum(1)) >= 0.95
        assert gt.sum() == gj.sum() and gt.mean() >= 0.9
    else:
        assert matched.mean() >= 0.8, matched.mean()
        assert abs(gt.mean() - gj.mean()) <= 0.06 and gt.mean() >= 0.75


def test_householder_nullspace_is_the_complete_qr():
    """The batched reflections give torch.linalg.qr's (LAPACK's)
    trailing columns, with a degenerate all-zero input kept finite."""
    X = np.random.default_rng(1).normal(size=(16, 9, 5))
    X[3] = 0.0
    Q = torch.linalg.qr(T(X), mode="complete")[0][..., 5:]
    got = tfp._householder_nullspace(T(X))
    torch.testing.assert_close(got, Q, atol=1e-12, rtol=0)


def test_constraint_rows_match_jax():
    rng = np.random.default_rng(2)
    Es = rng.normal(size=(4, 3, 3))
    j = np.asarray(jfp._constraint_rows(*map(jnp.asarray, Es)))
    t = tfp._constraint_rows(*(T(e)[None] for e in Es))[0].numpy()
    np.testing.assert_allclose(t, j, atol=1e-13)


def test_eight_point_and_homography_match_jax():
    rng = np.random.default_rng(3)
    x1, x2, _, _, _ = _scenes(4, 6, 12)
    px1, px2 = x1 * 600 + 320, x2 * 600 + 240
    w = rng.uniform(0.2, 1.0, (6, 12))
    for args, kw in (((px1[:, :8], px2[:, :8]), {}),
                     ((px1, px2), {"weights": w})):
        Fj, okj = jax.vmap(lambda a, b, *ww: jep.npoint_fundamental(
            a, b, *ww))(*map(jnp.asarray, args), *map(
                jnp.asarray, kw.values()))
        Ft, okt = tep.npoint_fundamental(*map(T, args), **{
            k: T(v) for k, v in kw.items()})
        Fj = np.asarray(Fj)
        sign = np.sign(np.sum(Fj * Ft.numpy(), axis=(1, 2)))
        np.testing.assert_allclose(Ft.numpy() * sign[:, None, None], Fj,
                                   atol=1e-9)
        np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
        Hj, hokj = jax.vmap(lambda a, b, *ww: jh.npoint_homography(
            a, b, *ww))(*map(jnp.asarray, args), *map(
                jnp.asarray, kw.values()))
        Ht, hokt = th.npoint_homography(*map(T, args), **{
            k: T(v) for k, v in kw.items()})
        np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=1e-8,
                                   atol=1e-9)
        np.testing.assert_array_equal(hokt.numpy(), np.asarray(hokj))
    H, ok = th.four_point_homography(T(px1[:, :4]), T(px2[:, :4]))
    assert H.shape == (6, 1, 3, 3) and ok.shape == (6, 1)
    np.testing.assert_allclose(
        th.homography_transfer_error_sq(H, T(px1[:, None, :4]),
                                        T(px2[:, None, :4])).numpy(),
        np.asarray(jax.vmap(jh.homography_transfer_error_sq)(
            jnp.asarray(np.asarray(H)[:, 0]), jnp.asarray(px1[:, :4]),
            jnp.asarray(px2[:, :4])))[:, None], rtol=1e-9, atol=1e-12)


def test_sampson_and_relative_pose_match_jax():
    x1, x2, E, R, tu = _scenes(5, 8, 40)
    x1n = x1 + np.random.default_rng(6).normal(scale=1e-3, size=x1.shape)
    for name in ("sampson_distance_sq", "epipolar_distance_sq"):
        j = np.asarray(jax.vmap(getattr(jtu, name))(
            jnp.asarray(E), jnp.asarray(x1n), jnp.asarray(x2)))
        t = getattr(ttu, name)(T(E), T(x1n), T(x2)).numpy()
        np.testing.assert_allclose(t, j, rtol=1e-10, atol=1e-18)
    mask = np.arange(40) < 35
    Rj, tj, nj = jax.vmap(lambda e, a, b: jtu.relative_pose_from_essential(
        e, a, b, mask=jnp.asarray(mask)))(*map(jnp.asarray, (E, x1n, x2)))
    Rt, tt, nt = ttu.relative_pose_from_essential(T(E), T(x1n), T(x2),
                                                  mask=T(mask))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-9)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-9)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_allclose(Rt.numpy(), R, atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), tu, atol=1e-6)
    Fj = np.asarray(jtu.fundamental_from_essential(
        jnp.asarray(E[0]), 600.0, 500.0, jnp.asarray([320.0, 240.0]),
        jnp.asarray([300.0, 200.0])))
    Ft = ttu.fundamental_from_essential(
        T(E[0]), 600.0, 500.0, T(np.array([320.0, 240.0])),
        T(np.array([300.0, 200.0])))
    np.testing.assert_allclose(Ft.numpy(), Fj, rtol=1e-12)
    P1 = np.concatenate([np.eye(3), np.zeros((3, 1))], 1)
    P2 = np.concatenate([R[0], tu[0, :, None]], 1)
    np.testing.assert_allclose(
        ttu.fundamental_from_projections(T(P1), T(P2)).numpy(),
        np.asarray(jtu.fundamental_from_projections(jnp.asarray(P1),
                                                    jnp.asarray(P2))),
        atol=1e-12)
    np.testing.assert_allclose(
        ttu.essential_from_rt(T(R), T(tu * 3)).numpy(),
        np.asarray(jtu.essential_from_rt(jnp.asarray(R),
                                         jnp.asarray(tu * 3))), atol=1e-12)


def test_triangulation_matches_jax():
    rng = np.random.default_rng(7)
    x1, x2, E, R, tu = _scenes(8, 4, 30)
    P1 = np.concatenate([np.eye(3), np.zeros((3, 1))], 1)
    P2 = np.concatenate([R, tu[..., None]], -1)
    j = np.asarray(jax.vmap(lambda p, a, b: jtri.triangulate_dlt(
        jnp.asarray(P1), p, a, b))(*map(jnp.asarray, (P2, x1, x2))))
    t = ttri.triangulate_dlt(T(P1), T(P2)[:, None], T(x1), T(x2)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-9)
    xn = x1 + rng.normal(scale=1e-3, size=x1.shape)
    j = np.asarray(jax.vmap(lambda p, a, b, e: jtri.triangulate_two_view_optimal(
        jnp.asarray(P1), p, a, b, e))(*map(jnp.asarray, (P2, xn, x2, E))))
    t = ttri.triangulate_two_view_optimal(
        T(P1), T(P2)[:, None], T(xn), T(x2), T(E)[:, None]).numpy()
    np.testing.assert_allclose(t, j, atol=1e-9)
    # n-view, midpoint, cheirality and angles on a 3-view rig
    ext = np.concatenate([rng.normal(size=(3, 3)),
                          rng.normal(scale=0.1, size=(3, 3))], -1)
    K = np.asarray(jtri.calibration_matrix(jnp.asarray(
        [[600.0, 1.0, 0.0, 320.0, 240.0]] * 3)))
    Ps = np.asarray(jtri.projection_matrix(jnp.asarray(ext), jnp.asarray(K)))
    np.testing.assert_allclose(
        ttri.projection_matrix(T(ext), ttri.calibration_matrix(T(np.array(
            [[600.0, 1.0, 0.0, 320.0, 240.0]] * 3)))).numpy(), Ps,
        atol=1e-9)
    X = np.append(rng.normal(size=3) + [0, 0, 8], 1.0)
    xs = (Ps @ X)[:, :2] / (Ps @ X)[:, 2:]
    mask = np.array([True, True, False])
    for fn, args in (("triangulate_nview", (Ps, xs, mask)),
                     ("is_in_front_of_cameras", (ext, X, mask)),
                     ("triangulation_angles", (ext[:, :3], X, mask))):
        j = np.asarray(getattr(jtri, fn)(*map(jnp.asarray, args)))
        t = getattr(ttri, fn)(*map(T, args)).numpy()
        np.testing.assert_allclose(t, j, atol=1e-9, err_msg=fn)
    d = rng.normal(size=(3, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        ttri.triangulate_midpoint(T(ext[:, :3]), T(d)).numpy(),
        np.asarray(jtri.triangulate_midpoint(jnp.asarray(ext[:, :3]),
                                             jnp.asarray(d))), atol=1e-9)
