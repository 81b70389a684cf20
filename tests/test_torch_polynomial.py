"""The port's math/polynomial.py against the JAX package's on the CPU.

Same numpy-seeded coefficients through both: polynomials with real
roots at least 0.5 apart, and polynomials with normal coefficients
(complex roots). Tolerances: the Aberth roots agree to 1e-9 under
float64 and to 2e-4 of the root's magnitude plus 2e-4 under float32
(complex64): the two run the same operations, but a few sums in
another order, and a degree-10 root amplifies that rounding (some
1e-10 under float64, some 1e-5 under float32, measured); the
Faddeev–LeVerrier coefficients agree to 1e-12 / 1e-4 of their largest.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theiasfm_tpu.math import polynomial as jpoly
from theiasfm_tpu_torch.math import polynomial as tpoly

DTYPES = {"f64": (np.float64, 1e-9), "f32": (np.float32, 2e-4)}


def _sorted(r):
    r = np.asarray(r)
    return np.take_along_axis(r, np.argsort(r.real + 1e-3 * r.imag, -1), -1)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("degree,iters", [(3, 40), (4, 48), (10, 40)])
def test_poly_roots_match_jax(dt, degree, iters):
    np_dt, tol = DTYPES[dt]
    rng = np.random.default_rng(degree)
    roots = (-0.25 * degree + 0.5 * np.arange(degree) +
             rng.uniform(0, 0.1, (32, degree)))
    coeffs = np.stack([np.poly(r) for r in roots])
    coeffs[:8] = rng.normal(size=(8, degree + 1))   # complex roots too
    coeffs = coeffs.astype(np_dt)
    j = np.asarray(jpoly.poly_roots(jnp.asarray(coeffs), iters=iters))
    t = tpoly.poly_roots(torch.from_numpy(coeffs), iters=iters).numpy()
    assert t.dtype == (np.complex128 if dt == "f64" else np.complex64)
    np.testing.assert_allclose(t, j, rtol=tol, atol=tol)
    mj = np.asarray(jpoly.real_roots_mask(jnp.asarray(j)))
    mt = tpoly.real_roots_mask(torch.from_numpy(t)).numpy()
    # realness sits on a threshold; agree on all but a sliver
    assert np.mean(mj == mt) >= 0.99


@pytest.mark.parametrize("dt", DTYPES)
def test_char_poly_matches_jax(dt):
    np_dt, tol = DTYPES[dt]
    A = np.random.default_rng(1).normal(size=(16, 10, 10)).astype(np_dt)
    j = np.asarray(jpoly.char_poly(jnp.asarray(A)))
    t = tpoly.char_poly(torch.from_numpy(A)).numpy()
    scale = np.abs(j).max(-1, keepdims=True)
    np.testing.assert_allclose(t / scale, j / scale,
                               atol=1e-12 if dt == "f64" else 1e-4)
    np.testing.assert_allclose(t[0], np.poly(A[0].astype(np.float64)),
                               rtol=1e-3 if dt == "f32" else 1e-9,
                               atol=1e-3 if dt == "f32" else 1e-9)


def test_closed_forms_match_jax():
    rng = np.random.default_rng(2)
    a, b, c, d, e = rng.normal(size=(5, 64))
    for name, args in (("solve_quadratic", (a, b, c)),
                       ("solve_cubic", (a, b, c, d)),
                       ("solve_quartic", (a, b, c, d, e))):
        j = np.asarray(getattr(jpoly, name)(*map(jnp.asarray, args)))
        t = getattr(tpoly, name)(*map(torch.from_numpy, args)).numpy()
        np.testing.assert_allclose(_sorted(t), _sorted(j), rtol=1e-9,
                                   atol=1e-9, err_msg=name)
    # a == 0: the single root -c/b twice
    r = tpoly.solve_quadratic(torch.tensor(0.0, dtype=torch.float64),
                              torch.tensor(2.0, dtype=torch.float64),
                              torch.tensor(-4.0, dtype=torch.float64))
    np.testing.assert_allclose(r.numpy(), [2.0, 2.0])


def test_polyval_matches_jax():
    rng = np.random.default_rng(3)
    c = rng.normal(size=(8, 6))
    x = rng.normal(size=8)
    np.testing.assert_allclose(
        tpoly.polyval(torch.from_numpy(c), torch.from_numpy(x)).numpy(),
        np.asarray(jpoly.polyval(jnp.asarray(c), jnp.asarray(x))),
        rtol=1e-12)
