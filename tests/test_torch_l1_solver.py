"""The port's L1 and QP solvers (math/l1_solver.py) and its copy of
math/normalized_cut.py against the JAX package's, in float64 on the CPU,
on the cases of tests/test_math_solvers.py.

Both factor once and run the same ADMM / projected-gradient iterations;
the solutions agree to 1e-12 relative (measured: at most 7e-16 on these
cases). Each case also passes the recovery check JAX's test makes.
A matrix whose factorization fails gives NaN in both packages, where
torch.linalg.cholesky would raise. normalized_cut is a numpy copy and
gives the same labels and cut value.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theiasfm_tpu.math import l1_solver as jl1
from theiasfm_tpu.math.normalized_cut import normalized_cut as j_ncut
from theiasfm_tpu_torch.math import l1_solver as tl1
from theiasfm_tpu_torch.math.normalized_cut import normalized_cut as t_ncut

from torch_sfm_cases import one_torch_thread  # noqa: F401

REL = 1e-12


def _close(port, jax_x, rel=REL):
    port = port.numpy() if torch.is_tensor(port) else np.asarray(port)
    jax_x = np.asarray(jax_x)
    assert port.dtype == np.float64
    err = np.linalg.norm(port - jax_x) / np.linalg.norm(jax_x)
    assert err <= rel, err
    return port


def test_l1_solve_matches_jax(rng):
    n, m = 5, 200
    x_true = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    b = A @ x_true + rng.normal(scale=0.01, size=m)
    idx = rng.choice(m, 20, replace=False)
    b[idx] += rng.normal(scale=20.0, size=20)
    xj = jl1.l1_solve(jnp.asarray(A), jnp.asarray(b), iters=200)
    x = _close(tl1.l1_solve(torch.from_numpy(A), torch.from_numpy(b),
                            iters=200), xj)
    assert np.linalg.norm(x - x_true) < 0.05
    x_ls = np.linalg.lstsq(A, b, rcond=None)[0]
    assert np.linalg.norm(x - x_true) < 0.3 * np.linalg.norm(x_ls - x_true)


def test_constrained_l1_matches_jax(rng):
    n, m = 4, 100
    x_true = np.abs(rng.normal(size=n)) + 0.5
    A = rng.normal(size=(m, n))
    b = A @ x_true
    C = -np.eye(n)
    d = -0.2 * np.ones(n)
    xj = jl1.constrained_l1_solve(*(jnp.asarray(v) for v in (A, b, C, d)),
                                  iters=300)
    x = _close(tl1.constrained_l1_solve(
        *(torch.from_numpy(v) for v in (A, b, C, d)), iters=300), xj)
    assert np.all(x >= 0.2 - 1e-5)
    assert np.linalg.norm(x - x_true) < 0.05


def _ref_qp():
    P = np.array([[5., -2, -1], [-2, 4, 3], [-1, 3, 5]])
    q = np.array([2., -35, -47])
    return P, q


@pytest.mark.parametrize("case,expected", [
    ("unbounded", [3, 5, 7]), ("loose", [3, 5, 7]), ("tight", [5, 7, 9])])
def test_qp_solver_matches_jax(case, expected):
    """ref qp_solver_test.cc's Unbounded, LooseBounds, TightBounds."""
    P, q = _ref_qp()
    iters = 1000 if case == "tight" else 300
    bounds = {"loose": ([0, 0, 0], [10, 10, 10]),
              "tight": ([5, 7, 9], [10, 12, 14])}.get(case)
    js = jl1.QPSolver(P, q, r=5.0, max_num_iterations=iters)
    ts = tl1.QPSolver(torch.from_numpy(P), torch.from_numpy(q), r=5.0,
                      max_num_iterations=iters)
    if bounds:
        for s in (js, ts):
            s.set_lower_bound(np.asarray(bounds[0], float))
            s.set_upper_bound(np.asarray(bounds[1], float))
    x = _close(ts.solve(), js.solve())
    np.testing.assert_allclose(x, expected, atol=1e-3)


def test_qp_box_matches_jax(rng):
    n = 6
    M = rng.normal(size=(n, n))
    P = M @ M.T + np.eye(n)
    q = -P @ rng.normal(size=n)
    lo, hi = -0.5 * np.ones(n), 0.5 * np.ones(n)
    xj = jl1.qp_solve_box(*(jnp.asarray(v) for v in (P, q, lo, hi)),
                          iters=500)
    x = _close(tl1.qp_solve_box(*(torch.from_numpy(v) for v in
                                  (P, q, lo, hi)), iters=500), xj)
    g = P @ x + q
    free = ~((x <= lo + 1e-6) | (x >= hi - 1e-6))
    assert np.abs(g[free]).max(initial=0.0) < 1e-4


def test_array_inputs_on_the_cpu_when_asked(rng):
    """Array-likes go to `device`; the solution is a tensor there."""
    A = rng.normal(size=(30, 3))
    b = A @ np.ones(3)
    x = tl1.l1_solve(A, b, iters=50, device="cpu")
    assert x.device.type == "cpu"
    np.testing.assert_allclose(x.numpy(), 1.0, atol=1e-6)


def test_failed_factorization_gives_nan():
    """P + rho I not positive definite: JAX's cho_factor gives NaN and so
    does the port (torch.linalg.cholesky would raise)."""
    P = -2.0 * np.eye(3)
    q, lo, hi = np.zeros(3), -np.ones(3), np.ones(3)
    xj = np.asarray(jl1.qp_solve_admm(*(jnp.asarray(v) for v in
                                        (P, q, lo, hi)), iters=5))
    x = tl1.qp_solve_admm(*(torch.from_numpy(v) for v in (P, q, lo, hi)),
                          iters=5).numpy()
    assert np.isnan(xj).all() == np.isnan(x).all()
    with pytest.raises(torch.linalg.LinAlgError):
        torch.linalg.cholesky(torch.from_numpy(P - np.eye(3)))


@pytest.mark.parametrize("seed", [0, 1])
def test_normalized_cut_matches_jax(seed):
    """Two dense clusters joined by weak edges: the same labels and cut
    value (a copy of the numpy module)."""
    g = np.random.default_rng(seed)
    n = 12
    edges, weights = [], []
    for a in range(n):
        for b in range(a + 1, n):
            same = (a < n // 2) == (b < n // 2)
            if same or g.random() < 0.2:
                edges.append((a, b))
                weights.append(g.uniform(1, 2) if same else
                               g.uniform(0.01, 0.1))
    edges, weights = np.asarray(edges), np.asarray(weights)
    lj, cj = j_ncut(n, edges, weights)
    lt, ct = t_ncut(n, edges, weights)
    np.testing.assert_array_equal(lt, lj)
    assert ct == cj
    assert len(set(lt[:n // 2])) == 1 and lt[0] != lt[-1]
