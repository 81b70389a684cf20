"""L1-norm minimization and box-constrained QP solvers (ADMM, projected
gradient) in PyTorch (port of theiasfm_tpu/math/l1_solver.py).

ref: src/theia/math/l1_solver.h:85-90 (ADMM least-absolute-deviations
with one reusable Cholesky factorization) and
src/theia/math/constrained_l1_solver.h (L1 with linear inequality
constraints, used by the LUD position estimator,
least_unsquared_deviation_position_estimator.cc:45,102-105).

Each solver factors once (`utils.linalg.cholesky`) and calls
torch.cholesky_solve in every iteration; JAX's fori_loops are eager
loops with no host sync inside. The solvers run on the device of their
inputs, in their dtype. In float32 the 1e-10 damping of A^T A is below
the resolution: a rank-deficient A gives a NaN factor, and so a NaN
solution, as JAX's cho_factor does (torch.linalg.cholesky would raise).

Inputs that are tensors stay on their device; array-likes go to
`device` (the card by default; it raises without one).
"""
from __future__ import annotations

import torch

from ..utils import linalg
from ..utils.device import resolve_device


def _as_tensor(x, device):
    """x as a tensor: a tensor as it is, an array-like on `device`."""
    if torch.is_tensor(x):
        return x
    return torch.as_tensor(x, device=resolve_device(device))


def _like(x, ref):
    """x (tensor or array-like) in ref's dtype on ref's device."""
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _cho_solve(L, b):
    return torch.cholesky_solve(b[:, None], L)[:, 0]


def _shrink(v, kappa):
    return torch.sign(v) * torch.clamp_min(v.abs() - kappa, 0.0)


def l1_solve(A, b, iters: int = 100, rho: float = 1.0, device="cuda"):
    """min_x ||A x - b||_1 via ADMM.

    A (M, N) dense (the global pipeline's huge sparse cases take the
    matrix-free IRLS of sfm/global_pose). Returns x (N,)."""
    A = _as_tensor(A, device)
    b = _like(b, A)
    L = linalg.cholesky(A.T @ A + 1e-10 * _eye(A.shape[1], A))
    x = _cho_solve(L, A.T @ b)
    z = torch.zeros_like(b)
    u = torch.zeros_like(b)
    for _ in range(iters):
        x = _cho_solve(L, A.T @ (b + z - u))
        Ax = A @ x
        z = _shrink(Ax - b + u, 1.0 / rho)
        u = u + Ax - b - z
    return x


def constrained_l1_solve(A, b, C, d, iters: int = 200, rho: float = 1.0,
                         device="cuda"):
    """min_x ||A x - b||_1  s.t.  C x <= d  (ADMM with slack
    projection). A (M, N), C (P, N). Returns x (N,)."""
    A = _as_tensor(A, device)
    b, C, d = (_like(t, A) for t in (b, C, d))
    K = torch.cat([A, C], 0)
    L = linalg.cholesky(K.T @ K + 1e-10 * _eye(K.shape[1], A))
    M = A.shape[0]
    bd = torch.cat([b, d])
    x = _cho_solve(L, K.T @ bd)
    z = torch.zeros_like(bd)
    u = torch.zeros_like(bd)
    for _ in range(iters):
        x = _cho_solve(L, K.T @ (bd + z - u))
        Kx = K @ x
        t = Kx - bd + u
        z = torch.cat([_shrink(t[:M], 1.0 / rho),
                       torch.clamp_max(t[M:], 0.0)])  # Cx - d <= 0
        u = u + Kx - bd - z
    return x


def qp_solve_admm(P, q, lo, hi, iters: int = 1000, rho: float = 1.0,
                  alpha: float = 1.0, device="cuda"):
    """min_x 0.5 x^T P x + q^T x  s.t.  lo <= x <= hi — the
    reference's QPSolver algorithm (src/theia/math/qp_solver.h /
    qp_solver.cc: ADMM after Boyd's quadprog, one Cholesky factorization
    of P + rho*I reused every iteration, over-relaxation alpha,
    clip-to-box z update, scaled dual u). Use +/-inf bounds for
    unbounded coordinates (the reference's defaults)."""
    P = _as_tensor(P, device)
    q, lo, hi = (_like(t, P) for t in (q, lo, hi))
    n = P.shape[0]
    L = linalg.cholesky(P + rho * _eye(n, P))
    z = torch.clamp(torch.zeros_like(q), lo, hi)
    u = torch.zeros_like(q)
    for _ in range(iters):
        x = _cho_solve(L, rho * (z - u) - q)
        x_hat = alpha * x + (1.0 - alpha) * z
        z = torch.clamp(x_hat + u, lo, hi)
        u = u + x_hat - z
    return torch.clamp(z, lo, hi)


class QPSolver:
    """Object-style wrapper mirroring ref QPSolver (qp_solver.h:66-94):
    minimize 0.5 x'Px + q'x + r subject to lb <= x <= ub. A tensor P
    stays on its device; an array-like goes to `device`."""

    def __init__(self, P, q, r=0.0, max_num_iterations: int = 1000,
                 rho: float = 1.0, alpha: float = 1.0, device="cuda"):
        self.P = _as_tensor(P, device)
        self.q, self.r = _like(q, self.P), r
        self.iters = max_num_iterations
        self.rho, self.alpha = rho, alpha
        n = self.P.shape[0]
        self.lb = torch.full((n,), -torch.inf, dtype=self.P.dtype,
                             device=self.P.device)
        self.ub = torch.full((n,), torch.inf, dtype=self.P.dtype,
                             device=self.P.device)

    def set_lower_bound(self, lb):
        self.lb = _like(lb, self.P)

    def set_upper_bound(self, ub):
        self.ub = _like(ub, self.P)

    def solve(self):
        return qp_solve_admm(self.P, self.q, self.lb, self.ub,
                             iters=self.iters, rho=self.rho,
                             alpha=self.alpha)


def qp_solve_box(P, q, lo, hi, iters: int = 200, device="cuda"):
    """min_x 0.5 x^T P x + q^T x  s.t.  lo <= x <= hi  (projected
    gradient with Nesterov momentum — faster than ADMM when a loose
    solution suffices). ref: src/theia/math/qp_solver.h."""
    P = _as_tensor(P, device)
    q, lo, hi = (_like(t, P) for t in (q, lo, hi))
    step = 1.0 / (torch.linalg.matrix_norm(P, ord=2) + 1e-9)  # 1/Lipschitz
    x = torch.clamp(-q / torch.clamp_min(torch.diagonal(P), 1e-9), lo, hi)
    y = x
    t = torch.ones((), dtype=P.dtype, device=P.device)
    for _ in range(iters):
        x_new = torch.clamp(y - step * (P @ y + q), lo, hi)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        y = x_new + ((t - 1.0) / t_new) * (x_new - x)
        x, t = x_new, t_new
    return x
