"""5-point relative pose (essential matrix), up to 10 solutions (port
of theiasfm_tpu/sfm/pose/five_point.py).

ref: src/theia/sfm/pose/five_point_relative_pose.{h,cc} (Nister's
method: nullspace + Groebner elimination + 10th-degree polynomial), in
the Stewenius et al. 2006 action-matrix formulation, batched over
leading dims:
  1. The 4-dim nullspace of the 5x9 epipolar system: the trailing
     columns of the complete QR of A^T, by five Householder
     reflections written in batched tensor ops (LAPACK's convention,
     so the basis is the one torch.linalg.qr and jnp.linalg.qr give;
     their CUDA path builds Q matrix by matrix).
  2. E(x,y,z) = x E1 + y E2 + z E3 + E4. The 10 cubic constraints
     (det E = 0 and E E^T E - 0.5 tr(E E^T) E = 0) over the 20
     monomials of degree <= 3: the JAX module expands them symbolically
     at trace time; here the same products run as contractions with
     constant monomial-product tables.
  3. Gauss–Jordan against the leading 10x10 block (guarded when it is
     singular) -> the 10x10 action matrix for multiplication by z.
  4. Its eigenvalues without a nonsymmetric eig: the characteristic
     polynomial (Faddeev–LeVerrier) of the inf-norm-scaled matrix and
     the Aberth roots; eigenvectors by eigh of (A - zI)^T (A - zI) in
     float64, by damped inverse iteration in float32.
  5. A Gauss–Newton polish of (x, y, z) on the 10 constraints, with
     the jacobian from torch.func.jacfwd under vmap.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ...math import polynomial as poly
from ...utils import linalg

# Monomial ordering (degree-3 Stewenius basis split):
_ELIM = [(3, 0, 0), (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1),
         (1, 0, 2), (0, 3, 0), (0, 2, 1), (0, 1, 2), (0, 0, 3)]
_BASIS = [(2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1),
          (0, 0, 2), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
_MONOMIALS = _ELIM + _BASIS
# E's entries are linear in (x, y, z): coefficients of x, y, z, 1
_LINEAR = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
_QUADRATIC = [m for m in _MONOMIALS if sum(m) <= 2]


@functools.lru_cache(maxsize=None)
def _product_tables():
    """Monomial-product tables: (linear x linear -> quadratic) (4, 4,
    10) and (quadratic x linear -> cubic) (10, 4, 20), in numpy."""
    def table(left, right, out):
        idx = {m: i for i, m in enumerate(out)}
        T = np.zeros((len(left), len(right), len(out)))
        for a, ma in enumerate(left):
            for b, mb in enumerate(right):
                T[a, b, idx[tuple(p + q for p, q in zip(ma, mb))]] = 1.0
        return T
    return (table(_LINEAR, _LINEAR, _QUADRATIC),
            table(_QUADRATIC, _LINEAR, _MONOMIALS))


def _constraint_rows(E1, E2, E3, E4):
    """The (..., 10, 20) coefficient matrix of the 10 cubic constraints
    over _MONOMIALS."""
    t11, t21 = (torch.as_tensor(t, dtype=E1.dtype, device=E1.device)
                for t in _product_tables())
    Ep = torch.stack([E1, E2, E3, E4], dim=-1)            # (..., 3, 3, 4)

    def mul11(a, b):      # linear x linear -> quadratic
        return torch.einsum("...a,...b,abm->...m", a, b, t11)

    def mul21(a, b):      # quadratic x linear -> cubic
        return torch.einsum("...m,...b,mbn->...n", a, b, t21)

    EEt = torch.einsum("...ika,...jkb,abm->...ijm", Ep, Ep, t11)
    trace = EEt[..., 0, 0, :] + EEt[..., 1, 1, :] + EEt[..., 2, 2, :]
    EEtE = torch.einsum("...ikm,...kjb,mbn->...ijn", EEt, Ep, t21)
    half_trace_E = torch.einsum("...m,...ijb,mbn->...ijn",
                                0.5 * trace, Ep, t21)
    e = [[Ep[..., i, j, :] for j in range(3)] for i in range(3)]
    det = (mul21(mul11(e[1][1], e[2][2]) - mul11(e[1][2], e[2][1]),
                 e[0][0]) +
           mul21(mul11(e[1][2], e[2][0]) - mul11(e[1][0], e[2][2]),
                 e[0][1]) +
           mul21(mul11(e[1][0], e[2][1]) - mul11(e[1][1], e[2][0]),
                 e[0][2]))
    rows = (EEtE - half_trace_E).flatten(-3, -2)          # (..., 9, 20)
    return torch.cat([det[..., None, :], rows], dim=-2)


def _householder_nullspace(X):
    """Columns n..m-1 of the complete QR's Q of X (..., m, n), m > n:
    Householder reflections H_k = I - tau v v^T with LAPACK's choice of
    beta = -sign(alpha) ||x|| (dgeqr2 / dlarfg), Q = H_1 ... H_n."""
    m, n = X.shape[-2], X.shape[-1]
    vs, taus = [], []
    for k in range(n):
        x = X[..., k:, k]
        alpha = x[..., 0]
        xnorm = torch.linalg.norm(x[..., 1:], dim=-1)
        beta = -torch.copysign(torch.hypot(alpha, xnorm), alpha)
        trivial = xnorm == 0
        safe_beta = torch.where(trivial, torch.ones_like(beta), beta)
        tau = torch.where(trivial, torch.zeros_like(beta),
                          (beta - alpha) / safe_beta)
        denom = torch.where(trivial, torch.ones_like(alpha), alpha - beta)
        v = torch.cat([torch.ones_like(alpha[..., None]),
                       x[..., 1:] / denom[..., None]], dim=-1)
        # apply H_k to the remaining columns
        tail = X[..., k:, k + 1:]
        proj = torch.sum(v[..., :, None] * tail, dim=-2, keepdim=True)
        X = torch.cat([X[..., :k, :],
                       torch.cat([X[..., k:, :k + 1],
                                  tail - tau[..., None, None] *
                                  v[..., :, None] * proj], dim=-1)],
                      dim=-2)
        vs.append(v)
        taus.append(tau)
    Q = torch.eye(m, dtype=X.dtype, device=X.device)[:, n:].expand(
        X.shape[:-2] + (m, m - n))
    for k in reversed(range(n)):
        v, tau = vs[k], taus[k]
        part = Q[..., k:, :]
        proj = torch.sum(v[..., :, None] * part, dim=-2, keepdim=True)
        Q = torch.cat([Q[..., :k, :],
                       part - tau[..., None, None] * v[..., :, None] * proj],
                      dim=-2)
    return Q


# the action matrix for multiplication by z in the basis _BASIS: rows
# of -B for basis monomials that z maps onto eliminated ones, unit rows
# for z*x = xz, z*y = yz, z*z = z2, z*1 = z
_ELIM_FOR_BASIS = [2, 4, 5, 7, 8, 9]
_BASIS_FOR_SHIFT = [2, 4, 5, 8]


def _constraints(xyz, E1, E2, E3, E4):
    """The 10 cubic constraints at one (x, y, z), evaluated through E."""
    E = xyz[0] * E1 + xyz[1] * E2 + xyz[2] * E3 + E4
    EEt = E @ E.T
    c_trace = (EEt @ E - 0.5 * torch.trace(EEt) * E).reshape(9)
    return torch.cat([linalg.det3(E)[None], c_trace])


def _polish(xyz, E1, E2, E3, E4, iters):
    """Gauss–Newton on the constraints: xyz (B, 3), E* (B, 3, 3)."""
    res = torch.func.vmap(_constraints)
    jac = torch.func.vmap(torch.func.jacfwd(_constraints))
    eye = 1e-12 * torch.eye(3, dtype=xyz.dtype, device=xyz.device)
    for _ in range(iters):
        r = res(xyz, E1, E2, E3, E4)                      # (B, 10)
        J = jac(xyz, E1, E2, E3, E4)                      # (B, 10, 3)
        Jt = J.transpose(1, 2)
        delta = linalg.solve(Jt @ J + eye, Jt @ r[..., None])[..., 0]
        p_new = xyz - delta
        better = (torch.sum(res(p_new, E1, E2, E3, E4) ** 2, dim=-1) <
                  torch.sum(r ** 2, dim=-1))
        xyz = torch.where(better[:, None], p_new, xyz)
    return xyz


def five_point_essential(x1, x2, aberth_iters: int = 40,
                         inv_iters: int = 3, polish_iters: int = 4):
    """x1/x2 (..., 5, 2) normalized image coords -> (E (..., 10, 3, 3),
    valid (..., 10)). Convention: x2h^T E x1h = 0."""
    batch = x1.shape[:-2]
    x1 = x1.reshape(-1, 5, 2)
    x2 = x2.reshape(-1, 5, 2)
    dtype, dev = x1.dtype, x1.device
    n = x1.shape[0]
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    one = torch.ones_like(u1)
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2,
                     u1, v1, one], dim=-1)                 # (n, 5, 9)
    Q = _householder_nullspace(A.transpose(-1, -2))       # (n, 9, 4)
    E1, E2, E3, E4 = (Q[..., k].reshape(n, 3, 3) for k in range(4))

    M = _constraint_rows(E1, E2, E3, E4)                  # (n, 10, 20)
    # Gauss–Jordan [I | B], guarded against a singular leading block
    lead = M[..., :10]
    eye10 = torch.eye(10, dtype=dtype, device=dev)
    det_ok = torch.linalg.det(lead).abs() > 1e-18
    lead_safe = torch.where(det_ok[:, None, None], lead, eye10)
    B = linalg.solve(lead_safe, M[..., 10:])              # (n, 10, 10)

    Az = torch.zeros((n, 10, 10), dtype=dtype, device=dev)
    Az[:, :6] = -B[:, _ELIM_FOR_BASIS]
    Az[:, torch.arange(6, 10), _BASIS_FOR_SHIFT] = 1.0

    # similarity-scale before the char poly: the eigenvalues of Az/s
    # are bounded by 1 in inf-norm, so the coefficients stay float32-
    # representable (unscaled they reach ~1e8 and the Aberth radius
    # ** 10 overflows float32)
    s = torch.clamp(Az.abs().sum(dim=-1).amax(dim=-1), min=1e-12)
    cp = poly.char_poly(Az / s[:, None, None])
    roots = poly.poly_roots(cp, iters=aberth_iters)
    real = poly.real_roots_mask(roots, rel_tol=1e-3, abs_tol=1e-6)
    z = roots.real * s[:, None]                          # (n, 10)

    # eigenvectors: the null direction of (Az - z I); exact (eigh) in
    # float64, damped inverse iteration (batched 10x10 solves) in float32
    G = Az[:, None] - z[..., None, None] * eye10          # (n, 10, 10, 10)
    GtG = G.transpose(-1, -2) @ G
    if dtype == torch.float64:
        vs = linalg.eigh(GtG)[1][..., :, 0]
    else:
        tr = torch.diagonal(GtG, dim1=-2, dim2=-1).sum(-1)
        Hm = GtG + (1e-6 * tr / 10.0)[..., None, None] * eye10
        LU, piv, _ = torch.linalg.lu_factor_ex(Hm, check_errors=False)
        vs = torch.full((n, 10, 10, 1), 1.0 / math.sqrt(10.0),
                        dtype=dtype, device=dev)
        for _ in range(inv_iters):
            vs = torch.linalg.lu_solve(LU, piv, vs)
            vs = vs / torch.clamp(torch.linalg.norm(vs, dim=-2,
                                                    keepdim=True),
                                  min=1e-30)
        vs = vs[..., 0]
    denom = vs[..., 9]
    denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12),
                        denom)
    xyz = vs[..., 6:9] / denom[..., None]                # (n, 10, 3)

    Es4 = [Ek[:, None].expand(n, 10, 3, 3).reshape(-1, 3, 3)
           for Ek in (E1, E2, E3, E4)]
    xyz = _polish(xyz.reshape(-1, 3), *Es4, polish_iters).reshape(n, 10, 3)

    Es = (xyz[..., 0, None, None] * E1[:, None] +
          xyz[..., 1, None, None] * E2[:, None] +
          xyz[..., 2, None, None] * E3[:, None] + E4[:, None])
    norm = torch.linalg.norm(Es.flatten(-2), dim=-1)
    Es = Es / torch.clamp(norm[..., None, None], min=1e-12)
    valid = real & det_ok[:, None] & (norm > 1e-12)
    return (Es.reshape(batch + (10, 3, 3)), valid.reshape(batch + (10,)))
