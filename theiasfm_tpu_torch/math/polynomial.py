"""Batched polynomial root finding for minimal solvers (port of
theiasfm_tpu/math/polynomial.py).

ref: src/theia/math/closed_form_polynomial_solver.h,
find_polynomial_roots_jenkins_traub.h,
find_polynomial_roots_companion_matrix.h. Instead of a sequential root
finder per call, the Aberth–Ehrlich simultaneous iteration: a fixed
number of vectorized complex Newton-like updates that converge to all
roots at once, batched over leading dims.

Conventions: coefficient vectors are highest-degree-first
(`coeffs[0] x^n + ... + coeffs[n]`). Real float32 input computes in
complex64, float64 in complex128.
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "solve_quadratic", "solve_cubic", "solve_quartic",
    "poly_roots", "polyval", "real_roots_mask", "char_poly",
]


def char_poly(A):
    """Characteristic polynomial of (..., n, n) -> (..., n+1) monic
    coefficients, highest degree first, by the Faddeev–LeVerrier
    recurrence (n matrix products, no nonsymmetric eig)."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    ck = torch.ones(A.shape[:-2], dtype=A.dtype, device=A.device)
    coeffs = [ck]
    Mk = torch.zeros_like(A)
    for k in range(1, n + 1):
        Mk = A @ (Mk + ck[..., None, None] * eye)
        ck = -torch.diagonal(Mk, dim1=-2, dim2=-1).sum(-1) / k
        coeffs.append(ck)
    return torch.stack(coeffs, dim=-1)


def polyval(coeffs, x):
    """Horner evaluation. coeffs (..., D+1) highest-first, x (...)."""
    out = torch.zeros_like(x) + coeffs[..., 0]
    for i in range(1, coeffs.shape[-1]):
        out = out * x + coeffs[..., i]
    return out


def _to_complex(x):
    x = torch.as_tensor(x)
    if x.is_complex():
        return x
    return x.to(torch.complex128 if x.dtype == torch.float64
                else torch.complex64)


def _nonzero(x, eps=1e-30):
    """x with exact zeros replaced by eps (complex)."""
    return torch.where(x == 0, torch.full_like(x, eps), x)


def solve_quadratic(a, b, c):
    """Roots of a x^2 + b x + c. Returns complex (..., 2).

    Citardauq form: q = -(b + sign(b) sqrt(disc)) / 2; roots q/a and
    c/q (ref closed_form_polynomial_solver.h)."""
    a, b, c = torch.broadcast_tensors(*(torch.as_tensor(v) for v in
                                        (a, b, c)))
    ac, bc, cc = _to_complex(a), _to_complex(b), _to_complex(c)
    disc = torch.sqrt(bc * bc - 4 * ac * cc)
    sgn = torch.where((torch.conj(bc) * disc).real >= 0, 1.0, -1.0)
    q = -0.5 * (bc + sgn * disc)
    one = torch.ones_like(ac)
    r1 = q / torch.where(ac == 0, one, ac)
    r2 = cc / torch.where(q == 0, one, q)
    # degenerate a == 0: the single root -c/b, twice
    lin = -cc / torch.where(bc == 0, one, bc)
    r1 = torch.where(ac == 0, lin, r1)
    r2 = torch.where(ac == 0, lin, r2)
    return torch.stack([r1, r2], dim=-1)


def solve_cubic(a, b, c, d):
    """Roots of a x^3 + b x^2 + c x + d. Complex (..., 3)."""
    a, b, c, d = torch.broadcast_tensors(*(torch.as_tensor(v) for v in
                                           (a, b, c, d)))
    return poly_roots(torch.stack([a, b, c, d], dim=-1), iters=40)


def solve_quartic(a, b, c, d, e):
    """Roots of a x^4 + b x^3 + c x^2 + d x + e. Complex (..., 4)."""
    a, b, c, d, e = torch.broadcast_tensors(*(torch.as_tensor(v) for v in
                                              (a, b, c, d, e)))
    return poly_roots(torch.stack([a, b, c, d, e], dim=-1), iters=48)


def poly_roots(coeffs, iters: int = 80):
    """All complex roots of a dense polynomial, batched.

    Aberth–Ehrlich iteration from a spiral inside the Cauchy bound (the
    spiral breaks the symmetry so conjugate pairs do not stall), with a
    fixed `iters`. coeffs (..., D+1) real or complex, highest degree
    first; a zero leading coefficient is guarded (it yields large
    spurious roots that callers mask). Returns (..., D) complex roots.
    """
    coeffs = _to_complex(coeffs)
    D = coeffs.shape[-1] - 1
    rdtype = coeffs.real.dtype
    dev = coeffs.device
    lead = coeffs[..., :1]
    lead = torch.where(lead.abs() < 1e-30, torch.full_like(lead, 1e-30),
                       lead)
    monic = coeffs / lead

    # Cauchy bound: 1 + max |a_i|
    radius = 1.0 + monic[..., 1:].abs().amax(dim=-1, keepdim=True)
    # the spiral in float32, as the reference computes it
    k = torch.arange(D, dtype=torch.float32, device=dev)
    angles = 2.0 * math.pi * k / D + 0.4
    ramp = (1.0 + 0.08 * k / max(D, 1)).to(rdtype)
    spiral = torch.polar(torch.ones_like(angles), angles).to(monic.dtype)
    z = (0.5 * radius) * spiral * ramp

    dcoef = monic[..., :-1] * torch.arange(D, 0, -1, dtype=rdtype,
                                           device=dev)
    eye = torch.eye(D, dtype=torch.bool, device=dev)
    off = (~eye).to(rdtype)
    max_step = 2.0 * radius
    for _ in range(iters):
        p = _polyval_c(monic, z)
        dp = _polyval_c(dcoef, z)
        newton = p / _nonzero(dp)
        # pairwise repulsion sum_{j != i} 1 / (z_i - z_j)
        diff = z[..., :, None] - z[..., None, :]
        diff = torch.where(eye, torch.ones_like(diff), diff)
        diff = torch.where(diff.abs() < 1e-30, torch.full_like(diff, 1e-30),
                           diff)
        repulse = torch.sum((1.0 / diff) * off, dim=-1)
        denom = 1.0 - newton * repulse
        denom = torch.where(denom.abs() < 1e-30,
                            torch.full_like(denom, 1e-30), denom)
        step = newton / denom
        # clamp runaway steps to twice the Cauchy radius
        mag = step.abs()
        scale = max_step / torch.where(mag == 0, torch.ones_like(mag), mag)
        step = torch.where(mag > max_step, step * scale, step)
        z = z - step
    return z


def _polyval_c(coeffs, z):
    out = torch.zeros_like(z) + coeffs[..., :1]
    for i in range(1, coeffs.shape[-1]):
        out = out * z + coeffs[..., i:i + 1]
    return out


def real_roots_mask(roots, rel_tol: float = 1e-5, abs_tol: float = 1e-8):
    """Boolean mask of roots that are (numerically) real."""
    return roots.imag.abs() <= (abs_tol + rel_tol * roots.abs())
