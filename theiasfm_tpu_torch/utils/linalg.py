"""Small batched factorizations that behave on the card as JAX's do.

On CUDA, torch.linalg.solve and inv read an error code back to the
host and raise on a singular matrix, and eigh and svd raise when their
iteration fails to converge, which a non-finite input makes likely.
The JAX package relies on the other behaviour: a singular or
non-finite problem yields inf or NaN, and a validity mask downstream
drops it. These wrappers keep that contract: the solves skip the error
check, and eigh and svd factor a finite stand-in (the identity) for a
matrix with a non-finite entry and return NaN for it.
"""
from __future__ import annotations

import torch


def solve(A, B):
    """A X = B for (..., n, n) A; a singular A gives inf or NaN."""
    return torch.linalg.solve_ex(A, B, check_errors=False)[0]


def inv(A):
    return torch.linalg.inv_ex(A, check_errors=False)[0]


def _finite_stand_in(A):
    bad = ~torch.isfinite(A).all(dim=-1).all(dim=-1)
    eye = torch.eye(A.shape[-2], A.shape[-1], dtype=A.dtype,
                    device=A.device)
    return torch.where(bad[..., None, None], eye, A), bad


# matrices per cuSOLVER batched eigh call (a batch of 57,344 4x4
# matrices raised CUSOLVER_STATUS_INVALID_VALUE on the H100)
EIGH_BATCH = 8192


def eigh(A):
    """Ascending eigenvalues and eigenvectors of symmetric (..., n, n)
    A; NaN where A has a non-finite entry. On the card the batch goes
    to cuSOLVER in pieces of EIGH_BATCH matrices."""
    A, bad = _finite_stand_in(A)
    if A.device.type == "cuda" and A[..., 0, 0].numel() > EIGH_BATCH:
        flat = A.reshape((-1,) + A.shape[-2:])
        parts = [torch.linalg.eigh(flat[i:i + EIGH_BATCH])
                 for i in range(0, flat.shape[0], EIGH_BATCH)]
        w = torch.cat([p[0] for p in parts]).reshape(A.shape[:-1])
        V = torch.cat([p[1] for p in parts]).reshape(A.shape)
    else:
        w, V = torch.linalg.eigh(A)
    nan = torch.full((), float("nan"), dtype=A.dtype, device=A.device)
    return (torch.where(bad[..., None], nan, w),
            torch.where(bad[..., None, None], nan, V))


def svd(A, full_matrices: bool = True):
    """U, S, Vh of (..., m, n) A; NaN where A has a non-finite entry. One
    cuSOLVER call takes P3P's largest batch, 16,384 3x3 matrices, in
    3.3 ms on the H100 (chip_smoke.py's svd probe)."""
    A, bad = _finite_stand_in(A)
    U, S, Vh = torch.linalg.svd(A, full_matrices=full_matrices)
    nan = torch.full((), float("nan"), dtype=A.dtype, device=A.device)
    return (torch.where(bad[..., None, None], nan, U),
            torch.where(bad[..., None], nan, S),
            torch.where(bad[..., None, None], nan, Vh))


def det3(A):
    """Determinant of (..., 3, 3) A by cofactors (no factorization)."""
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] -
                            A[..., 1, 2] * A[..., 2, 1]) -
            A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] -
                            A[..., 1, 2] * A[..., 2, 0]) +
            A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] -
                            A[..., 1, 1] * A[..., 2, 0]))


def inv3(A):
    """Inverse of (..., 3, 3) A by the adjugate (no factorization); a
    singular A gives inf or NaN."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    adj = torch.stack([e * i - f * h, c * h - b * i, b * f - c * e,
                       f * g - d * i, a * i - c * g, c * d - a * f,
                       d * h - e * g, b * g - a * h, a * e - b * d],
                      dim=-1).reshape(A.shape)
    return adj / det3(A)[..., None, None]


def cholesky(A):
    """Lower Cholesky factor of symmetric (..., n, n) A; NaN where A is
    not positive definite (JAX's cho_factor returns NaN there, and
    torch.linalg.cholesky raises). No host sync: the factorization's
    error code stays on the device."""
    L, info = torch.linalg.cholesky_ex(A)
    nan = torch.full((), float("nan"), dtype=A.dtype, device=A.device)
    return torch.where((info == 0)[..., None, None], L, nan)
