"""Gauss-Jordan elimination with partial pivoting, batched (port of
theiasfm_tpu/math/gauss_jordan.py).

ref: src/theia/math/matrix/gauss_jordan.h — row-reduces a (possibly
rectangular) matrix with partial pivoting; the reference uses it to
build UPnP action matrices. A fixed loop over the pivot columns with
whole-matrix row updates, over a batch of matrices at once.
"""
from __future__ import annotations

import torch


def gauss_jordan(A: torch.Tensor, max_rows: int | None = None
                 ) -> torch.Tensor:
    """Reduced row-echelon form of (..., rows, cols >= rows) A.

    Pivots on the first `rows` columns (like the reference, which
    eliminates the leading square block and leaves the tail columns
    reduced). `max_rows` limits elimination to the top-left block as in
    the reference's partial elimination overload (gauss_jordan.h).
    Singular pivots are guarded with a tiny epsilon; callers that need
    rank detection should check the diagonal magnitude themselves.
    """
    rows = A.shape[-2]
    n = rows if max_rows is None else min(max_rows, rows)
    r = torch.arange(rows, device=A.device)
    M = A
    for j in range(n):
        col = M[..., :, j]
        # partial pivoting: the first largest |value| at/below row j
        masked = torch.where(r >= j, col.abs(), torch.full_like(col, -1.0))
        p = torch.argmax(masked, dim=-1)
        # swap rows j and p
        rj = M[..., j, :]
        rp = torch.gather(M, -2, p[..., None, None].expand(
            p.shape + (1, M.shape[-1])))[..., 0, :]
        is_j = (r == j)[:, None]
        is_p = (r == p[..., None])[..., None]
        M = torch.where(is_j, rp[..., None, :],
                        torch.where(is_p, rj[..., None, :], M))
        piv = M[..., j, j]
        piv = torch.where(piv.abs() < 1e-30, torch.full_like(piv, 1e-30),
                          piv)
        Mj = M[..., j, :] / piv[..., None]
        M = torch.where(is_j, Mj[..., None, :], M)
        # eliminate column j from every other row
        factors = torch.where(r == j, torch.zeros_like(M[..., :, j]),
                              M[..., :, j])
        M = M - factors[..., :, None] * Mj[..., None, :]
    return M
